"""Token, frame, pixel and serving constants the port needs.

Same values as the JAX package's constants, so prompts, splice plans,
preprocessed frames and the serving protocol are interchangeable between
the two packages.
"""

# ---------------------------------------------------------------------------
# Serving plane
# ---------------------------------------------------------------------------
CONTROLLER_HEART_BEAT_EXPIRATION = 30  # seconds until a silent worker is dropped
WORKER_HEART_BEAT_INTERVAL = 15  # seconds between worker heartbeats
LOGDIR = "./log_dir"

# ---------------------------------------------------------------------------
# Video sampling
# ---------------------------------------------------------------------------
NUM_FRAMES = 8  # default uniform sample count for offline QA
MAX_FRAMES = 320000  # absolute clamp on decoded frames
NUM_FRAMES_PER_SECOND = 1  # default fps-mode sampling rate
MAX_VISION_BATCH_FRAMES = 600  # hard cap on frames fed to the vision tower

# AnyRes grid options (rows, cols) for high-resolution image tiling.
GRIDS = [(2, 2), (1, 2), (1, 3), (1, 4), (2, 1), (3, 1), (4, 1)]

# ---------------------------------------------------------------------------
# Token indices
# ---------------------------------------------------------------------------
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
VIDEO_TOKEN_INDEX = -201
AUDIO_TOKEN_INDEX = -202

MMODAL_TOKEN_INDEX = {"IMAGE": -200, "VIDEO": -201, "AUDIO": -202}
MMODAL_INDEX_TOKEN = {v: k for k, v in MMODAL_TOKEN_INDEX.items()}
DEFAULT_MMODAL_TOKEN = {"IMAGE": "<image>", "VIDEO": "<video>", "AUDIO": "<audio>"}

# Class weights of the gate cross-entropy: (silence, respond)
GATE_CLASS_WEIGHTS = (0.15, 0.85)

# CLIP pixel statistics (OpenAI CLIP ViT-L/14-336 processor).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_IMAGE_SIZE = 336
