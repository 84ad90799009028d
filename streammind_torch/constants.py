"""Token and model constants the port needs.

Same values as the JAX package's constants, so prompts and splice plans
are interchangeable between the two packages.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
VIDEO_TOKEN_INDEX = -201
AUDIO_TOKEN_INDEX = -202

MMODAL_TOKEN_INDEX = {"IMAGE": -200, "VIDEO": -201, "AUDIO": -202}
MMODAL_INDEX_TOKEN = {v: k for k, v in MMODAL_TOKEN_INDEX.items()}

# Class weights of the gate cross-entropy: (silence, respond)
GATE_CLASS_WEIGHTS = (0.15, 0.85)
