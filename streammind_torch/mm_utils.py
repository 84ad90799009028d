"""Multimodal host utilities: frame sampling (uniform, by fps, by scene),
CLIP preprocessing, video decode, the modal-token tokenizer splice and the
stop trim.

Everything here runs on the host and returns numpy arrays; the engine puts
them on the device.  Results are the JAX package's, bit for bit: the same
PIL resampling, the same fp32 arithmetic in the same order.  PIL and
imageio are imported inside the functions that use them, so the API and
the serving modules import on a machine that has neither (pixels then
arrive as arrays).  ``process_video`` reads a video file through the native
C++ ingest (``native.py``: decode, letterbox and normalize in one pass)
where its library builds, as the JAX package does; otherwise, and for GIFs,
through decord when it is installed, else imageio.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .constants import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_SIZE,
    CLIP_IMAGE_STD,
    IMAGE_TOKEN_INDEX,
    MAX_FRAMES,
    MMODAL_INDEX_TOKEN,
    NUM_FRAMES,
    NUM_FRAMES_PER_SECOND,
)


def _image_module():
    from PIL import Image

    return Image


# ---------------------------------------------------------------------------
# Frame index sampling
# ---------------------------------------------------------------------------
def frame_sample_uniform(duration: int, num_frames: int) -> List[int]:
    """Segment-middle uniform sampling: split [0, duration) into num_frames
    segments and take each segment's midpoint."""
    seg_size = float(duration - 1) / num_frames
    ids = []
    for i in range(num_frames):
        start = int(round(seg_size * i))
        end = int(round(seg_size * (i + 1)))
        ids.append((start + end) // 2)
    return ids


def frame_sample_fps(duration: int, local_fps: float,
                     target_fps: float = NUM_FRAMES_PER_SECOND) -> List[int]:
    """One frame per 1/target_fps seconds, centered in each interval."""
    segment_len = min(int(local_fps) // int(target_fps), duration)
    segment_len = max(segment_len, 1)
    return list(np.arange(segment_len // 2, duration, segment_len, dtype=int))


def frame_sample(duration: int, mode: str = "uniform", num_frames: int = NUM_FRAMES,
                 local_fps: Optional[float] = None) -> List[int]:
    if mode == "uniform":
        return frame_sample_uniform(duration, num_frames)
    if mode == "fps":
        if local_fps is None:
            raise ValueError("fps sampling needs the source frame rate")
        return frame_sample_fps(duration, local_fps)
    raise ValueError(f"Unsupported frame sampling mode: {mode}")


# ---------------------------------------------------------------------------
# Image preprocessing (the CLIP ViT-L/14-336 pipeline)
# ---------------------------------------------------------------------------
def expand2square(img, background_color):
    """Pad a PIL image to square, centering it on the fill color."""
    width, height = img.size
    if width == height:
        return img
    side = max(width, height)
    result = _image_module().new(img.mode, (side, side), background_color)
    if width > height:
        result.paste(img, (0, (side - height) // 2))
    else:
        result.paste(img, ((side - width) // 2, 0))
    return result


def clip_background_color():
    return tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)


def _resize_bicubic(img, size: int):
    return img.resize((size, size), _image_module().BICUBIC)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top: top + size, left: left + size]


def clip_preprocess(images: Sequence, image_size: int = CLIP_IMAGE_SIZE, pad_square: bool = True,
                    dtype=np.float32) -> np.ndarray:
    """PIL images → (N, 3, H, W) normalized pixel values.

    With ``pad_square`` the image is letterboxed with the CLIP mean color,
    then bicubic-resized to the target square; otherwise a shortest-edge
    resize and a center crop (the stock CLIPImageProcessor path)."""
    Image = _image_module()
    mean = np.asarray(CLIP_IMAGE_MEAN, dtype=np.float32).reshape(3, 1, 1)
    std = np.asarray(CLIP_IMAGE_STD, dtype=np.float32).reshape(3, 1, 1)
    out = np.empty((len(images), 3, image_size, image_size), dtype=dtype)
    bg = clip_background_color()
    for i, img in enumerate(images):
        if img.mode != "RGB":
            img = img.convert("RGB")
        if pad_square:
            img = expand2square(img, bg)
            img = _resize_bicubic(img, image_size)
            arr = np.asarray(img, dtype=np.float32)
        else:
            w, h = img.size
            scale = image_size / min(w, h)
            img = img.resize(
                (max(image_size, int(round(w * scale))), max(image_size, int(round(h * scale)))),
                Image.BICUBIC,
            )
            arr = _center_crop(np.asarray(img, dtype=np.float32), image_size)
        arr = arr.transpose(2, 0, 1) / 255.0
        out[i] = (arr - mean) / std
    return out


def frames_to_pil(video_data: np.ndarray) -> list:
    Image = _image_module()
    return [Image.fromarray(f) for f in video_data]


def create_photo_grid(frames: Sequence, n: int = 2):
    """Tile n*n frames into one grid image (the worker's temporal-aug grid)."""
    if len(frames) != n * n:
        raise ValueError(f"need {n*n} frames, got {len(frames)}")
    w, h = frames[0].size
    grid = _image_module().new("RGB", (n * w, n * h))
    for i in range(n):
        for j in range(n):
            grid.paste(frames[i * n + j], (j * w, i * h))
    return grid


# ---------------------------------------------------------------------------
# AnyRes: a high-resolution image as a best-fit grid of crops
# ---------------------------------------------------------------------------
def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """The candidate (w, h) that keeps the most effective pixels after an
    aspect-preserving downscale, ties broken by the least wasted area."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def resize_and_pad_image(img, target_resolution: Tuple[int, int]):
    """Aspect-preserving resize onto a black canvas of target_resolution,
    centered."""
    Image = _image_module()
    ow, oh = img.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = img.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(img, patch_size: int) -> list:
    """Row-major patch_size × patch_size crops."""
    w, h = img.size
    return [img.crop((j, i, j + patch_size, i + patch_size))
            for i in range(0, h, patch_size) for j in range(0, w, patch_size)]


def _grid_list(grids):
    if isinstance(grids, str):
        import ast

        grids = ast.literal_eval(grids)
    return grids


def get_anyres_image_grid_shape(image_size: Tuple[int, int], grids,
                                patch_size: int) -> Tuple[int, int]:
    """(cols, rows) of the patch grid the image maps onto."""
    resolutions = [(x * patch_size, y * patch_size) for x, y in _grid_list(grids)]
    w, h = select_best_resolution(image_size, resolutions)
    return w // patch_size, h // patch_size


def process_anyres_image(img, grids, patch_size: int) -> list:
    """A high-res image → [global thumbnail] + best-fit grid crops, each
    patch_size², fed to the vision tower as a frame batch."""
    resolutions = [(x * patch_size, y * patch_size) for x, y in _grid_list(grids)]
    best = select_best_resolution(img.size, resolutions)
    patches = divide_to_patches(resize_and_pad_image(img, best), patch_size)
    thumb = resize_and_pad_image(img, (patch_size, patch_size))
    return [thumb] + patches


# ---------------------------------------------------------------------------
# Video decode
# ---------------------------------------------------------------------------
def read_video_frames(video_path: str, frame_ids: Sequence[int]) -> np.ndarray:
    """Decode the given frame indices of a video file → (T, H, W, 3) uint8,
    in request order (duplicates kept).  GIFs through imageio; other
    containers through decord if installed, else imageio."""
    if video_path.endswith(".gif"):
        import imageio

        reader = imageio.get_reader(video_path)
        wanted = set(int(i) for i in frame_ids)
        by_id = {i: np.asarray(f)[..., :3] for i, f in enumerate(reader) if i in wanted}
        return np.stack([by_id[int(i)] for i in frame_ids])
    try:
        from decord import VideoReader, cpu  # type: ignore

        vr = VideoReader(uri=video_path, ctx=cpu(0), num_threads=1)
        return vr.get_batch(list(frame_ids)).asnumpy()
    except ImportError:
        pass
    import imageio.v2 as imageio

    reader = imageio.get_reader(video_path)
    wanted = set(int(i) for i in frame_ids)
    frames = {i: np.asarray(f) for i, f in enumerate(reader) if i in wanted}
    return np.stack([frames[int(i)] for i in frame_ids])


def video_metadata(video_path: str):
    """(duration in frames, fps) of a video file."""
    if video_path.endswith(".gif"):
        import imageio

        reader = imageio.get_reader(video_path)
        return sum(1 for _ in reader), 10.0
    try:
        from decord import VideoReader, cpu  # type: ignore

        vr = VideoReader(uri=video_path, ctx=cpu(0), num_threads=1)
        return len(vr), float(vr.get_avg_fps())
    except ImportError:
        import imageio.v2 as imageio

        reader = imageio.get_reader(video_path)
        meta = reader.get_meta_data()
        n = reader.count_frames()
        return int(n), float(meta.get("fps", 30.0))


def process_video(video_path: Union[str, np.ndarray], num_frames: int = NUM_FRAMES,
                  sample_scheme: str = "uniform", aspect_ratio: str = "pad",
                  image_size: int = CLIP_IMAGE_SIZE) -> np.ndarray:
    """Video file or (T, H, W, 3) frames → (T, 3, image_size, image_size)
    fp32 pixel values (a file is sampled to num_frames first).  File inputs
    take the native ingest first; arrays, GIFs and containers it cannot
    read take the Python path below."""
    if isinstance(video_path, str) and not video_path.endswith(".gif"):
        from . import native

        try:
            if native.available():
                return native.native_process_video(
                    video_path, num_frames=num_frames, sample_scheme=sample_scheme,
                    size=image_size, pad_square=(aspect_ratio == "pad"))
        except (IOError, RuntimeError):  # a container the native reader refuses
            pass
    if isinstance(video_path, str):
        duration, local_fps = video_metadata(video_path)
        ids = frame_sample(duration, sample_scheme, num_frames, local_fps)
        if len(ids) > MAX_FRAMES:
            ids = list(np.linspace(0, duration - 1, MAX_FRAMES, dtype=int))
        video_data = read_video_frames(video_path, ids)
    else:
        video_data = np.asarray(video_path)
        if video_data.ndim == 3:
            video_data = video_data[None]
    return clip_preprocess(frames_to_pil(video_data), image_size=image_size,
                           pad_square=(aspect_ratio == "pad"))


def process_image(image, aspect_ratio: str = "pad") -> np.ndarray:
    """Image (path, PIL image or array) → (N, 3, 336, 336) fp32 pixel values.
    aspect_ratio "anyres" gives the thumbnail and the best-fit grid crops as
    a batch; otherwise one frame, square-padded when "pad"."""
    Image = _image_module()
    if isinstance(image, str):
        image = Image.open(image)
    elif isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    if aspect_ratio == "anyres":
        from .constants import GRIDS

        crops = process_anyres_image(image.convert("RGB"), GRIDS, 336)
        return clip_preprocess(crops, pad_square=False)
    return clip_preprocess([image], pad_square=(aspect_ratio == "pad"))


def frame_expansion(frames: Sequence, n: int):
    """n × n frame paste-up (create_photo_grid with an explicit side)."""
    return create_photo_grid(frames, n)


def chunk_list(input_list, chunk_size: int):
    """Consecutive chunk_size pieces of a list."""
    return [input_list[i:i + chunk_size] for i in range(0, len(input_list), chunk_size)]


def process_video_taug(video: Union[str, np.ndarray], num_frames: int = NUM_FRAMES,
                       grid: int = 2, aspect_ratio: str = "pad",
                       image_size: int = CLIP_IMAGE_SIZE) -> np.ndarray:
    """Temporal-augmentation photo grids: sample num_frames * grid² frames
    linearly across the video, paste each consecutive grid² chunk into one
    grid × grid image, and preprocess the num_frames grid images.  Raw
    (T, H, W, 3) frames are resampled linearly when their count differs."""
    n_sample = num_frames * grid * grid
    if isinstance(video, str):
        duration, _ = video_metadata(video)
        ids = list(np.linspace(0, duration - 1, n_sample, dtype=int))
        video_data = read_video_frames(video, ids)
    else:
        video_data = np.asarray(video)
        if video_data.ndim == 3:
            video_data = video_data[None]
    frames = frames_to_pil(video_data)
    if len(frames) != n_sample:
        idx = np.linspace(0, len(frames) - 1, n_sample).astype(int)
        frames = [frames[i] for i in idx]
    grids = [frame_expansion(chunk, grid) for chunk in chunk_list(frames, grid * grid)]
    return clip_preprocess(grids, image_size=image_size, pad_square=(aspect_ratio == "pad"))


def load_image_from_base64(data: str):
    """base64 string → PIL image (the serving plane's image transport)."""
    import base64
    from io import BytesIO

    return _image_module().open(BytesIO(base64.b64decode(data)))


# ---------------------------------------------------------------------------
# Scene-based frame sampling
# ---------------------------------------------------------------------------
def merge_scenes(cut_list, cut_scores: Sequence[float], scene_list, num_frames: int,
                 max_scene_num: int = 4, num_frame_per_scene: int = 8) -> List[np.ndarray]:
    """Merge the weakest cuts until at most ``max_scene_num`` scenes remain,
    then ``num_frame_per_scene`` evenly spaced frame ids a scene.  Cuts are
    frame ids or objects with ``.get_frames()`` (PySceneDetect's); with no
    scene and no cut, one linspace over the whole video."""
    if len(scene_list) == 0 and len(cut_list) == 0:
        return [np.linspace(0, num_frames - 1, num_frame_per_scene, dtype=int)]
    scene_list, cut_results = merge_scenes_not_exceed_max_scene_num(
        cut_list, cut_scores, scene_list, max_scene_num)
    out: List[np.ndarray] = []
    prev = cur = 0
    for cur, _score in cut_results:
        out.append(np.linspace(prev, cur - 1, num_frame_per_scene, dtype=int))
        prev = cur
    if cur < num_frames:
        out.append(np.linspace(cur, num_frames - 1, num_frame_per_scene, dtype=int))
    return out


def merge_scenes_not_exceed_max_scene_num(cut_list, cut_scores: Sequence[float], scene_list,
                                          max_scene_num: int):
    """Drop the lowest-score cut and fuse its two neighbouring scenes until
    at most ``max_scene_num`` scenes remain: (scenes, [(cut frame, score)])."""
    frames = [c.get_frames() if hasattr(c, "get_frames") else c for c in cut_list]
    scores = list(cut_scores)
    scenes = list(scene_list)
    while len(scenes) > max_scene_num:
        i = int(np.argmin(scores))
        frames.pop(i)
        scores.pop(i)
        scenes = scenes[:i] + [(scenes[i][0], scenes[i + 1][1])] + scenes[i + 2:]
    return scenes, list(zip(frames, scores))


# ---------------------------------------------------------------------------
# Tokenizer splice, stop trim, model names
# ---------------------------------------------------------------------------
def tokenizer_multimodal_token(
    prompt: str,
    tokenizer,
    multimodal_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Tokenize a prompt containing a modal placeholder (<image>/<video>/<audio>),
    splicing the negative modal token index where the placeholder sat.

    Each text chunk is tokenized on its own; a leading BOS on the first
    chunk is kept once, and the BOS of every later chunk is dropped along
    with the separator slot it would occupy.
    """
    placeholder = f"<{MMODAL_INDEX_TOKEN[multimodal_token_index].lower()}>"
    chunks = [tokenizer(c).input_ids for c in prompt.split(placeholder)]

    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [multimodal_token_index] * (offset + 1)
    pieces = []
    for i, chunk in enumerate(chunks):
        pieces.append(chunk)
        if i != len(chunks) - 1:
            pieces.append(sep)
    for piece in pieces:
        input_ids.extend(piece[offset:])
    return input_ids


def trim_at_stop_strings(text: str, stop_strings: Sequence[str]) -> str:
    """Cut generated text at the first stop keyword."""
    for s in stop_strings:
        if s and s in text:
            text = text.split(s)[0]
    return text.strip()


def get_model_name_from_path(model_path: str) -> str:
    parts = model_path.strip("/").split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
