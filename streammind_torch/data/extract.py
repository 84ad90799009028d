"""Offline CLIP feature pre-extraction + shard loading.

A copy of the JAX package's ``data/extract.py``.

Rebuilds the reference's three-step pipeline (SURVEY.md §2.5):
  1. encode_video_ori.py / encode_all_videos_score
     (videollama2_arch.py:213-282): walk the MatchTime features_video tree,
     run the vision tower over every frame in 500-frame chunks, save
     "{half}_encode_feature_frame_{s}_{e}" shards under a mirrored
     features_video_encode tree — rank-sliced across processes.
  2. process_clip_encoder.py: re-stride shards to the training fps.
  3. video_timestamp_to_video (videollama2_trainer_score.py:474-543): load
     the shards covering a [start, end) timestamp window at train time
     (threaded reads).

Shards here are .npz (portable), one array "features" of
(frames, patches, hidden) float16.
"""
from __future__ import annotations

import concurrent.futures as futures
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CHUNK = 500
SHARD_RE = re.compile(r"(\d+)_encode_feature_frame_(\d+)_(\d+)\.npz$")


def shard_path(video_path: str, half: int, start: int, end: int,
               out_tag: str = "features_video_encode") -> str:
    out = os.path.dirname(video_path.replace("features_video", out_tag))
    return os.path.join(out, f"{half}_encode_feature_frame_{start}_{end}.npz")


def extract_video_features(
    video_path: str,
    encode_fn,                      # (T,3,H,W) float32 -> (T,P,D) features
    half: int,
    chunk: int = CHUNK,
    out_tag: str = "features_video_encode",
    size: int = 336,
    skip_existing: bool = True,
) -> List[str]:
    """Encode one half-video into per-chunk shards.  Returns shard paths."""
    from ..native import NativeVideoReader, available
    from ..mm_utils import clip_preprocess, frames_to_pil, read_video_frames, video_metadata

    written = []
    vr = None
    if available():
        vr = NativeVideoReader(video_path)
        duration = vr.num_frames
        # frame-count metadata can overestimate on mkv; accept short tails
        read = lambda ids: vr.read(ids, size=size, strict=False)  # noqa: E731
    else:
        duration, _ = video_metadata(video_path)
        read = lambda ids: clip_preprocess(  # noqa: E731
            frames_to_pil(read_video_frames(video_path, ids))
        )
    for start in range(0, duration, chunk):
        end = min(start + chunk, duration)
        out_path = shard_path(video_path, half, start, start + chunk, out_tag)
        if skip_existing and os.path.exists(out_path):
            written.append(out_path)
            continue
        pixels = read(list(range(start, end)))
        feats = np.asarray(encode_fn(pixels), np.float16)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        np.savez_compressed(out_path, features=feats)
        written.append(out_path)
    if vr is not None:
        vr.close()
    return written


def restride_shards(
    shard_dir: str, src_fps: float, dst_fps: float = 2.0,
    out_suffix: str = "_fps2", workers: int = 4,
) -> List[str]:
    """Thin every shard to dst_fps (process_clip_encoder.py:50-102)."""
    stride = max(int(round(src_fps / dst_fps)), 1)
    paths = [
        os.path.join(shard_dir, f)
        for f in os.listdir(shard_dir)
        if SHARD_RE.search(f)
    ]

    def one(path):
        m = SHARD_RE.search(path)
        half, start, end = m.groups()
        data = np.load(path)["features"]
        # global frame phase so strides align across shard boundaries
        s = int(start)
        offset = (-s) % stride
        out = data[offset::stride]
        out_path = path.replace(".npz", f"{out_suffix}.npz")
        np.savez_compressed(out_path, features=out, stride=stride, start=s)
        return out_path

    with futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, paths))


def load_feature_window(
    video_path: str,
    half: int,
    start_frame: int,
    end_frame: int,
    out_tag: str = "features_video_encode",
    chunk: int = CHUNK,
    stride: int = 1,
    workers: int = 4,
) -> Optional[np.ndarray]:
    """Load features for frames [start_frame, end_frame) from shards, with
    threaded shard reads (video_timestamp_to_video_ddp, trainer:513-543).
    Chunk size is auto-discovered from the shard filenames when the default
    doesn't match what's on disk."""
    probe = shard_path(video_path, half, 0, chunk, out_tag)
    if not os.path.exists(probe):
        shard_dir = os.path.dirname(probe)
        if os.path.isdir(shard_dir):
            for f in os.listdir(shard_dir):
                m = SHARD_RE.search(f)
                if m and int(m.group(1)) == half:
                    chunk = int(m.group(3)) - int(m.group(2))
                    break
    first = (start_frame // chunk) * chunk
    shards = []
    s = first
    while s < end_frame:
        shards.append((s, shard_path(video_path, half, s, s + chunk, out_tag)))
        s += chunk
    if not all(os.path.exists(p) for _, p in shards):
        return None

    def read(item):
        s, p = item
        return s, np.load(p)["features"]

    with futures.ThreadPoolExecutor(workers) as ex:
        loaded = dict(ex.map(read, shards))

    parts = []
    for s, _ in shards:
        data = loaded[s]
        lo = max(start_frame - s, 0)
        hi = min(end_frame - s, data.shape[0])
        if lo < hi:
            parts.append(data[lo:hi])
    if not parts:
        return None
    out = np.concatenate(parts, axis=0)
    return out[::stride] if stride > 1 else out


def make_shard_frame_loader(out_tag: str = "features_video_encode",
                            video_fps: float = 25.0, cur_fps: float = 2.0):
    """frame_loader for MatchTimeDataset that reads pre-extracted features
    instead of decoding pixels.  Returned arrays are (T, P, D) features —
    the trainer detects 3-D inputs and skips the vision tower."""
    from .matchtime import extract_video_half

    stride = max(int(round(video_fps / cur_fps)), 1)

    def loader(video_path: str, start_ts: float, end_ts: float):
        half = extract_video_half(video_path)
        start_frame = int(max(0.0, start_ts) * video_fps + 1)
        end_frame = int(end_ts * video_fps + 1)
        if end_frame <= start_frame:
            return None
        return load_feature_window(
            video_path, half, start_frame, end_frame, out_tag, stride=stride
        )

    return loader
