"""MatchTime streaming-gate evaluation CLI (the JAX package's
``eval/run_gate_stream.py``).

Reference: eval/inference_video_score_stream_ddp.py — stream every half-video
at 2 fps through the perception program, record gate fire times, score
precision/recall/F1 at ±1/5/10 s against the caption timestamps.  Frames
go to the session engine's device in its working dtype.

Usage:
  python -m streammind_torch.eval.run_gate_stream \
      --model-path ckpt/ --data-path MatchTime/features_video \
      [--num-chunks N --chunk-idx K] [--output out.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np

from ..data.matchtime import (
    extract_video_half,
    find_half_videos,
    parse_labels_caption,
    trans_video_to_json,
)
from .mcqa import get_chunk
from .metrics import aggregate, gate_prf


def stream_video_fire_times(
    session, video_path: str, cur_fps: float = 2.0, frame_loader=None
) -> List[float]:
    """Feed frames at cur_fps; return fire times in seconds.  frame_loader,
    if given, is (video_path, cur_fps) → iterable of (seconds, pixels)."""
    from ..api import engine_pixels
    from ..mm_utils import clip_preprocess, frames_to_pil, read_video_frames, video_metadata
    from ..native import NativeVideoReader, available as native_available

    if frame_loader is None and native_available():
        vr = NativeVideoReader(video_path)
        seg = max(int(vr.fps / cur_fps), 1)
        ids = np.arange(0, max(vr.num_frames - 1, 1), seg, dtype=int)

        def frames_iter():
            # one open container, sequential forward decode — not one
            # open+seek per frame
            with vr:
                for fid in ids:
                    yield fid / vr.fps, vr.read([int(fid)], strict=False)
    elif frame_loader is None:
        duration, fps = video_metadata(video_path)
        seg = max(int(fps / cur_fps), 1)
        ids = np.arange(0, duration - 1, seg, dtype=int)

        def frames_iter():
            # chunked reads: read_video_frames opens the container each
            # call, so 64 sampled ids an open
            chunk = 64
            for c in range(0, len(ids), chunk):
                batch_ids = [int(i) for i in ids[c : c + chunk]]
                raw = read_video_frames(video_path, batch_ids)
                for j, fid in enumerate(batch_ids):
                    yield fid / fps, clip_preprocess(frames_to_pil(raw[j : j + 1]))
    else:
        frames_iter = lambda: frame_loader(video_path, cur_fps)  # noqa: E731

    fire_times = []
    for t_sec, pixels in frames_iter():
        out = session.process_frame(engine_pixels(session.engine, pixels))
        if out is not None:
            fire_times.append(t_sec)
    return fire_times


def evaluate_gate_stream(
    model, tokenizer, video_paths, cur_fps: float = 2.0,
    tolerances=(5, 10, 1), frame_loader=None, session_kw=None,
):
    results = {tol: {"precision": [], "recall": [], "f1": []} for tol in tolerances}
    per_video = []
    for path in video_paths:
        half = extract_video_half(path)
        ts, _ = parse_labels_caption(trans_video_to_json(path), half)
        session = model.new_session(tokenizer, **(session_kw or {}))
        fires = stream_video_fire_times(session, path, cur_fps, frame_loader)
        row = {"video": path, "fires": fires, "targets": ts}
        for tol in tolerances:
            p, r, f1 = gate_prf(ts, fires, tol)
            results[tol]["precision"].append(p)
            results[tol]["recall"].append(r)
            results[tol]["f1"].append(f1)
            row[f"f1@{tol}"] = f1
        per_video.append(row)
    summary = {
        f"{m}@{tol}": aggregate(results[tol][m])
        for tol in tolerances
        for m in ("precision", "recall", "f1")
    }
    return summary, per_video


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--cur-fps", type=float, default=2.0)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..api import model_init

    model, _, tokenizer, _ = model_init(args.model_path, device=args.device)
    videos = get_chunk(find_half_videos(args.data_path), args.num_chunks, args.chunk_idx)
    summary, per_video = evaluate_gate_stream(model, tokenizer, videos, args.cur_fps)
    print(json.dumps(summary, indent=2))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump({"summary": summary, "per_video": per_video}, f)


if __name__ == "__main__":
    main()
