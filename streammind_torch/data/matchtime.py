"""MatchTime soccer-commentary streaming dataset.

A copy of the JAX package's ``data/matchtime.py``.  Rebuilds the
reference's LazySupervisedDataset score path (train_new_stream_1221.py):
  - walk a features_video tree for {1,2}_224p.mkv halves (:811-827)
  - pair with dataset/MatchTime/train/.../Labels-caption.json (:544-554)
  - parse "gameTime": "1 - MM:SS" annotations into ascending timestamps
  - insert random silence ("</s>") samples between caption timestamps:
    for gaps >= 2 s, randint(1, max(1, gap//30)) silence points sampled
    uniformly inside the open interval (:920-948)
  - per sample: decode frames at cur_fps between the previous and current
    timestamp (:1020-1057), random-retry on bad samples (:1077-1105)
"""
from __future__ import annotations

import json
import os
import random
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .preprocess import build_score_sample

HALF_FILES = ("1_224p.mkv", "2_224p.mkv")


def trans_video_to_json(video_path: str) -> str:
    p = video_path.replace("features_video", "dataset/MatchTime/train")
    for half_file in HALF_FILES:
        if half_file in p:
            return p.replace(half_file, "Labels-caption.json")
    return p


def extract_video_half(video_path: str) -> int:
    m = re.match(r"(\d+)_", os.path.basename(video_path))
    return int(m.group(1)) if m else 1


def find_half_videos(root: str) -> List[str]:
    out = []
    for dirpath, _, filenames in os.walk(root):
        for name in HALF_FILES:
            if name in filenames:
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def parse_labels_caption(json_path: str, half: int) -> Tuple[List[int], List[str]]:
    """(ascending timestamps in seconds, captions) for one half."""
    with open(json_path) as f:
        data = json.load(f)
    ts, caps = [], []
    for ann in data.get("annotations", []):
        game_time = ann.get("gameTime", "")
        if " - " not in game_time:
            continue
        half_str, clock = game_time.split(" - ")
        if int(half_str.split(" ")[0]) != half:
            continue
        minutes, seconds = map(int, clock.split(":"))
        ts.append(minutes * 60 + seconds)
        caps.append(ann.get("anonymized", ""))
    # annotation order is not guaranteed across MatchTime/SoccerNet exports
    # (typically newest-first); sort to ascending timestamps explicitly
    order = sorted(range(len(ts)), key=lambda i: ts[i])
    return [ts[i] for i in order], [caps[i] for i in order]


def insert_silence_samples(
    timestamps: Sequence[int],
    captions: Sequence[str],
    rng: Optional[random.Random] = None,
) -> Tuple[List[int], List[int], List[str]]:
    """Expand a caption track with random silence ("</s>") samples.

    Returns (timestamps, start_timestamps, captions); start_timestamps[i] is
    the beginning of the frame window fed to the model for sample i.
    """
    rng = rng or random
    out_ts: List[int] = []
    out_start: List[int] = []
    out_cap: List[str] = []
    for i, ts in enumerate(timestamps):
        if i == 0:
            # reference parity (train_new_stream_1221.py:913-918): the first
            # caption's window start equals its own timestamp, so the sample
            # is skipped by the zero-length-window check at load time
            out_ts.append(ts)
            out_start.append(ts)
            out_cap.append(captions[i])
            continue
        prev = timestamps[i - 1]
        if ts - prev < 2:
            out_ts.append(ts)
            out_start.append(prev)
            out_cap.append(captions[i])
        else:
            n_sil = rng.randint(1, max(1, (ts - prev) // 30))
            sil_ts = sorted(rng.sample(range(prev + 1, ts), n_sil))
            out_ts.extend(sil_ts)
            out_start.extend([prev] * n_sil)
            out_cap.extend(["</s>"] * n_sil)
            out_ts.append(ts)
            out_start.append(prev)
            out_cap.append(captions[i])
    return out_ts, out_start, out_cap


@dataclass
class MatchTimeIndex:
    """Flat caption index over all half-videos (reference caption_num_pervideo
    bookkeeping, :884-905)."""

    video_paths: List[str]
    timestamps: List[List[int]]
    start_timestamps: List[List[int]]
    captions: List[List[str]]
    cumulative: List[int]  # cumulative caption counts per video

    def __len__(self) -> int:
        return self.cumulative[-1] if self.cumulative else 0

    def locate(self, i: int) -> Tuple[int, int]:
        """flat index → (video_id, caption_id)."""
        for vid, cum in enumerate(self.cumulative):
            if cum > i:
                prev = self.cumulative[vid - 1] if vid > 0 else 0
                return vid, i - prev
        raise IndexError(i)


def build_index(
    features_root: str, seed: Optional[int] = None
) -> MatchTimeIndex:
    rng = random.Random(seed) if seed is not None else random
    paths = find_half_videos(features_root)
    ts_all, start_all, cap_all, cum = [], [], [], []
    total = 0
    for p in paths:
        half = extract_video_half(p)
        ts, caps = parse_labels_caption(trans_video_to_json(p), half)
        ts2, start2, caps2 = insert_silence_samples(ts, caps, rng)
        ts_all.append(ts2)
        start_all.append(start2)
        cap_all.append(caps2)
        total += len(ts2)
        cum.append(total)
    return MatchTimeIndex(paths, ts_all, start_all, cap_all, cum)


class MatchTimeDataset:
    """Streaming SFT dataset: one (frame-window, caption) pair per item.

    Frames are decoded at cur_fps between start_timestamp and timestamp and
    CLIP-preprocessed; bad/short samples retry at a random index, matching
    the reference's resilience behavior.
    """

    def __init__(
        self,
        features_root: str,
        tokenizer,
        cur_fps: float = 2.0,
        min_start_frames: int = 200,  # reference: skip if 25*ts < 200 (:1075)
        seed: Optional[int] = 0,
        frame_loader=None,  # injectable for tests / feature shards
    ):
        self.index = build_index(features_root, seed)
        self.tokenizer = tokenizer
        self.cur_fps = cur_fps
        self.min_start_frames = min_start_frames
        self._rng = random.Random(seed)
        self._frame_loader = frame_loader or self._decode_window

    def __len__(self) -> int:
        return len(self.index)

    def _decode_window(self, video_path: str, start_ts: float, end_ts: float):
        from ..mm_utils import clip_preprocess, frames_to_pil, read_video_frames, video_metadata

        duration, fps = video_metadata(video_path)
        start_frame = int(max(0, start_ts) * fps + 1)
        if end_ts * fps + 1 > duration or start_ts == end_ts:
            return None
        end_frame = int(end_ts * fps + 1)
        seg = int(fps / self.cur_fps)
        ids = np.arange(start_frame, end_frame, max(seg, 1), dtype=int)
        if len(ids) == 0:
            return None
        frames = read_video_frames(video_path, ids)
        return clip_preprocess(frames_to_pil(frames))

    def __getitem__(self, i: int, _retries: int = 50) -> Dict:
        if _retries <= 0:
            raise RuntimeError("too many bad samples")
        vid, cap_id = self.index.locate(i)
        video_path = self.index.video_paths[vid]
        half = extract_video_half(video_path)
        # NOTE: the reference indexes with cap_id - 1 (:1073-1078), skewing
        # every video's samples by one; we index directly.
        timestamp = self.index.timestamps[vid][cap_id]
        if 25 * timestamp < self.min_start_frames:
            return self.__getitem__(
                self._rng.randint(0, len(self) - 1), _retries - 1
            )
        start_ts = self.index.start_timestamps[vid][cap_id]
        caption = self.index.captions[vid][cap_id]
        past = "".join("".join(self.index.captions[vid][:cap_id]).split("</s>"))

        video = self._frame_loader(video_path, start_ts, timestamp)
        if video is None:
            return self.__getitem__(
                self._rng.randint(0, len(self) - 1), _retries - 1
            )
        sample = build_score_sample(
            caption, video_path, half, timestamp, self.tokenizer,
            past_review_caption=past,
        )
        sample["video"] = video
        return sample


def collate_score_batch(instances: Sequence[Dict]) -> Dict:
    """Batch-of-1 passthrough collator with the reference's control fields
    (DataCollatorForScoreDataset, train_new_stream_1221.py:1112-1130)."""
    if len(instances) != 1:
        raise ValueError(f"score samples require batch_size 1 (got {len(instances)})")
    inst = instances[0]
    return {
        "timestamp": inst["timestamp"],
        "labels": inst["labels"],
        "input_ids": inst["input_ids"],
        "half": inst["half"],
        "caption_info": inst["caption_info"],
        "video_path": inst["video_path"],
        "images": [inst["video"], ["video"]],
        "attention_mask": None,
        "past_review_caption": inst["past_review_caption"],
    }
