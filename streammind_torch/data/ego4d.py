"""Ego4D narration streaming dataset.

A copy of the JAX package's ``data/ego4d.py``.  The reference's eval
(eval/inference_video_ego4d_stream_parallel_new.py) imports a
`data.ego4d_data` module (find_mp4_files, get_annos,
preprocess_llama_2_ego4d, ego_video_name_2_video_path) that its repo lacks
(SURVEY.md §0.1); this is a reconstruction from the observable contract:
  - sample records carry input_ids/labels/video/timestamp/model_type/
    data_type (collator :50-70)
  - narration timestamps land on a 0.5 s grid (ceil_time_by_fps with fps=2,
    :123-124; eval/output.txt:1)
  - turns are "You <verb> …" narrations, one per gate fire; labels supervise
    caption tokens + the closing </s> of every turn.

Annotation input format: the official Ego4D narration JSON
({video_uid: {"narration_pass_1": {"narrations": [{"narration_text": ...,
"timestamp_sec": ...}]}}}), or the simplified {video_uid: [[t, text], ...]}.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from ..conversation import conv_mistral_instruct
from ..mm_utils import tokenizer_multimodal_token


def ceil_time_by_fps(time: float, fps: int = 2, min_time: float = 0.5) -> float:
    return max(math.ceil(time * fps) / fps, min_time)


def find_mp4_files(root: str) -> List[str]:
    out = []
    for dirpath, _, filenames in os.walk(root):
        out.extend(
            os.path.join(dirpath, f) for f in filenames if f.endswith(".mp4")
        )
    return sorted(out)


def ego_video_name_2_video_path(video_name: str, root: str) -> str:
    name = video_name if video_name.endswith(".mp4") else video_name + ".mp4"
    return os.path.join(root, name)


def get_annos(anno_path: str, fps: int = 2) -> Dict[str, List[Tuple[float, str]]]:
    """→ {video_uid: [(grid_timestamp, narration_text), ...]} ascending,
    deduplicated per grid slot (first narration wins)."""
    with open(anno_path) as f:
        raw = json.load(f)
    out: Dict[str, List[Tuple[float, str]]] = {}
    for uid, entry in raw.items():
        pairs: List[Tuple[float, str]] = []
        if isinstance(entry, dict):
            for pass_name in ("narration_pass_1", "narration_pass_2"):
                if pass_name in entry:
                    for n in entry[pass_name].get("narrations", []):
                        txt = n.get("narration_text", "").replace("#C C", "You").strip()
                        pairs.append((float(n["timestamp_sec"]), txt))
                    break
        else:
            pairs = [(float(t), str(txt)) for t, txt in entry]
        pairs.sort(key=lambda x: x[0])
        seen = set()
        grid: List[Tuple[float, str]] = []
        for t, txt in pairs:
            g = ceil_time_by_fps(t, fps)
            if g not in seen and txt:
                seen.add(g)
                grid.append((g, txt))
        out[uid] = grid
    return out


def preprocess_llama_2_ego4d(
    narrations: Sequence[Tuple[float, str]],
    tokenizer,
    fps: int = 2,
    system_instruction: str = "<video>\n",
    max_turns: Optional[int] = None,
) -> Dict:
    """Multi-turn streaming sample: one <video> slot + one turn per narration.

    input_ids: [bos, inst…, -201, '[/INST]'…, cap1…, eos, -201-continuation …]
    For the stage-1 splice each turn t contributes one <video> slot whose
    span is the frames between fire t-1 and fire t.  Labels supervise caption
    tokens + the per-turn </s> only.
    """
    conv = conv_mistral_instruct
    if max_turns is not None:
        narrations = list(narrations)[:max_turns]
    ids: List[int] = []
    labels: List[int] = []
    span_frames: List[int] = []
    prev_t = 0.0
    sys_block = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n"
    for turn_i, (t, caption) in enumerate(narrations):
        if turn_i == 0:
            user_text = f"[INST] {sys_block}{system_instruction} [/INST]"
        else:
            user_text = "[INST] <video>\n [/INST]"
        turn_ids = tokenizer_multimodal_token(user_text, tokenizer, VIDEO_TOKEN_INDEX)
        if turn_i > 0 and turn_ids and turn_ids[0] == getattr(tokenizer, "bos_token_id", None):
            turn_ids = turn_ids[1:]
        ids.extend(turn_ids)
        labels.extend([IGNORE_INDEX] * len(turn_ids))

        cap_ids = tokenizer(" " + caption.strip()).input_ids
        if cap_ids and cap_ids[0] == getattr(tokenizer, "bos_token_id", None):
            cap_ids = cap_ids[1:]
        cap_ids = cap_ids + [tokenizer.eos_token_id]
        ids.extend(cap_ids)
        labels.extend(cap_ids)

        n_frames = max(int(round((t - prev_t) * fps)), 1)
        span_frames.append(n_frames)
        prev_t = t

    return {
        "input_ids": np.asarray(ids, np.int64)[None],
        "labels": np.asarray(labels, np.int64)[None],
        "span_frames": span_frames,
        "timestamp": [t for t, _ in narrations],
        "captions": [c for _, c in narrations],
    }


class Ego4dNarrationDataset:
    """One item per video: the full narration dialogue + frame metadata.

    model_type 'llm' supervises captions (stage-1 style); 'cls' yields
    per-frame gate labels (1 at narration grid slots, 0 elsewhere).
    """

    def __init__(
        self,
        video_root: str,
        anno_path: str,
        tokenizer,
        fps: int = 2,
        model_type: str = "llm",
        data_type: str = "eval",
        max_turns: Optional[int] = None,
        frame_loader=None,
    ):
        self.annos = get_annos(anno_path, fps)
        self.uids = [u for u, n in self.annos.items() if n]
        self.video_root = video_root
        self.tokenizer = tokenizer
        self.fps = fps
        self.model_type = model_type
        self.data_type = data_type
        self.max_turns = max_turns
        self._frame_loader = frame_loader

    def __len__(self) -> int:
        return len(self.uids)

    def gate_labels(self, narrations) -> np.ndarray:
        """(n_frames,) 0/1 per 1/fps frame slot up to the last narration."""
        end = narrations[-1][0]
        n = int(round(end * self.fps))
        labels = np.zeros((n,), np.int64)
        for t, _ in narrations:
            idx = int(round(t * self.fps)) - 1
            if 0 <= idx < n:
                labels[idx] = 1
        return labels

    def __getitem__(self, i: int) -> Dict:
        uid = self.uids[i]
        narrations = self.annos[uid]
        if self.max_turns is not None:
            narrations = narrations[: self.max_turns]
        video_path = ego_video_name_2_video_path(uid, self.video_root)
        sample = preprocess_llama_2_ego4d(
            narrations, self.tokenizer, self.fps, max_turns=self.max_turns
        )
        video = None
        if self._frame_loader is not None:
            video = self._frame_loader(video_path, 0.0, narrations[-1][0])
        return {
            "input_ids": sample["input_ids"],
            "labels": sample["labels"],
            "span_frames": sample["span_frames"],
            "video": video,
            "video_path": video_path,
            "timestamp": sample["timestamp"],
            "caption_info": sample["captions"],
            "gate_labels": self.gate_labels(narrations)[None],
            "model_type": self.model_type,
            "data_type": self.data_type,
        }


def collate_ego4d_batch(instances: Sequence[Dict]) -> Dict:
    if len(instances) != 1:
        raise ValueError(
            "ego4d streaming samples are whole-video dialogues; batch_size "
            f"must be 1 (got {len(instances)})"
        )
    inst = instances[0]
    return {
        "timestamp": inst["timestamp"],
        "labels": inst["labels"],
        "input_ids": inst["input_ids"],
        "caption_info": inst["caption_info"],
        "video_path": inst["video_path"],
        "images": [inst["video"], ["video"]],
        "attention_mask": None,
        "data_type": inst["data_type"],
        "model_type": inst["model_type"],
    }
