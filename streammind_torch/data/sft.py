"""Offline SFT dataset (VideoLLaVA-style pretrain/finetune JSON).

A copy of the JAX package's ``data/sft.py``.

Rebuilds the reference's train.py LazySupervisedDataset (train.py:533-660,
README.md:79-92 layout): records carry {"id", "video"|"image",
"conversations": [{"from": "human"|"gpt", "value": ...}]}.  Two label
builders:
  - plain (projector pretrain): "<video>caption</s>", only the caption
    supervised (reference preprocess_plain)
  - llama_2 (instruction SFT): multi-round [INST] masking — the multi-round
    generalization of preprocess.preprocess_llama2_score
"""
from __future__ import annotations

import copy
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, MMODAL_TOKEN_INDEX
from ..conversation import Conversation, SeparatorStyle, conv_mistral_instruct
from ..mm_utils import tokenizer_multimodal_token

_SEP = "[/INST] "
_EOS = "</s>"


def build_conversation_prompt(
    conversations: Sequence[Dict], conv: Optional[Conversation] = None
) -> str:
    conv = (conv or conv_mistral_instruct).copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    msgs = list(conversations)
    if roles.get(msgs[0]["from"]) != conv.roles[0]:
        msgs = msgs[1:]
    conv.messages = []
    for j, sentence in enumerate(msgs):
        conv.append_message(roles[sentence["from"]], sentence["value"])
    return conv.get_prompt()


def preprocess_llama2_conversations(
    conversations: Sequence[Dict],
    tokenizer,
    conv: Optional[Conversation] = None,
    modal: str = "VIDEO",
    model_max_length: int = 2048,
) -> Dict[str, np.ndarray]:
    """Multi-round [INST] masking (reference train.py preprocess_llama_2)."""
    conv = conv or conv_mistral_instruct
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    modal_index = MMODAL_TOKEN_INDEX[modal]
    prompt = build_conversation_prompt(conversations, conv)
    ids = tokenizer_multimodal_token(prompt, tokenizer, modal_index)
    input_ids = np.asarray(ids, np.int64)[None]
    labels = input_ids.copy()

    rounds = prompt.split(conv.sep2)
    cur_len = 1
    labels[0, :cur_len] = IGNORE_INDEX
    total_len = input_ids.shape[1]
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(_SEP)
        if len(parts) != 2:
            break
        parts[0] += _SEP
        round_len = len(tokenizer_multimodal_token(rou, tokenizer, modal_index))
        instruction_len = (
            len(tokenizer_multimodal_token(parts[0], tokenizer, modal_index)) - 2
        )
        labels[0, cur_len : cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    labels[0, cur_len:] = IGNORE_INDEX
    if cur_len < model_max_length and cur_len != total_len:
        labels[0, :] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": labels}


def preprocess_plain(
    conversations: Sequence[Dict], tokenizer, modal: str = "VIDEO"
) -> Dict[str, np.ndarray]:
    """Projector-pretrain pairs: '<video>' + caption + </s>; prompt masked."""
    modal_index = MMODAL_TOKEN_INDEX[modal]
    source_prompt = conversations[0]["value"]  # contains the modal token
    caption = conversations[1]["value"]
    token = f"<{modal.lower()}>"
    prompt = token + caption + _EOS
    del source_prompt
    ids = tokenizer_multimodal_token(prompt, tokenizer, modal_index)
    input_ids = np.asarray(ids, np.int64)[None]
    labels = input_ids.copy()
    # mask BOS + the modal slot
    n_prefix = 2 if ids and ids[0] == getattr(tokenizer, "bos_token_id", None) else 1
    labels[0, :n_prefix] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": labels}


class VideoLLaVASFTDataset:
    """Lazy offline SFT dataset over the videollava_pt/sft JSON layout."""

    def __init__(
        self,
        data_path: str,
        data_folder: str,
        tokenizer,
        num_frames: int = 8,
        style: str = "llama_2",   # or "plain"
        frame_loader=None,
        seed: int = 0,
    ):
        with open(data_path) as f:
            self.records: List[Dict] = json.load(f)
        self.data_folder = data_folder
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.style = style
        self._rng = random.Random(seed)
        self._frame_loader = frame_loader or self._default_loader

    def __len__(self) -> int:
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        """Signed sample lengths: negative for text-only records — the
        grouping key for the modality-aware length sampler (reference
        videollama2_trainer_score.py:236-272)."""
        out = []
        for r in self.records:
            n = sum(len(c["value"].split()) for c in r["conversations"])
            has_media = "video" in r or "image" in r
            out.append(n if has_media else -n)
        return out

    def _default_loader(self, media_path: str, is_video: bool):
        from ..mm_utils import process_image, process_video

        if is_video:
            return process_video(media_path, num_frames=self.num_frames)
        return process_image(media_path)

    def __getitem__(self, i: int, _retries: int = 10) -> Dict:
        if _retries <= 0:
            raise RuntimeError("too many bad samples")
        rec = self.records[i]
        convs = copy.deepcopy(rec["conversations"])
        modal = "VIDEO" if "video" in rec else ("IMAGE" if "image" in rec else None)
        if self.style == "plain":
            out = preprocess_plain(convs, self.tokenizer, modal or "VIDEO")
        else:
            out = preprocess_llama2_conversations(
                convs, self.tokenizer, modal=modal or "VIDEO"
            )
        video = None
        if modal is not None:
            media = rec.get("video") or rec.get("image")
            path = os.path.join(self.data_folder, media)
            try:
                video = self._frame_loader(path, modal == "VIDEO")
            except Exception:  # noqa: BLE001 — retry elsewhere like the reference
                return self.__getitem__(
                    self._rng.randint(0, len(self) - 1), _retries - 1
                )
        return {
            "input_ids": out["input_ids"],
            "labels": out["labels"],
            "video": video,
            "modal": modal,
            "id": rec.get("id", i),
        }


def collate_sft_batch(instances: Sequence[Dict], pad_token_id: int = 0) -> Dict:
    """Right-padded batch collator (DataCollatorForSupervisedDataset,
    train_new_stream.py:587-620)."""
    max_len = max(x["input_ids"].shape[1] for x in instances)
    ids = np.full((len(instances), max_len), pad_token_id, np.int64)
    labels = np.full((len(instances), max_len), IGNORE_INDEX, np.int64)
    mask = np.zeros((len(instances), max_len), bool)
    for i, inst in enumerate(instances):
        n = inst["input_ids"].shape[1]
        ids[i, :n] = inst["input_ids"][0]
        labels[i, :n] = inst["labels"][0]
        mask[i, :n] = True
    return {
        "input_ids": ids,
        "labels": labels,
        "attention_mask": mask,
        "videos": [x["video"] for x in instances],
        "modals": [x["modal"] for x in instances],
    }
