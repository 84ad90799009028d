"""Prompt/label construction for streaming SFT (MatchTime-shaped samples).

A copy of the JAX package's ``data/preprocess.py``, which replicates the
reference's preprocess_llama_2_score:
  - one LLAMA_2-style round: "[INST] <<SYS>>…<video>\\nPlease describe… [/INST]
    caption </s>"
  - silence samples (caption == "</s>") render as "… [/INST] </s> </s>"; the
    duplicate space token at position -2 is dropped and the instruction mask
    is one token shorter
  - labels: IGNORE over BOS + instruction; supervised over answer tokens;
    on a length-bookkeeping mismatch the whole sample is zeroed
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..constants import IGNORE_INDEX, MMODAL_TOKEN_INDEX
from ..conversation import Conversation, SeparatorStyle, conv_mistral_instruct
from ..mm_utils import tokenizer_multimodal_token

_SEP = "[/INST] "
_EOS = "</s>"


def build_score_conversation(
    caption: str,
    conv: Optional[Conversation] = None,
    instruction: str = "<video>\nPlease describe the video content in detail based on the provided information.",
) -> str:
    conv = (conv or conv_mistral_instruct).copy()
    conv.append_message(conv.roles[0], instruction)
    conv.append_message(conv.roles[1], caption)
    return conv.get_prompt()


def preprocess_llama2_score(
    caption: str,
    tokenizer,
    conv: Optional[Conversation] = None,
    modal: str = "VIDEO",
    model_max_length: int = 2048,
) -> Dict[str, np.ndarray]:
    """caption + tokenizer → {input_ids, labels} (1, S) numpy arrays."""
    conv = conv or conv_mistral_instruct
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    modal_index = MMODAL_TOKEN_INDEX[modal]
    conversation = build_score_conversation(caption, conv)
    ids = tokenizer_multimodal_token(conversation, tokenizer, modal_index)

    is_silence = len(ids) >= 3 and ids[-3] == tokenizer.eos_token_id
    if is_silence:
        # "… </s> </s>" tokenizes with a stray space token between the two
        # EOS ids; drop it
        ids = ids[:-2] + ids[-1:]

    input_ids = np.asarray(ids, np.int64)[None]
    labels = input_ids.copy()

    rounds = conversation.split(conv.sep2)
    cur_len = 1
    labels[0, :cur_len] = IGNORE_INDEX
    total_len = input_ids.shape[1]
    for rou in rounds:
        if rou == "":
            break
        if is_silence:
            rou = rou + _EOS
        parts = rou.split(_SEP)
        if len(parts) != 2:
            break
        parts[0] += _SEP
        round_len = len(tokenizer_multimodal_token(rou, tokenizer, modal_index))
        inst_trim = 1 if is_silence else 2
        instruction_len = (
            len(tokenizer_multimodal_token(parts[0], tokenizer, modal_index)) - inst_trim
        )
        labels[0, cur_len : cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    labels[0, cur_len:] = IGNORE_INDEX

    if cur_len < model_max_length and cur_len != total_len:
        labels[0, :] = IGNORE_INDEX  # silent zero-out on mismatch

    return {"input_ids": input_ids, "labels": labels}


def build_score_sample(
    caption: str,
    video_path: str,
    half: int,
    timestamp: float,
    tokenizer,
    conv: Optional[Conversation] = None,
    past_review_caption: Optional[str] = None,
) -> Dict:
    """Full sample record in the reference collator's shape."""
    out = preprocess_llama2_score(caption, tokenizer, conv)
    past_ids = None
    if past_review_caption is not None:
        past_ids = np.asarray(tokenizer(past_review_caption).input_ids, np.int64)[None]
    return {
        "input_ids": out["input_ids"],
        "labels": out["labels"],
        "timestamp": timestamp,
        "caption_info": caption,
        "half": half,
        "video_path": video_path,
        "past_review_caption": past_ids,
    }
