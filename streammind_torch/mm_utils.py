"""Tokenizer helpers of the streaming path (modal-token splice, stop trim)."""
from __future__ import annotations

from typing import List, Sequence

from .constants import IMAGE_TOKEN_INDEX, MMODAL_INDEX_TOKEN


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
