"""Meta-architecture: the full model's params and the modal-token splice.

The host builds a static-size splice plan (numpy index arrays); the
device side is one gather + select, so a prompt/span combination only
needs its bucket size.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import StreamMindConfig
from ..constants import IGNORE_INDEX, MAX_VISION_BATCH_FRAMES
from . import mistral as lm
from . import projector as proj
from .vit import init_vit_params, vit_forward


def init_streammind_params(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                           dtype=torch.float32):
    """Random full model weights made directly on ``device`` from the
    generator ``g`` (which must live on that device)."""
    kw = dict(device=device, dtype=dtype)
    return {
        "vision": init_vit_params(g, cfg.vision, **kw),
        "projector": proj.init_projector_params(g, cfg, **kw),
        "text": lm.init_text_params(g, cfg.text, **kw),
    }


def init_projector(g: torch.Generator, cfg: StreamMindConfig, device="cuda",
                   dtype=torch.float32):
    return proj.init_projector_params(g, cfg, device=device, dtype=dtype)


def encode_frames(params, cfg: StreamMindConfig, pixels: torch.Tensor,
                  attn_impl: str = "auto") -> torch.Tensor:
    """(T, 3, H, W) → (1, T, N, mm_hidden): per-frame ViT features, of the
    last MAX_VISION_BATCH_FRAMES (600) frames at most."""
    if pixels.shape[0] > MAX_VISION_BATCH_FRAMES:
        pixels = pixels[-MAX_VISION_BATCH_FRAMES:]
    feats = vit_forward(params["vision"], cfg.vision, pixels, attn_impl=attn_impl)
    return feats[None]


@dataclasses.dataclass
class SplicePlan:
    """Static-size plan for replacing modal slots with memory-token spans.

    token_ids: (P,) vocab ids (0 where a memory token goes)
    mem_index: (P,) index into the memory-token sequence
    use_mem:   (P,) bool — True where the position takes a memory token
    attn_mask: (P,) bool — valid positions
    labels:    (P,) labels with IGNORE_INDEX over prompt/memory/pad
    length:    true sequence length
    """

    token_ids: np.ndarray
    mem_index: np.ndarray
    use_mem: np.ndarray
    attn_mask: np.ndarray
    labels: np.ndarray
    length: int


def build_splice_plan(
    input_ids: Sequence[int],
    span_lengths: Sequence[int],
    modal_token_index: int,
    pad_to: int,
    labels: Optional[Sequence[int]] = None,
) -> SplicePlan:
    """Expand each modal slot (== modal_token_index) to its span length;
    memory tokens are indexed consecutively across spans."""
    ids = list(input_ids)
    labs = list(labels) if labels is not None else None
    out_ids: List[int] = []
    out_mem: List[int] = []
    out_use: List[bool] = []
    out_lab: List[int] = []
    span_i = 0
    mem_base = 0
    for pos, tok in enumerate(ids):
        if tok == modal_token_index:
            if span_i >= len(span_lengths):
                raise ValueError(
                    f"prompt has more modal slots than the {len(span_lengths)} span(s) provided"
                )
            n = span_lengths[span_i]
            out_ids += [0] * n
            out_mem += [mem_base + j for j in range(n)]
            out_use += [True] * n
            out_lab += [IGNORE_INDEX] * n
            mem_base += n
            span_i += 1
        else:
            out_ids.append(tok)
            out_mem.append(0)
            out_use.append(False)
            out_lab.append(labs[pos] if labs is not None else IGNORE_INDEX)
    if span_i != len(span_lengths):
        raise ValueError(f"{len(span_lengths)} spans provided but {span_i} modal slots found")
    length = len(out_ids)
    if length > pad_to:
        raise ValueError(f"spliced length {length} exceeds bucket {pad_to}")
    pad = pad_to - length
    return SplicePlan(
        token_ids=np.asarray(out_ids + [0] * pad, np.int32),
        mem_index=np.asarray(out_mem + [0] * pad, np.int32),
        use_mem=np.asarray(out_use + [False] * pad, bool),
        attn_mask=np.asarray([True] * length + [False] * pad, bool),
        labels=np.asarray(out_lab + [IGNORE_INDEX] * pad, np.int32),
        length=length,
    )


def splice_embeds(text_params, plan_token_ids: torch.Tensor, plan_mem_index: torch.Tensor,
                  plan_use_mem: torch.Tensor, memory_tokens: torch.Tensor) -> torch.Tensor:
    """Token embeds where use_mem is False, gathered memory tokens where True.
    plan tensors (B, P); memory_tokens (B, M, D)."""
    tok_emb = text_params["embed_tokens"][plan_token_ids.long()]
    idx = plan_mem_index.long()[..., None].expand(-1, -1, memory_tokens.shape[-1])
    mem_emb = torch.gather(memory_tokens, 1, idx)
    return torch.where(plan_use_mem[..., None], mem_emb.to(tok_emb.dtype), tok_emb)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")
