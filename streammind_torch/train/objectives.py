"""Training objectives of the two StreamMind stages (and the adapter stage,
which shares stage 1's loss).

Stage 1 (LLM): the spliced multimodal LM cross-entropy — memory tokens of
the projector spliced into the token embeddings, then the decoder.

Stage 2 (gate): (memory token, label embed) pair sequences through the gate
LM with class-weighted CE: silence = 0 for every frame before a caption
timestamp, respond = 1 at it.

Each loss with ``with_tokens=True`` also returns its accumulation weight:
the supervised-token count (LM) or the class-weight sum (gate), each loss's
own denominator, so weighted accumulation over chunks gives the loss of the
combined batch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import StreamMindConfig
from ..constants import GATE_CLASS_WEIGHTS, IGNORE_INDEX
from ..models import mistral as lm
from ..models import projector as proj
from ..models.meta import splice_embeds


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted causal CE over (B, S, V) logits.  Returns (mean loss, number
    of target tokens); out-of-vocab labels are clipped into range."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.clamp(torch.where(valid, shift_labels, 0), 0, logits.shape[-1] - 1)
    logp = torch.log_softmax(shift_logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    n = valid.sum()
    loss = -torch.where(valid, picked, 0.0).sum() / torch.clamp(n, min=1)
    return loss, n


def stage1_llm_loss(params, cfg: StreamMindConfig, frames_features, plan_token_ids,
                    plan_mem_index, plan_use_mem, plan_attn_mask, labels,
                    remat: bool = False, attn_impl: str = "auto", with_tokens: bool = False):
    """Spliced multimodal LM loss: (1, T, N, mm_hidden) frame features →
    memory tokens → splice into the (1, P) plan → decoder → CE."""
    memory = proj.project_memory(params["projector"], cfg, frames_features)
    embeds = splice_embeds(params["text"], plan_token_ids, plan_mem_index, plan_use_mem, memory)
    logits, _ = lm.text_forward(params["text"], cfg.text, inputs_embeds=embeds,
                                attn_mask=plan_attn_mask, remat=remat, attn_impl=attn_impl)
    loss, n = lm_cross_entropy(logits, labels)
    return (loss, n.float()) if with_tokens else loss


def text_only_llm_loss(params, cfg: StreamMindConfig, token_ids, attn_mask, labels,
                       remat: bool = False, attn_impl: str = "auto", with_tokens: bool = False):
    """Plain LM loss for text-only records (no modal slot)."""
    logits, _ = lm.text_forward(params["text"], cfg.text, input_ids=token_ids.long(),
                                attn_mask=attn_mask, remat=remat, attn_impl=attn_impl)
    loss, n = lm_cross_entropy(logits, labels)
    return (loss, n.float()) if with_tokens else loss


def stage2_gate_loss(params, cfg: StreamMindConfig, frames_features, gate_labels,
                     label_mask, with_tokens: bool = False):
    """Gate training: frames → memory tokens; pairs [mem_t, embed(y_t)] with
    labels [IGNORE, y_t] (the shift makes the frame predict y_t);
    class-weighted CE on the 2-way head.  gate_labels (1, T) in {0, 1},
    label_mask (1, T) bool — frames that carry a label."""
    memory, _ = proj.mamba_project(params["projector"], cfg, frames_features)
    b, t, d = memory.shape
    gate_embed = params["projector"]["cls_net"]["embed_tokens"]       # (2, D)
    labels = gate_labels.long()
    label_emb = gate_embed[torch.clamp(labels, 0, 1)]                   # (B, T, D)
    pairs = torch.stack([memory, label_emb.to(memory.dtype)], dim=2).reshape(b * t, 2, d)
    pair_labels = torch.stack([torch.full_like(labels, IGNORE_INDEX), labels],
                              dim=2).reshape(b * t, 2)
    pair_labels = torch.where(label_mask.reshape(b * t, 1), pair_labels, IGNORE_INDEX)
    logits = proj.gate_logits(params["projector"], cfg, pairs)
    loss = proj.gate_loss(logits, pair_labels, GATE_CLASS_WEIGHTS)
    if not with_tokens:
        return loss
    shift = pair_labels[:, 1:]
    valid = shift != IGNORE_INDEX
    w = torch.tensor(GATE_CLASS_WEIGHTS, dtype=torch.float32,
                     device=logits.device)[torch.where(valid, shift, 0)]
    return loss, torch.where(valid, w, 0.0).sum()
