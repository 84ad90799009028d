"""Top-k / top-p / temperature sampling for the decode loop.

Filter order as the JAX package (and the reference decode engine): top-k
mask, then temperature scaling, then the nucleus (top-p) over the SCALED
logits.  Conventions: temperature <= 0 → greedy argmax; top_k <= 0 → no
top-k; top_p <= 0 or >= 1 → no nucleus.  Ties at a boundary are all kept.
Random draws come from a ``torch.Generator`` and so differ from
``jax.random``'s; ``filtered_logits`` is what the two packages share.
The ``*_rows`` forms sample (K, V) logits with per-row (K,) knobs, for the
lockstep batched decode loops.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = float("-inf")


def _col(v, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar-or-(K,) knob against (..., V) logit rows."""
    v = torch.as_tensor(v, device=x.device)
    return v[..., None] if v.dim() else v


def filtered_logits(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """fp32 logits masked to the top-k, scaled by temperature, then masked
    to the nucleus.  Last axis is the vocab."""
    x = logits.float()
    V = x.shape[-1]
    top_k = _col(top_k, x).long()
    top_p = _col(top_p, x).float()
    temperature = _col(temperature, x).float()

    desc = torch.sort(x, dim=-1, descending=True).values
    k = torch.clamp(top_k, 1, V)
    kth = torch.gather(desc, -1, (k - 1).expand(*x.shape[:-1], 1))
    x = torch.where((top_k > 0) & (x < kth), _NEG_INF, x)

    x = x / torch.clamp(temperature, min=1e-6)

    # nucleus: drop the descending tail whose preceding mass reaches top_p
    desc2 = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(desc2, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep = before < top_p
    min_kept = torch.where(keep, desc2, float("inf")).amin(dim=-1, keepdim=True)
    nucleus = torch.where(x < min_kept, _NEG_INF, x)
    apply_p = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(apply_p, nucleus, x)


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float, top_k: int, top_p: float) -> int:
    """One token id from 1-D logits (V,): argmax when temperature <= 0, else
    a draw from the filtered distribution."""
    if temperature <= 0:
        return int(torch.argmax(logits))
    probs = torch.softmax(filtered_logits(logits, temperature, top_k, top_p), dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


def sample_first_token(generator, logits, temperature=0.0, top_k=0, top_p=0.0) -> int:
    """The first post-prefill token from logits (V,)."""
    return sample_token(generator, logits, temperature, top_k, top_p)


def sample_token_rows(generator: Optional[torch.Generator], logits: torch.Tensor,
                      temperature, top_k, top_p) -> list:
    """One token id per row of logits (K, V), with (K,) knobs (host lists):
    greedy rows (temperature <= 0) take the argmax, the others a draw from
    their filtered distribution.  Returns K ints (one host sync)."""
    greedy = torch.argmax(logits, dim=-1)
    if not any(t > 0 for t in temperature):
        return greedy.tolist()
    dev = logits.device
    temps = torch.tensor(temperature, dtype=torch.float32, device=dev)
    x = filtered_logits(logits, temps, torch.tensor(top_k, dtype=torch.int64, device=dev),
                        torch.tensor(top_p, dtype=torch.float32, device=dev))
    drawn = torch.multinomial(torch.softmax(x, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temps > 0, drawn, greedy).tolist()


def sample_first_token_rows(generator, logits, temperature, top_k, top_p) -> list:
    """The first post-prefill token of each row of logits (K, V)."""
    return sample_token_rows(generator, logits, temperature, top_k, top_p)
