"""Normalization layers with fp32 statistics (plain torch ops, as XLA ops in JAX)."""
from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics (Mistral/Llama convention)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return (x32 * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics (population variance)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
