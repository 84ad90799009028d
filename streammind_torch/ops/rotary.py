"""Rotary position embeddings (Mistral/Llama convention: half-dim rotation)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin tables for integer positions (...,) → (..., head_dim//2) fp32."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[..., :d/2], x[..., d/2:]) — HF 'rotate_half' layout.

    x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2),
    broadcast over the heads axis.
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
