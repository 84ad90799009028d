"""Memory-token subsampling before the LLM splice (the ``sample_type`` /
``sample_per`` stream options).

  * ``exponential_sampling`` ("log"): keep ~sample_per of the tokens at
    linearly spaced indices, both ends included (the flag's name survives
    from an older log-spaced variant);
  * ``similarity_sampling`` ("similarity"): keep the tokens most
    cosine-similar to the newest memory token, in temporal order.

The serving path subsamples the turn's span INDICES on the host
(``subsample_span``), so the splice plans keep their bucketed shapes.
"""
from __future__ import annotations

import numpy as np
import torch


def exponential_sampling(tokens: torch.Tensor, percentage: float = 0.6) -> torch.Tensor:
    """tokens (T, D) → (k, D), k = max(int(percentage*T), 1), linearly
    spaced indices including both ends."""
    n = tokens.shape[0]
    k = int(percentage * n) or 1
    idx = np.linspace(0, n - 1, k).astype(np.int64)
    return tokens[torch.from_numpy(idx).to(tokens.device)]


def similarity_sampling(tokens: torch.Tensor, percentage: float = 0.6) -> torch.Tensor:
    """The top-percentage tokens by cosine similarity to the last token,
    re-sorted into temporal order."""
    n = tokens.shape[0]
    k = max(int(percentage * n), 1)
    t32 = tokens.float()
    last = t32[-1]
    sims = (t32 @ last) / (torch.linalg.norm(t32, dim=1) * torch.linalg.norm(last) + 1e-8)
    top = torch.argsort(-sims, stable=True)[:k]
    return tokens[torch.sort(top).values]


def subsample_memory(tokens: torch.Tensor, sample_type: str = "all",
                     sample_per: float = 0.6) -> torch.Tensor:
    """Dispatch on sample_type ('all' | 'log' | 'similarity')."""
    if sample_type == "log":
        return exponential_sampling(tokens, sample_per)
    if sample_type == "similarity":
        return similarity_sampling(tokens, sample_per)
    return tokens


def subsample_span_indices(n: int, sample_type: str, sample_per: float,
                           values=None) -> np.ndarray:
    """Which of a turn's n memory slots survive, as int32 indices.
    values: (n, D) span token values, needed for 'similarity'."""
    if sample_type in (None, "all") or n <= 1:
        return np.arange(n, dtype=np.int32)
    k = int(sample_per * n) or 1
    if sample_type == "log":
        return np.linspace(0, n - 1, k).astype(np.int32)
    if sample_type == "similarity":
        if values is None:
            raise ValueError("similarity subsampling needs the span values")
        v = np.asarray(values, np.float32)
        last = v[-1]
        sims = (v @ last) / (np.linalg.norm(v, axis=1) * np.linalg.norm(last) + 1e-8)
        top = np.argsort(-sims, kind="stable")[:k]
        return np.sort(top).astype(np.int32)
    raise ValueError(f"unknown sample_type {sample_type!r} "
                     "(expected 'all', 'log' or 'similarity')")


def subsample_span(span: list, memory_row: torch.Tensor, sample_type: str,
                   sample_per: float) -> list:
    """Subsample a turn's span (absolute ring indices).  memory_row: the
    (1, M, D) ring, read on the host only for 'similarity'."""
    if sample_type in (None, "all") or len(span) <= 1:
        return list(span)
    values = None
    if sample_type == "similarity":
        values = memory_row[0, list(span)].float().cpu().numpy()
    keep = subsample_span_indices(len(span), sample_type, sample_per, values)
    return [span[int(i)] for i in keep]
