"""Carry a JAX-package param tree over to this package.

The two packages share one tree layout, so the conversion is leaf by
leaf: nested dicts and lists (the Mamba ``blocks``, the connectors'
``s1`` / ``s2`` stages and ``readout``, the MLP projector's ``mlp``) of
numpy arrays become the same structure of tensors.  Both the separate ``q/k/v`` and ``gate/up``
leaves and the fused ``qkv``/``gateup`` leaves pass through unchanged, as
do Qwen2's q/k/v biases, Mixtral's router and (L, E, F, D) expert banks
and quantized leaves (``w_int8``, ``w_int4``, ``w_int4pc`` and their
scales), of linears and of expert banks alike.  This module never imports JAX:
the caller hands in numpy arrays (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Leaves the JAX package keeps in fp32 whatever the tree's dtype: Mamba's
# A_log and D, Mamba-2's dt_bias, and quantization scales (per channel and
# per group).
_KEEP_FP32 = frozenset({"A_log", "D", "dt_bias", "scale", "scale4"})


def array_to_tensor(a) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a CPU tensor of the
    same dtype, ``ml_dtypes.bfloat16`` included."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy shares memory, which must be writable
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: reinterpret the bits, torch has no numpy bf16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor(a, device, dtype: Optional[torch.dtype], name: str) -> torch.Tensor:
    t = array_to_tensor(a)
    if dtype is not None and t.is_floating_point() and name not in _KEEP_FP32:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype: Optional[torch.dtype] = None,
                      _name: str = ""):
    """Numpy param tree → tensor tree on ``device``.  ``dtype`` casts the
    floating leaves (except A_log, D, dt_bias and the scales, which stay
    fp32); None
    keeps each leaf's own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype, _name) for v in tree]
    return _tensor(tree, device, dtype, _name)
