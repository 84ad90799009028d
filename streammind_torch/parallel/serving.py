"""Tensor-parallel serving: the layouts of inference-side state.

Parameters are sharded by the partitioning rules; the state a serving
engine creates — KV cache, Mamba conv/ssm carries, memory ring — is placed
by the specs below, as the JAX package's ``parallel/serving.py`` places it
(the reference's ColumnParallelLinear / RowParallelLinear /
VocabParallelEmbedding serving layers, tensor_parallel.py:111-241).  Here a
"placement" is the rank's local shard (``partitioning.local_shard``):

  KV cache k/v (L, B, capacity, n_kv_heads, head_dim)
      → kv heads on tp (each rank attends with its own heads; the row-
        parallel o sums over tp), batch on dp when the caller serves a
        dp-sharded row batch.
  Mamba conv (L, B, d_inner, k) / ssm (L, B, d_inner, d_state)
      → d_inner on tp (matching in_proj / out_proj), streams on dp.
  memory ring (S, capacity, hidden)
      → whole; the stream axis on dp for batched perception.
"""
from __future__ import annotations

from typing import Optional

from .mesh import axis_size, is_trivial, mesh_shape
from .partitioning import local_shard, mesh_coords


def kv_cache_specs(batch_axis: Optional[str] = None):
    """Specs of a KVCache: kv heads on tp, batch on ``batch_axis``."""
    from ..models.mistral import KVCache

    return KVCache(k=(None, batch_axis, None, "tp", None), v=(None, batch_axis, None, "tp", None),
                   length=(batch_axis,))


def _place(leaves, specs, mesh) -> list:
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    return [local_shard(t, sp, shape, coords) if hasattr(t, "dim") else t
            for t, sp in zip(leaves, specs)]


def shard_kv_cache(cache, mesh, batch_axis: Optional[str] = None):
    """This rank's shard of a whole cache (its kv heads and, with
    ``batch_axis``, its rows)."""
    if is_trivial(mesh):
        return cache
    return type(cache)(*_place(cache, kv_cache_specs(batch_axis), mesh))


def stream_state_specs(stream_axis: Optional[str] = None):
    """Specs of a StreamState: Mamba d_inner on tp, streams on
    ``stream_axis`` (dp for batched perception)."""
    from ..models.mamba import MambaState
    from ..streaming.state import StreamState

    return StreamState(
        mamba=MambaState(conv=(None, stream_axis, "tp", None), ssm=(None, stream_axis, "tp", None)),
        memory=(stream_axis, None, None),
        frame_idx=() if stream_axis is None else (stream_axis,),
        last_fire=() if stream_axis is None else (stream_axis,),
    )


def shard_stream_state(state, mesh, stream_axis: Optional[str] = None):
    """This rank's shard of a whole stream state."""
    if is_trivial(mesh):
        return state
    specs = stream_state_specs(stream_axis)
    return type(state)(type(state.mamba)(*_place(state.mamba, specs.mamba, mesh)),
                       *_place(state[1:], specs[1:], mesh))


def mesh_fits_inference(mesh, cfg) -> bool:
    """True when tp divides the kv heads and the Mamba d_inner, the two
    state axes the specs above split."""
    tp = axis_size(mesh, "tp")
    d_inner = cfg.mamba.d_model * cfg.mamba.expand
    return cfg.text.num_kv_heads % tp == 0 and d_inner % tp == 0
