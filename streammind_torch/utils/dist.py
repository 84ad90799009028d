"""Multi-process runtime over ``torch.distributed``.

The JAX package's ``utils/dist.py`` in PyTorch: one entry point that starts
the process group (NCCL for CUDA, gloo for the CPU) and host-level helpers
for eval metric aggregation and work splitting.  The in-model collectives
live in ``parallel/collectives.py``, never here.

A launcher (``torchrun``, or a test that spawns processes) sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT``; or the caller passes ``init_method`` (``file://...`` or
``tcp://host:port``), ``world_size`` and ``rank`` itself.
"""
from __future__ import annotations

import datetime
import functools
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_process_group(init_method: Optional[str] = None, world_size: Optional[int] = None,
                       rank: Optional[int] = None, device: str = "cuda",
                       timeout_s: Optional[float] = None) -> None:
    """Start the process group: backend ``nccl`` for ``device="cuda"``,
    ``gloo`` for ``"cpu"``.  ``world_size`` and ``rank`` default to the
    ``WORLD_SIZE`` and ``RANK`` variables.  A no-op at world size 1 unless an
    ``init_method`` is given (as the JAX package's ``initialize`` is a no-op
    on one process), and a no-op once started.  On CUDA the rank's card is
    ``LOCAL_RANK`` (default: the rank modulo the cards present).
    ``timeout_s`` bounds how long a collective waits for its peers."""
    if _active():
        return
    n = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
    if n <= 1 and init_method is None:
        return
    r = rank if rank is not None else int(os.environ.get("RANK", 0))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", r % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=n,
                            rank=r, **kw)


initialize = init_process_group


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if _active():
        dist.destroy_process_group()


def size() -> int:
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def is_master() -> bool:
    return rank() == 0


def local_device_count() -> int:
    return torch.cuda.device_count()


def master_only(fn):
    """Run only on rank 0 (the reference's dist.py:171-181)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Cross-process sync point."""
    if _active():
        dist.barrier()


def allgather_object(obj: Any) -> List[Any]:
    """Every rank's python object, in rank order (the reference's
    allgather_diff_shape for metric lists, dist.py:120-145)."""
    if not _active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def allreduce_mean(value: float) -> float:
    """Scalar metric mean over ranks (dist_fmt_vals, dist.py:147-157)."""
    return float(np.mean(allgather_object(float(value))))


def shard_worklist(items: Sequence, num_chunks: Optional[int] = None,
                   chunk_idx: Optional[int] = None) -> List:
    """Rank-sliced work splitting for eval: the ``--num-chunks`` /
    ``--chunk-idx`` semantics with the rank as the default chunk."""
    from ..eval.mcqa import get_chunk

    n = num_chunks if num_chunks is not None else size()
    k = chunk_idx if chunk_idx is not None else rank()
    return get_chunk(items, n, k)
