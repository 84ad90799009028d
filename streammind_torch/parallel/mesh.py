"""Device mesh construction.

The JAX package's one ``jax.sharding.Mesh`` over three axes, here a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names=("dp",
"fsdp", "tp")`` over the process group's ranks (one card a rank):

  dp    — data parallel (batch rows; gradients mean-reduced)
  fsdp  — fully-sharded data parallel (ZeRO-3: weights gathered at use,
          gradients reduce-scattered)
  tp    — tensor parallel (Megatron-style column / row splits, attention
          heads, Mamba channels); also the expert axis of Mixtral

A rank reads its axis groups with ``axis_group`` and its coordinates with
``axis_index``.  A (1, 1, 1) mesh with no process group started is a
``LocalMesh``: the same interface, every axis of size 1, no groups, so a
single process needs no rendezvous.  ``set_mesh`` makes a mesh ambient (the
counterpart of ``jax.set_mesh``): the attention dispatcher, the decoder's
MoE dispatch and the layers' tensor-parallel code read it.
"""
from __future__ import annotations

import contextlib
from types import MappingProxyType
from typing import Mapping, Optional

import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


class LocalMesh:
    """A (1, 1, 1) mesh of one process with no process group: the
    ``DeviceMesh`` methods the port calls, each axis of size 1."""

    mesh_dim_names = AXES
    shape = (1, 1, 1)

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return "LocalMesh(dp=1, fsdp=1, tp=1)"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, device_type: Optional[str] = None):
    """A (dp, fsdp, tp) mesh over every rank of the process group.  Raises
    ``ValueError`` where it needs more ranks than the world has (the JAX
    package's message, ranks for devices) or fewer than all of them."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    need = dp * fsdp * tp
    if need > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {need} devices, have {world}")
    if not started:
        return LocalMesh(device_type or "cuda")
    if need != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} covers {need} of the {world} ranks; "
                         "a mesh spans the whole process group")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), (dp, fsdp, tp), mesh_dim_names=AXES)


def single_device_mesh(device_type: Optional[str] = None):
    return make_mesh(1, 1, 1, device_type=device_type)


def default_mesh(n_devices: Optional[int] = None):
    """All-fsdp over n ranks (default: the world): ZeRO-3, the reference's
    DeepSpeed layout; switch to tp for latency-bound serving."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh(1, n, 1)


def replicated(mesh) -> tuple:
    """The spec of a leaf every rank holds whole (``P()``)."""
    return ()


_NO_AXES = MappingProxyType({})


def mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size}, read-only; empty for no mesh.  Kept on the mesh
    after the first call: the layers ask for it a few hundred times a
    decode step, and a ``DeviceMesh`` reads each size from a tensor."""
    if mesh is None:
        return _NO_AXES
    shape = getattr(mesh, "_axis_sizes", None)
    if shape is None:
        shape = MappingProxyType({name: int(mesh.size(i))
                                  for i, name in enumerate(mesh.mesh_dim_names)})
        mesh._axis_sizes = shape
    return shape


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 off the mesh)."""
    if mesh is None or name not in mesh.mesh_dim_names or axis_size(mesh, name) == 1:
        return 0
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name: str):
    """The process group of this rank's ``name`` axis; None for an axis of
    size 1 (nothing is communicated over it)."""
    if mesh is None or name not in mesh.mesh_dim_names or axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def is_trivial(mesh) -> bool:
    """No mesh, or every axis of size 1: the sharded code is the one-device
    code and issues no collective."""
    return mesh is None or all(v == 1 for v in mesh_shape(mesh).values())


_AMBIENT: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient for the block (``jax.set_mesh``).  A process-wide
    setting, not a thread-local one: the backward of a rematerialized layer
    recomputes its forward on autograd's threads and must see the mesh."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The innermost mesh of ``set_mesh`` (None outside one)."""
    return _AMBIENT[-1] if _AMBIENT else None
