"""The collectives of the tensor-, sequence- and fully-sharded-parallel
layers, as ``torch.autograd.Function``s (the reference's
``mamba_ssm/distributed/tensor_parallel.py`` pairs, which GSPMD inserts in
the JAX package):

  copy_to_tp        identity forward, all-reduce backward (the input of a
                    column-parallel product: each rank's share of dx)
  reduce_from_tp    all-reduce forward, identity backward (the output of a
                    row-parallel product)
  gather            all-gather along a dim forward; backward a
                    reduce-scatter summed (``"sum"``: each rank used its own
                    part), averaged (``"mean"``: every rank of the axis ran
                    the same rows, as fsdp ranks do — ZeRO-3's gather at
                    use), or this rank's slice (``"slice"``)
  scatter           this rank's chunk forward, all-gather backward
  reduce_scatter    reduce-scatter forward, all-gather backward (a
                    row-parallel output under sequence parallelism)

Each takes the mesh and an axis name and issues nothing where that axis has
size 1, as GSPMD inserts nothing on an axis of size 1: a (1, 1, 1) mesh
launches exactly what no mesh launches.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .mesh import axis_group, axis_index, axis_size

# torch 2.13 names the tensor forms *_single and warns on the old names,
# which torch 2.11 (the card's) has alone
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r".* is deprecated")


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenation along ``dim`` of every rank's ``x``, in rank order (no
    gradient: the autograd functions below carry it)."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    xt = x.detach().movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    out = out.movedim(0, dim)
    return out if dim == 0 else out.contiguous()


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over ranks of ``x``, this rank's chunk along ``dim``."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    xt = x.detach().movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim of {xt.shape[0]} is no multiple of {n} ranks")
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    out = out.movedim(0, dim)
    return out if dim == 0 else out.contiguous()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def chunk_of(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim=dim)[i].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, bwd, index):
        ctx.group, ctx.dim, ctx.bwd, ctx.index = group, dim, bwd, index
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        if ctx.bwd == "slice":
            return chunk_of(g, ctx.dim, n, ctx.index), None, None, None, None
        out = reduce_scatter_dim(g, ctx.group, ctx.dim)
        if ctx.bwd == "mean":
            out = out / n
        return out, None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim = group, dim
        return chunk_of(x, dim, dist.get_world_size(group), index)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    group = axis_group(mesh, axis)
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    group = axis_group(mesh, axis)
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather(x: torch.Tensor, mesh, axis: str, dim: int, bwd: str = "sum") -> torch.Tensor:
    """All-gather along ``dim`` over ``axis``; ``bwd`` as the module says."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    return _Gather.apply(x, group, dim, bwd, axis_index(mesh, axis))


def scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    group = axis_group(mesh, axis)
    return x if group is None else _Scatter.apply(x, group, dim, axis_index(mesh, axis))


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    group = axis_group(mesh, axis)
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Elementwise max over ``axis`` (no gradient: the int8 ViT's per-token
    activation scale under a row split)."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather_rows(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """Every rank's rows of ``x`` along dim 0, in axis order (no gradient:
    the serving engine's dp-sharded outputs, gathered for the host)."""
    group = axis_group(mesh, axis)
    return x if group is None else all_gather_dim(x, group, 0)


def axis_rows(n: int, mesh, axis: str = "dp") -> slice:
    """The slice of ``n`` rows this rank holds along ``axis``."""
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} rows do not split over {axis}={k}")
    i = axis_index(mesh, axis)
    return slice(i * n // k, (i + 1) * n // k)
