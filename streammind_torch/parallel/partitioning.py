"""Parameter partitioning: the JAX package's path rules, and explicit shards.

``RULES`` is the JAX package's list verbatim (t5x-style path regex → spec
by rank, first match wins), with a spec written as a tuple of axis names or
None per dim (``PartitionSpec`` is a tuple too): linear weights are (out,
in), so column-parallel is dim 0 on tp and row-parallel dim 1 on tp, the
other matmul dim on fsdp; stacked decoder layers carry a leading layer axis
that is never split.

Where JAX places each leaf on a ``NamedSharding`` and lets GSPMD insert the
collectives, ``shard_params`` here returns each rank's LOCAL shard as a
plain tensor, split on the dims its spec names (``local_shard``, a pure
function of the leaf, the spec, the mesh's shape and the rank's
coordinates), and the layers gather and reduce by hand
(``parallel/collectives.py``).  ``use_linear`` / ``use_leaf`` turn a
stored shard into what a product needs: the fsdp dims gathered (ZeRO-3's
gather at use), and the tp dim the role asks for — column (out on tp), row
(in on tp) or whole — cut or gathered.

Two leaves are not split positionally, because a positional split of their
packed dim would not give a rank the rows or columns its product reads:
  - a per-channel int4 weight (``w_int4pc``) cut on its packed in dim by tp
    (a row-parallel o or down): byte c holds input columns c and in/2 + c,
    so a rank's shard is REPACKED — its in/tp columns unpacked and packed
    column-halved again — and is itself a valid ``w_int4pc``;
  - the Mamba ``in_proj`` (2·d_inner, D) on tp: its rows are x then z, so a
    rank holds its chunk of each, [x_r; z_r].
``gather_params`` inverts both.  A gather over fsdp concatenates bytes,
which restores a packed matrix unchanged.
"""
from __future__ import annotations

import functools
import re
from typing import List, Optional, Tuple

import torch

from . import collectives as C
from .mesh import AXES, ambient_mesh, axis_index, axis_size, is_trivial, mesh_shape

Spec = Tuple[Optional[str], ...]

RULES: List[Tuple[str, dict]] = [
    # --- decoder (stacked layers: leading L axis) ---
    # w_int8 / w_int4 (quantized loading, --bits) shard like the fp weight
    # they replace; per-channel `scale` (L, out) and group-wise `scale4`
    # (L, out, groups) follow the out-dim shard
    (r"text\.layers\.(q|k|v)\.(weight|w_int8|w_int4)", {3: (None, "tp", "fsdp")}),
    (r"text\.layers\.(q|k|v)\.scale4", {3: (None, "tp", None)}),
    (r"text\.layers\.(q|k|v)\.scale", {2: (None, "tp")}),
    # Qwen2 q/k/v biases: (L, out) — out-dim follows the weight's tp shard
    (r"text\.layers\.(q|k|v)\.bias", {2: (None, "tp")}),
    (r"text\.layers\.o\.(weight|w_int8|w_int4)", {3: (None, "fsdp", "tp")}),
    (r"text\.layers\.o\.scale4", {3: (None, "fsdp", None)}),
    (r"text\.layers\.o\.scale", {2: (None, "fsdp")}),
    (r"text\.layers\.mlp\.(gate|up)\.(weight|w_int8|w_int4)", {3: (None, "tp", "fsdp")}),
    (r"text\.layers\.mlp\.(gate|up)\.scale4", {3: (None, "tp", None)}),
    (r"text\.layers\.mlp\.(gate|up)\.scale", {2: (None, "tp")}),
    (r"text\.layers\.mlp\.down\.(weight|w_int8|w_int4)", {3: (None, "fsdp", "tp")}),
    (r"text\.layers\.mlp\.down\.scale4", {3: (None, "fsdp", None)}),
    (r"text\.layers\.mlp\.down\.scale", {2: (None, "fsdp")}),
    # LoRA factors: A (L, r, in) rides the in-dim shard, B (L, out, r) the
    # out-dim shard
    (r"lora\.layers\.(q|k|v)\.A", {3: (None, None, "fsdp")}),
    (r"lora\.layers\.(q|k|v)\.B", {3: (None, "tp", None)}),
    (r"lora\.layers\.o\.A", {3: (None, None, "tp")}),
    (r"lora\.layers\.o\.B", {3: (None, "fsdp", None)}),
    (r"lora\.layers\.mlp\.(gate|up)\.A", {3: (None, None, "fsdp")}),
    (r"lora\.layers\.mlp\.(gate|up)\.B", {3: (None, "tp", None)}),
    (r"lora\.layers\.mlp\.down\.A", {3: (None, None, "tp")}),
    (r"lora\.layers\.mlp\.down\.B", {3: (None, "fsdp", None)}),
    # MoE experts: (L, E, out, in) — expert axis on tp (expert parallel)
    (r"text\.layers\.experts\.(gate|up)", {4: (None, "tp", None, "fsdp")}),
    (r"text\.layers\.experts\.down", {4: (None, "tp", None, "fsdp")}),
    (r"text\.layers\.router\.weight", {3: (None, None, "fsdp")}),
    (r"text\.layers\..*norm.*", {2: (None, None)}),
    (r"text\.embed_tokens", {2: ("tp", "fsdp")}),
    (r"text\.lm_head\.weight", {2: ("tp", "fsdp")}),
    (r"text\.final_norm.*", {1: (None,)}),
    # --- gate LM (tiny; shard like the decoder) ---
    (r"projector\.cls_net\.layers\.(q|k|v)\.weight", {3: (None, "tp", "fsdp")}),
    (r"projector\.cls_net\.layers\.o\.weight", {3: (None, "fsdp", "tp")}),
    (r"projector\.cls_net\.layers\.mlp\.(gate|up)\.weight", {3: (None, "tp", "fsdp")}),
    (r"projector\.cls_net\.layers\.mlp\.down\.weight", {3: (None, "fsdp", "tp")}),
    (r"projector\.cls_net\.embed_tokens", {2: (None, "fsdp")}),
    (r"projector\.cls_net\.lm_head\.weight", {2: (None, "fsdp")}),
    # --- Mamba mixer: d_inner is the independent channel axis → tp ---
    (r"projector\.mamba\.blocks\.\d+\.in_proj\.weight", {2: ("tp", "fsdp")}),
    (r"projector\.mamba\.blocks\.\d+\.out_proj\.weight", {2: ("fsdp", "tp")}),
    (r"projector\.mamba\.blocks\.\d+\.x_proj\.weight", {2: (None, "tp")}),
    (r"projector\.mamba\.blocks\.\d+\.dt_proj\.weight", {2: ("tp", None)}),
    (r"projector\.mamba\.blocks\.\d+\.dt_proj\.bias", {1: ("tp",)}),
    (r"projector\.mamba\.blocks\.\d+\.conv1d\.weight", {2: ("tp", None)}),
    (r"projector\.mamba\.blocks\.\d+\.conv1d\.bias", {1: ("tp",)}),
    (r"projector\.mamba\.blocks\.\d+\.A_log", {2: ("tp", None)}),
    (r"projector\.mamba\.blocks\.\d+\.D", {1: ("tp",)}),
    # --- projector pre/post nets ---
    (r"projector\.(pre_net|post_net)\.weight", {2: ("fsdp", None)}),
    # --- vision tower: small; fsdp-shard the big matrices only ---
    (r"vision\.layers\.(q|k|v|fc1)\.weight", {3: (None, "tp", "fsdp")}),
    (r"vision\.layers\.(o|fc2)\.weight", {3: (None, "fsdp", "tp")}),
    (r"vision\.patch_embedding", {2: ("fsdp", None)}),
]

_IN_PROJ = re.compile(r"projector\.mamba\.blocks\.\d+\.in_proj\.(weight|bias)$")


@functools.lru_cache(maxsize=None)
def spec_for(path: str, ndim: int) -> Spec:
    for pattern, by_rank in RULES:
        if re.match(pattern, path):
            spec = by_rank.get(ndim)
            if spec is not None:
                return spec
    return ()  # replicate


def _full_spec(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix.rstrip("."), tree)


def param_specs(params) -> dict:
    """Mirror tree of specs for a param tree (dicts + lists)."""
    return _walk(params, lambda path, t: spec_for(path, t.dim()))


# ---------------------------------------------------------------------------
# Placement: local shards and their inverse
# ---------------------------------------------------------------------------
def _unpack_pc(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([(p << 4) >> 4, p >> 4], dim=-1)


def _pack_pc(q: torch.Tensor) -> torch.Tensor:
    h = q.shape[-1] // 2
    return ((q[..., :h] & 0x0F) | (q[..., h:] << 4)).contiguous()


def _layout(path: str, dim: int, ndim: int, axis: str) -> str:
    """How ``path`` splits along ``dim``: "int4pc" (repacked), "parts2"
    (x then z, each chunked) or "plain" (positional)."""
    if axis == "tp" and path.endswith("w_int4pc") and dim == ndim - 1:
        return "int4pc"
    if axis == "tp" and dim == 0 and _IN_PROJ.match(path):
        return "parts2"
    return "plain"


def split_dim(t: torch.Tensor, dim: int, n: int, i: int, layout: str = "plain") -> torch.Tensor:
    """Chunk ``i`` of ``n`` of ``t`` along ``dim`` in the given layout."""
    if n == 1:
        return t
    if layout == "int4pc":
        q = _unpack_pc(t)
        if q.shape[-1] % (2 * n):
            raise ValueError(f"w_int4pc in-width {q.shape[-1]} does not split over {n} ranks")
        return _pack_pc(q.chunk(n, dim=-1)[i])
    if layout == "parts2":
        return torch.cat([C.chunk_of(h, dim, n, i) for h in t.chunk(2, dim=dim)], dim=dim)
    return C.chunk_of(t, dim, n, i)


def join_dim(pieces: list, dim: int, layout: str = "plain") -> torch.Tensor:
    """Inverse of ``split_dim``: the n chunks, in rank order, → the whole."""
    if len(pieces) == 1:
        return pieces[0]
    if layout == "int4pc":
        return _pack_pc(torch.cat([_unpack_pc(p) for p in pieces], dim=-1))
    if layout == "parts2":
        halves = [p.chunk(2, dim=dim) for p in pieces]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)
    return torch.cat(pieces, dim=dim)


def local_shard(leaf: torch.Tensor, spec: Spec, shape: dict, coords: dict,
                path: str = "") -> torch.Tensor:
    """This rank's shard of a whole ``leaf``: along each dim its spec names,
    chunk ``coords[axis]`` of ``shape[axis]`` (in the leaf's layout)."""
    out = leaf
    for dim, axis in enumerate(_full_spec(spec, leaf.dim())):
        if axis is not None:
            out = split_dim(out, dim, shape.get(axis, 1), coords.get(axis, 0),
                            _layout(path, dim, leaf.dim(), axis))
    return out


def mesh_coords(mesh) -> dict:
    return {a: axis_index(mesh, a) for a in AXES}


def shard_params(params, mesh):
    """This rank's local shard of every leaf of a whole tree, by the rules."""
    if is_trivial(mesh):
        return params
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    return _walk(params, lambda path, t: local_shard(t, spec_for(path, t.dim()), shape,
                                                     coords, path))


def gather_leaf(t: torch.Tensor, path: str, full_ndim: int, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (collective over the axes the
    spec names; every rank gets the whole)."""
    spec = _full_spec(spec_for(path, full_ndim), full_ndim)
    for dim, axis in enumerate(spec):
        if axis is None or axis_size(mesh, axis) == 1:
            continue
        group = mesh.get_group(axis)
        pieces = C.all_gather_dim(t.contiguous(), group, dim).chunk(axis_size(mesh, axis),
                                                                    dim=dim)
        t = join_dim(list(pieces), dim, _layout(path, dim, full_ndim, axis))
    return t


def gather_params(params, mesh):
    """Inverse of ``shard_params``: the whole tree on every rank (for
    checkpoints and tests)."""
    if is_trivial(mesh):
        return params
    return _walk(params, lambda path, t: gather_leaf(t, path, t.dim(), mesh))


# ---------------------------------------------------------------------------
# Use: what a product needs, from a stored shard
# ---------------------------------------------------------------------------
_WEIGHTS = ("weight", "w_int8", "w_int4", "w_int4pc")
# the tp dim (of a per-layer leaf) a role needs, by leaf key; None: whole
_ROLE_TP = {
    "col": {**{k: -2 for k in _WEIGHTS}, "scale": -1, "scale4": -2, "bias": -1,
            "lora_b": -2, "lora_a": None},
    "row": {**{k: -1 for k in _WEIGHTS}, "scale": None, "scale4": -1, "bias": None,
            "lora_b": None, "lora_a": -1},
}


def _leaf_path(path: str, key: str) -> str:
    """The tree path of a linear's key; attached LoRA factors live under
    ``lora.`` as A and B (train/lora.py::attach_lora)."""
    if key in ("lora_a", "lora_b"):
        return "lora." + path.split(".", 1)[1] + (".A" if key == "lora_a" else ".B")
    return f"{path}.{key}"


def use_leaf(t: torch.Tensor, path: str, lead: int = 0, mesh=None, tp_dim="keep"):
    """A stored shard as a product needs it: every fsdp dim gathered (the
    backward averages, since the fsdp ranks of an axis run the same rows),
    and the tp dim ``tp_dim`` — "keep" (as stored), None (gathered whole,
    the backward summed) or a dim index (cut there where the leaf is
    stored whole).  ``lead`` counts the leading dims already indexed away
    (a stacked layer's L)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if is_trivial(mesh) or not torch.is_tensor(t) or t.dim() == 0:
        return t
    full = t.dim() + lead
    spec = _full_spec(spec_for(path, full), full)[lead:]
    for dim, axis in enumerate(spec):
        if axis == "fsdp":
            t = C.gather(t, mesh, "fsdp", dim, bwd="mean")
    if tp_dim == "keep":
        return t
    cur = spec.index("tp") if "tp" in spec else None
    want = None if tp_dim is None else tp_dim % t.dim()
    if cur == want:
        return t
    if cur is not None:
        if _layout(path, cur + lead, full, "tp") != "plain":
            raise ValueError(f"{path}: a repacked shard cannot be regathered at use")
        t = C.gather(t, mesh, "tp", cur, bwd="sum")
    if want is None:
        return t
    layout = _layout(path, want + lead, full, "tp")
    if layout == "parts2":
        return torch.cat([C.scatter(h, mesh, "tp", want) for h in t.chunk(2, dim=want)],
                         dim=want)
    if layout == "int4pc":  # integer bytes: no gradient flows here
        return split_dim(t, want, axis_size(mesh, "tp"), axis_index(mesh, "tp"), layout)
    return C.scatter(t, mesh, "tp", want)


def use_linear(p: dict, path: str, role: str, lead: int = 0, mesh=None) -> dict:
    """A linear's leaf dict (``{"weight", "bias", ...}`` or a quantized one)
    as the ``role`` needs it: "col" (out on tp), "row" (in on tp) or "full"
    (tp gathered)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if is_trivial(mesh):
        return p
    out = {}
    for key, t in p.items():
        want = None if role == "full" else _ROLE_TP[role].get(key, None)
        out[key] = use_leaf(t, _leaf_path(path, key), lead, mesh, want)
    return out


def row_linear(x: torch.Tensor, p: dict, path: str, lead: int = 0, linear_fn=None,
               sequence_dim: Optional[int] = None):
    """Row-parallel product: x (this rank's inputs) → the outputs summed over
    tp (reduce-scattered along ``sequence_dim`` under sequence parallelism),
    then the bias, once."""
    from ..utils.params import linear

    fn = linear_fn or linear
    mesh = ambient_mesh()
    if is_trivial(mesh):
        return fn(x, p)
    lp = use_linear(p, path, "row", lead, mesh)
    bias = lp.pop("bias", None)
    y = fn(x, lp)
    if sequence_dim is None:
        y = C.reduce_from_tp(y, mesh)
    else:
        y = C.reduce_scatter(y, mesh, "tp", sequence_dim)
    return y if bias is None else y + bias.to(y.dtype)
