"""The grouped int4 MoE dispatch of a prefill, on the CPU.

``_moe_apply_grouped_int4`` (rows sorted by expert through the grouped int4
kernel pair, whose plain version ``int4_grouped_gemm_ref`` runs here) against
the dense dispatch and the JAX package's, over one per-channel int4 tree made
by the JAX package's init and quantizer and carried over: Mixtral's top 2 of 8
renormalised, Jamba's 16 experts with the top-k weights as they are, skewed
routing (every row to one expert, experts with no row), row counts that fill
no tile.  Then which dispatch a MoE layer takes, read from the tracer's
``moe.grouped_int4`` and ``moe.dense`` counters: the grouped form needs the
card, so ``_ids_on_device`` is told the activations are bf16 on a CUDA
device and the plain version runs in the kernel's place.

fp32 throughout: outputs 2e-5 (the products of the integer weights summed in
another order, the scale applied after the sum instead of before it).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_text_config
from streammind_tpu.models import mistral as jlm
from streammind_tpu.utils.quantize import quantize_text_params as j_quantize
from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.ops.int4_grouped_gemm import int4_grouped_gemm, int4_grouped_gemm_ref
from streammind_torch.parallel.mesh import set_mesh
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_torch.utils.params import layer_slice
from streammind_torch.utils.profiling import tracer
from streammind_torch.utils.quantize import quantize_text_params as t_quantize

FP32 = dict(rtol=2e-5, atol=2e-5)
BANKS = ("gate", "up", "down")
# widths the kernel takes (multiples of 128), as Mixtral's and Jamba's do
WIDTHS = dict(hidden_size=128, intermediate_size=256)


def _trees(experts: int, top_k: int = 2):
    """(JAX config, port config, JAX int4-pc tree, the port's copy of it)."""
    change = dict(WIDTHS, num_experts=experts, num_experts_per_tok=top_k)
    jcfg = dataclasses.replace(tiny_text_config(), **change)
    tcfg = dataclasses.replace(tconfig.tiny_text_config(), **change)
    jq = j_quantize(jlm.init_text_params(jax.random.PRNGKey(experts), jcfg, jnp.float32),
                    bits=4, scheme="pc")
    return jcfg, tcfg, jq, params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _trees(8)


@pytest.fixture(scope="module")
def jamba():
    return _trees(16)


def _layer0(jq, tq):
    return jax.tree.map(lambda a: a[0], jq["layers"]), layer_slice(tq["layers"], 0)


def _banks(lp):
    return tuple(tlm._wrap_expert_leaf(lp["experts"][n]) for n in BANKS)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def on_card(monkeypatch):
    """``_ids_on_device`` as on the card with bf16 activations."""
    real = tlm._ids_on_device
    monkeypatch.setattr(tlm, "_ids_on_device", lambda banks, dtype, device, n, lo=0: real(
        banks, torch.bfloat16, torch.device("cuda"), n, lo))


def _counted(fn):
    """fn()'s result and the tracer's MoE dispatch counters over it (the
    kernel's launches are listed too, and stay 0 on the CPU)."""
    tracer.reset()
    tracer.enable()
    try:
        out = fn()
        counts = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
    assert counts["int4_grouped_gemm.launches"] == 0
    return out, {k: counts.get(k, 0) for k in ("moe.grouped_int4", "moe.dense")}


def test_mixtral_prefill_matches_dense_and_jax(mixtral, on_card):
    """Top 2 of 8, renormalised, 37 tokens (74 rows: no tile's multiple):
    the port's ``_moe_mlp`` through the grouped form against its dense
    dispatch and the JAX package's ``_moe_mlp`` over the same int4 tree."""
    jcfg, tcfg, jq, tq = mixtral
    lj, lt = _layer0(jq, tq)
    x = _x((1, 37, WIDTHS["hidden_size"]), 1)
    got, counts = _counted(lambda: tlm._moe_mlp(torch.from_numpy(x), lt, tcfg))
    assert counts == {"moe.grouped_int4": 1, "moe.dense": 0}
    want = np.array(jlm._moe_mlp(jnp.asarray(x), lj, jcfg))
    torch.testing.assert_close(got, torch.from_numpy(want), **FP32)
    xt = torch.from_numpy(x).reshape(37, -1)
    probs = torch.softmax(xt @ lt["router"]["weight"].T, dim=-1)
    topw, topi = tlm.router_top_k(probs, 2)
    dense = tlm._moe_apply_dense(xt, _banks(lt), tcfg, topi, topw / topw.sum(-1, keepdim=True))
    torch.testing.assert_close(got.reshape(37, -1), dense, **FP32)


@pytest.mark.parametrize("tokens", [5, 23, 64])
def test_jamba_experts_match_dense_and_jax(jamba, tokens):
    """16 experts, top 2, the top-k weights as they are (Jamba's router):
    ``_moe_apply_grouped_int4`` against the port's and the JAX package's
    dense dispatch on the same routes."""
    jcfg, tcfg, jq, tq = jamba
    lj, lt = _layer0(jq, tq)
    xt = _x((tokens, WIDTHS["hidden_size"]), tokens)
    probs = torch.softmax(torch.from_numpy(xt) @ lt["router"]["weight"].T, dim=-1)
    topw, topi = tlm.router_top_k(probs, 2)
    got = tlm._moe_apply_grouped_int4(torch.from_numpy(xt), _banks(lt), tcfg, topi, topw)
    dense = tlm._moe_apply_dense(torch.from_numpy(xt), _banks(lt), tcfg, topi, topw)
    torch.testing.assert_close(got, dense, **FP32)
    jbanks = tuple(lj["experts"][n] for n in BANKS)
    want = jlm._moe_apply_dense(jnp.asarray(xt), jbanks, jcfg, jnp.asarray(topi.numpy()),
                                jnp.asarray(topw.numpy()))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **FP32)


@pytest.mark.parametrize("route", ["one expert", "two experts"])
def test_skewed_routing_leaves_experts_empty(jamba, route):
    """Every row to one expert (top 1), or every token to the same two of
    16: the other experts get no row; grouped against dense and JAX's."""
    jcfg, tcfg, jq, tq = jamba
    lj, lt = _layer0(jq, tq)
    T = 19
    xt = torch.from_numpy(_x((T, WIDTHS["hidden_size"]), 7))
    if route == "one expert":
        topi = torch.full((T, 1), 11)
        topw = torch.rand(T, 1, generator=torch.Generator().manual_seed(0))
    else:
        topi = torch.tensor([[13, 2]] * T)
        topw = torch.rand(T, 2, generator=torch.Generator().manual_seed(0))
    got = tlm._moe_apply_grouped_int4(xt, _banks(lt), tcfg, topi, topw)
    dense = tlm._moe_apply_dense(xt, _banks(lt), tcfg, topi, topw)
    torch.testing.assert_close(got, dense, **FP32)
    want = jlm._moe_apply_dense(jnp.asarray(xt.numpy()), tuple(lj["experts"][n] for n in BANKS),
                                jcfg, jnp.asarray(topi.numpy()), jnp.asarray(topw.numpy()))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **FP32)


def test_plain_pair_is_the_dequantized_product(mixtral):
    """``int4_grouped_gemm_ref`` on 37 sorted rows (experts 1 and 6 empty)
    against each row's product with its expert's dequantized weights: gate
    + up as silu(g) * u, down weighted and put back at ``dst``."""
    _, _, _, tq = mixtral
    lt = layer_slice(tq["layers"], 0)
    (gw, gs), (uw, us), (dw, ds) = ((b["w_int4pc"], b["scale"]) for b in _banks(lt))
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(np.sort(rng.choice([0, 2, 3, 4, 5, 7], 37)))
    offsets = torch.searchsorted(ids, torch.arange(9), out_int32=True)
    xs = torch.from_numpy(_x((37, WIDTHS["hidden_size"]), 4))
    h = int4_grouped_gemm(xs, offsets, gw, gs, up=(uw, us))
    dst = torch.from_numpy(rng.permutation(37))
    rw = torch.from_numpy(rng.random(37).astype(np.float32))
    y = int4_grouped_gemm(h, offsets, dw, ds, dst=dst, row_weight=rw)

    def deq(w, s):
        return torch.cat([(w << 4) >> 4, w >> 4], dim=-1).float() * s[:, None]

    for r, e in enumerate(ids.tolist()):
        g, u = xs[r] @ deq(gw[e], gs[e]).T, xs[r] @ deq(uw[e], us[e]).T
        torch.testing.assert_close(h[r], torch.nn.functional.silu(g) * u, **FP32)
        torch.testing.assert_close(y[dst[r]], (h[r] @ deq(dw[e], ds[e]).T) * rw[r], **FP32)
    with pytest.raises(ValueError, match="either up"):
        int4_grouped_gemm(xs, offsets, gw, gs)
    assert torch.equal(int4_grouped_gemm_ref(xs, offsets, gw, gs, up=(uw, us)), h)


# -- which dispatch a MoE layer takes ---------------------------------------------------------
def test_int4pc_prefill_takes_the_grouped_form(mixtral, on_card):
    """Per-channel int4 banks of every expert above 4 tokens: one
    ``moe.grouped_int4`` a layer; at 4 tokens and fewer (decode) neither
    counter moves."""
    _, tcfg, _, tq = mixtral
    for tokens, want in ((12, 1), (4, 0), (1, 0)):
        x = torch.from_numpy(_x((1, tokens, WIDTHS["hidden_size"]), tokens))
        for layer in range(tcfg.num_layers):
            _, counts = _counted(lambda: tlm._moe_mlp(x, layer_slice(tq["layers"], layer), tcfg))
            assert counts == {"moe.grouped_int4": want, "moe.dense": 0}, (tokens, layer)


@pytest.mark.parametrize("scheme", ["int8", "int4 groups", "x requires grad"])
def test_other_prefills_keep_the_dense_form(mixtral, on_card, scheme):
    """int8 and group-int4 banks, and per-channel int4 banks with a gradient
    asked of x, keep the dense dispatch: one ``moe.dense`` a layer."""
    jcfg, tcfg, jq, tq = mixtral
    x = torch.from_numpy(_x((2, 6, WIDTHS["hidden_size"]), 9))
    if scheme == "x requires grad":
        lt = layer_slice(tq["layers"], 0)
        x.requires_grad_(True)
    else:
        float_tree = params_from_numpy(jax.tree.map(np.asarray, jlm.init_text_params(
            jax.random.PRNGKey(8), jcfg, jnp.float32)), "cpu")
        bits, kind = (8, "group") if scheme == "int8" else (4, "group")
        lt = layer_slice(t_quantize(float_tree, bits=bits, scheme=kind)["layers"], 0)
    out, counts = _counted(lambda: tlm._moe_mlp(x, lt, tcfg))
    assert counts == {"moe.grouped_int4": 0, "moe.dense": 1}
    if scheme == "x requires grad":
        out.sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()


def test_a_ranks_share_of_the_banks_keeps_the_dense_form(mixtral, on_card, monkeypatch):
    """Under a tp-2 mesh each rank holds 4 of the 8 int4 banks: the prefill
    takes the dense form over them (one ``moe.dense`` a rank), and the two
    ranks' outputs add up to the whole layer's.  The mesh's collectives are
    stood in for in one process (identity copies; the caller sums)."""
    _, tcfg, _, tq = mixtral
    lt = layer_slice(tq["layers"], 0)
    x = torch.from_numpy(_x((1, 9, WIDTHS["hidden_size"]), 10))
    mesh = object()
    rank = {"index": 0}
    monkeypatch.setattr(tlm, "is_trivial", lambda m: m is not mesh)
    monkeypatch.setattr(tlm, "axis_size", lambda m, ax: 2 if m is mesh and ax == "tp" else 1)
    monkeypatch.setattr(tlm, "axis_index", lambda m, ax: rank["index"])
    monkeypatch.setattr(tlm, "use_leaf", lambda t, name, dim, m, tp_dim=None: (
        t if tp_dim is None else t.chunk(2, dim=tp_dim)[rank["index"]]))
    monkeypatch.setattr(tlm, "C", SimpleNamespace(copy_to_tp=lambda t, m: t,
                                                  reduce_from_tp=lambda t, m: t))
    shares = []
    for r in (0, 1):
        rank["index"] = r
        with set_mesh(mesh):
            out, counts = _counted(lambda: tlm._moe_mlp(x, lt, tcfg))
        assert counts == {"moe.grouped_int4": 0, "moe.dense": 1}
        shares.append(out)
    monkeypatch.undo()
    torch.testing.assert_close(shares[0] + shares[1], tlm._moe_mlp(x, lt, tcfg), **FP32)
