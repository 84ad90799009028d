"""The decoder's one layer stack over its stores, and the MoE form each
case takes, on the CPU.

(a) Which MoE form a layer runs, over bank kind (plain, int8, group-int4,
per-channel int4), a few tokens (T <= 4, a decode step's) or more, x asked
for a gradient or the call under ``torch.no_grad`` (serving's), and no mesh
or a tp-2 mesh.  The forms are wrapped to record which ran, and the
tracer's ``moe.dense``, ``moe.grouped_int4`` and ``moe.expert_id_reads``
counters are read.  The
per-channel int4 forms need the card, so ``_ids_on_device`` is told the
activations are bf16 on a CUDA device and the kernels' plain versions run.
The tp-2 mesh is stood in for in one process: each rank's share of the
expert banks is cut here, the collectives are identities, and both ranks
run in turn.

(b) The dense ring (``KVCache``) and the page pool give the same logits for
the same tokens: tiny Mistral and tiny Mixtral in fp32, a prefill block
then three one-token steps, the pool's pages crossing a boundary.  1e-4,
as the port's whole forwards are held (sums in another order).  And the
gate LM's one-token tick, whose softmax over one logit is 1, computes no
rotary table.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.models import projector as tproj
from streammind_torch.parallel.mesh import set_mesh
from streammind_torch.streaming import paged as tpaged
from streammind_torch.utils.params import layer_slice
from streammind_torch.utils.profiling import tracer
from streammind_torch.utils.quantize import quantize_text_params as t_quantize

WHOLE = dict(rtol=1e-4, atol=1e-4)
COUNTERS = ("moe.dense", "moe.grouped_int4", "moe.expert_id_reads")
# widths the grouped int4 kernel takes (multiples of 128)
MOE = dict(hidden_size=128, intermediate_size=256, num_experts=8, num_experts_per_tok=2,
           num_layers=1)


@pytest.fixture(scope="module")
def moe_trees():
    """The one-layer Mixtral config and its layer-0 leaves in each bank kind."""
    cfg = dataclasses.replace(tconfig.tiny_text_config(), **MOE)
    tree = tlm.init_text_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    kinds = {"plain": tree,
             "int8": t_quantize(tree, bits=8, scheme="group"),
             "int4 groups": t_quantize(tree, bits=4, scheme="group"),
             "int4 pc": t_quantize(tree, bits=4, scheme="pc")}
    return cfg, {k: layer_slice(t["layers"], 0) for k, t in kinds.items()}


@pytest.fixture
def forms_run(monkeypatch):
    """run(fn): fn()'s MoE forms, in the order they were entered, and the
    counters."""
    ran = []

    def wrap(name, label=None):
        real = getattr(tlm, name)

        def recorded(*a, **kw):
            ran.append(label(*a, **kw) if label else name)
            return real(*a, **kw)
        monkeypatch.setattr(tlm, name, recorded)

    for name in ("_moe_apply_gathered", "_moe_apply_indexed", "_moe_apply_grouped_int4",
                 "_moe_apply_dense"):
        wrap(name)
    wrap("_moe_grouped_local", lambda *a, **kw: f"_moe_grouped_local/tp{a[-1]}")

    def run(fn):
        ran.clear()
        tracer.reset()
        tracer.enable()
        try:
            fn()
            counts = tracer.counters()
        finally:
            tracer.disable()
            tracer.reset()
        return list(ran), {k: counts.get(k, 0) for k in COUNTERS}
    return run


def _stand_in_tp2(monkeypatch, rank: dict):
    """A tp-2 mesh in one process: rank ``rank["index"]``'s half of every
    expert leaf, identity collectives."""
    mesh = object()

    def use_leaf(t, name, lead=0, m=None, tp_dim="keep"):
        if "experts" not in name or tp_dim is None:
            return t
        return t.chunk(2, dim=0 if tp_dim == "keep" else tp_dim)[rank["index"]]

    monkeypatch.setattr(tlm, "is_trivial", lambda m: m is None)
    monkeypatch.setattr(tlm, "axis_size", lambda m, ax: 2 if m is mesh and ax == "tp" else 1)
    monkeypatch.setattr(tlm, "axis_index", lambda m, ax: rank["index"])
    monkeypatch.setattr(tlm, "use_leaf", use_leaf)
    monkeypatch.setattr(tlm, "C", SimpleNamespace(copy_to_tp=lambda t, m: t,
                                                  reduce_from_tp=lambda t, m: t))
    return mesh


GATHERED, INDEXED = ["_moe_apply_gathered"], ["_moe_apply_gathered", "_moe_apply_indexed"]
GROUPED, SHARDED = ["_moe_grouped_local/tp1"], ["_moe_grouped_local/tp2"]
DENSE, INT4 = ["_moe_apply_dense"], ["_moe_apply_grouped_int4"]
HOST_READ, ON_CARD = {"moe.expert_id_reads": 1}, {}

# (bank kind, tokens, grad, mesh) -> (forms, counters besides zeros)
CASES = {
    ("plain", 3, False, "none"): (GATHERED, HOST_READ),
    ("plain", 3, True, "none"): (GATHERED, HOST_READ),
    ("plain", 12, False, "none"): (GROUPED, {}),
    ("plain", 12, True, "none"): (GROUPED, {}),
    ("plain", 3, False, "tp2"): (GATHERED, HOST_READ),
    ("plain", 3, True, "tp2"): (SHARDED, {}),
    ("plain", 12, False, "tp2"): (SHARDED, {}),
    ("plain", 12, True, "tp2"): (SHARDED, {}),
    ("int4 pc", 3, False, "none"): (INDEXED, ON_CARD),
    ("int4 pc", 3, True, "none"): (GATHERED, HOST_READ),
    ("int4 pc", 12, False, "none"): (INT4, {"moe.grouped_int4": 1}),
    ("int4 pc", 12, True, "none"): (DENSE, {"moe.dense": 1}),
    ("int4 pc", 3, False, "tp2"): (GATHERED, HOST_READ),
    ("int4 pc", 3, True, "tp2"): (DENSE, {"moe.dense": 1}),
    ("int4 pc", 12, False, "tp2"): (DENSE, {"moe.dense": 1}),
    ("int4 pc", 12, True, "tp2"): (DENSE, {"moe.dense": 1}),
}
for _kind in ("int8", "int4 groups"):
    for _t, _grad, _mesh in [(t, g, m) for t in (3, 12) for g in (False, True)
                             for m in ("none", "tp2")]:
        big = _t > 4 or (_grad and _mesh == "tp2")
        CASES[(_kind, _t, _grad, _mesh)] = ((DENSE, {"moe.dense": 1}) if big
                                            else (GATHERED, HOST_READ))


@pytest.mark.parametrize("kind,tokens,grad,mesh", sorted(CASES),
                         ids=lambda v: str(v).replace(" ", "-"))
def test_moe_form_table(moe_trees, forms_run, monkeypatch, kind, tokens, grad, mesh):
    """Each case's form and counters, on each rank of the tp-2 mesh."""
    cfg, layers = moe_trees
    lp = layers[kind]
    real = tlm._ids_on_device
    monkeypatch.setattr(tlm, "_ids_on_device", lambda banks, dtype, device, n, lo=0: real(
        banks, torch.bfloat16, torch.device("cuda"), n, lo))
    want_forms, want = CASES[(kind, tokens, grad, mesh)]
    want = {k: want.get(k, 0) for k in COUNTERS}
    x = torch.randn((1, tokens, cfg.hidden_size), generator=torch.Generator().manual_seed(tokens))
    x.requires_grad_(grad)
    rank = {"index": 0}
    ambient = _stand_in_tp2(monkeypatch, rank) if mesh == "tp2" else None
    for r in ((0, 1) if ambient is not None else (0,)):
        rank["index"] = r
        with set_mesh(ambient), torch.set_grad_enabled(grad):
            forms, counts = forms_run(lambda: tlm._moe_mlp(x, lp, cfg))
        assert (forms, counts) == (want_forms, want), r


# ---------------------------------------------------------------------------
# the ring and the pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("experts", [1, 4], ids=["mistral", "mixtral"])
def test_ring_and_pool_give_the_same_logits(experts):
    """Two rows, a 7-token prefill block then three one-token steps: the
    ring's ``text_forward`` and the pool's ``paged_text_forward`` (page 8:
    the third step opens each row's second page)."""
    cfg = dataclasses.replace(tconfig.tiny_text_config(), num_experts=experts)
    params = tlm.init_text_params(torch.Generator().manual_seed(experts), cfg, device="cpu")
    g = torch.Generator().manual_seed(7)
    blocks = [torch.randint(3, cfg.vocab_size, (2, 7), generator=g)] + [
        torch.randint(3, cfg.vocab_size, (2, 1), generator=g) for _ in range(3)]
    cache = tlm.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    pool = tpaged.init_page_pool(cfg, 5, 8, torch.float32, device="cpu")
    table = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    length = torch.zeros((2,), dtype=torch.int32)
    with torch.no_grad():
        for ids in blocks:
            ring, cache = tlm.text_forward(params, cfg, input_ids=ids, cache=cache)
            paged, pool = tpaged.paged_text_forward(params, cfg, pool, table, length,
                                                    input_ids=ids)
            torch.testing.assert_close(paged, ring, **WHOLE)
            length = length + ids.shape[1]
    assert cache.length.tolist() == length.tolist() == [10, 10]


def test_gate_tick_computes_no_rope(monkeypatch):
    """The gate LM over one newest memory token reads only v: no rotary
    table is computed; over two tokens it is."""
    cfg = tconfig.tiny_streammind_config()
    params = {"cls_net": tlm.init_text_params(torch.Generator().manual_seed(0), cfg.gate,
                                              device="cpu")}
    calls = []
    real = tlm.rope_cos_sin
    monkeypatch.setattr(tlm, "rope_cos_sin", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    memory = torch.randn((3, 2, cfg.gate.hidden_size), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tick = tproj.gate_decision_step(params, cfg, memory[:, -1])
        assert tick.shape == (3, 2) and not calls
        tproj.gate_logits(params, cfg, memory)
    assert calls
