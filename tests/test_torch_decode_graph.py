"""The lockstep decode step as CUDA graphs (``streaming/paged.py``,
``_StepGraph``) and Mixtral's expert ids kept on the card, on the CPU.

Imports torch only: ``tests/test_torch_kernels_gpu.py`` builds its small
decoders with the helpers here and holds the captured step against the
eager one on the card.  On the CPU no graph is captured; these tests hold
the pieces of the step, the routing between them, the indexed MoE
dispatch's plain version and the conditions that choose the graph.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.models.meta import build_splice_plan
from streammind_torch.ops import int4_matvec as I4
from streammind_torch.parallel import mesh as tmesh
from streammind_torch.streaming import paged as tpaged
from streammind_torch.utils.params import layer_slice
from streammind_torch.utils.profiling import tracer
from streammind_torch.utils.quantize import quantize_text_params

VIDEO = -200   # the modal slot of a prompt (VIDEO_TOKEN_INDEX)


class ShapeOnlyMesh:
    """A mesh that names its axis sizes and nothing else (as
    tests/test_torch_parallel.py builds one for checks made before any
    collective)."""

    mesh_dim_names = tmesh.AXES

    def __init__(self, dp=1, fsdp=1, tp=1):
        self.sizes = (dp, fsdp, tp)

    def size(self, mesh_dim=None):
        return self.sizes[mesh_dim]


# -- small decoders and a paged pool over them -----------------------------------------------
def decoder_config(moe: bool, small: bool = False):
    """The tiny text config (``small``: head dim 64, as the paged kernel
    takes; 8 experts of Mixtral's top 2 when ``moe``)."""
    cfg = tconfig.tiny_text_config()
    if small:
        cfg = dataclasses.replace(cfg, vocab_size=512, hidden_size=256, intermediate_size=512,
                                  num_heads=4, num_kv_heads=2, head_dim=64)
    if moe:
        cfg = dataclasses.replace(cfg, num_experts=8 if small else 4, num_experts_per_tok=2)
    return cfg


def decoder_params(cfg, scheme=None, dtype=torch.float32, device="cpu", seed=0, fuse=True):
    """A drawn tree: ``scheme`` None (float), "int8", "int4pc" or "int4"
    (groups); the float leaves in ``dtype`` (quantized codes and their
    scales as quantized); q/k/v and gate/up fused as the engine serves them."""
    params = tlm.init_text_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    if scheme is not None:
        bits = 8 if scheme == "int8" else 4
        params = quantize_text_params(params, bits=bits,
                                      scheme="pc" if scheme == "int4pc" else "group")

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        keep = key in ("scale", "scale4") or not tree.is_floating_point()
        return (tree if keep else tree.to(dtype)).to(device)

    params = cast(params)
    return tlm.fuse_text_linears(params) if fuse else params


def paged_dialogues(cfg, params, device="cpu", dtype=torch.float32, num_pages=48,
                    page_size=8) -> tpaged.PagedDialogues:
    """A page pool over a stand-in engine that holds only what the turn
    programs read."""
    eng = SimpleNamespace(params={"text": params}, cfg=SimpleNamespace(text=cfg),
                          device=torch.device(device), kv_capacity=256, eos_token_id=2)
    return tpaged.PagedDialogues(eng, num_pages=num_pages, page_size=page_size, dtype=dtype)


def prefilled(pd, K: int, seed: int = 0, prompt: int = 11):
    """K dialogues with ``prompt`` + row ids each in the pool: (table, lengths
    (host ints), the next token of each row)."""
    rng = np.random.default_rng(seed)
    dev = pd.pool.k[0].device
    dids = [f"d{r}" for r in range(K)]
    for r, d in enumerate(dids):
        pd.open(d)
        pd.ensure_capacity(d, prompt + K + 40)
    table = pd._table(dids)
    ids = torch.as_tensor(rng.integers(3, pd.engine.cfg.text.vocab_size, (K, prompt + K)),
                          device=dev)
    with torch.no_grad():
        tpaged.paged_text_forward(pd.engine.params["text"], pd.engine.cfg.text, pd.pool, table,
                                  pd._lengths(dids), input_ids=ids)
    lengths = []
    for r, d in enumerate(dids):
        pd.lengths[d] = prompt + r   # ragged: the row's later ids are overwritten
        lengths.append(pd.lengths[d])
    return table, lengths, ids[:, -1].tolist()


def lengths_tensor(pd, lengths):
    return torch.tensor(lengths, dtype=torch.int32, device=pd.pool.k[0].device)


class CountingRouter:
    """``router_top_k`` patched on the module as the benchmark patches it:
    counts its calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        self.inner = tlm.router_top_k
        monkeypatch.setattr(tlm, "router_top_k", self)

    def __call__(self, probs, k):
        self.calls += 1
        return self.inner(probs, k)


# -- the indexed int4 matvec and MoE dispatch, plain versions ----------------------------------
def test_indexed_int4_matvec_plain_is_the_slice():
    g = torch.Generator().manual_seed(1)
    bank = torch.randint(-128, 128, (5, 24, 32), dtype=torch.int8, generator=g)
    scale = torch.rand((5, 24), generator=g)
    x = torch.randn((1, 64), generator=g)
    ids = torch.tensor([[3, 0], [4, 1]])
    for r in range(2):
        for j in range(2):
            e = ids[r, j:j + 1]
            got = I4.int4_matvec(x, bank, scale, expert=e)
            want = I4.int4_matvec_ref(x, bank[int(e)], scale[int(e)])
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="one int64 id"):
        I4.int4_matvec(x, bank, scale, expert=ids[0])
    with pytest.raises(ValueError, match="one int64 id"):
        I4.int4_matvec(x, bank, scale, expert=ids[0, :1].int())
    with pytest.raises(ValueError, match="indexed bank"):
        I4.int4_matvec(x, bank[0], scale[0], expert=ids[0, :1])


def _moe_layer(dtype):
    cfg = decoder_config(moe=True)
    params = decoder_params(cfg, "int4pc", dtype=dtype)
    lp = layer_slice(params["layers"], 0)
    banks = tuple(tlm._wrap_expert_leaf(lp["experts"][n]) for n in ("gate", "up", "down"))
    return cfg, lp, banks


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_indexed_moe_dispatch_matches_the_host_read_path(K):
    """The indexed dispatch's plain version (the ids' slices through
    ``int4_matvec_ref``) against today's host-read gathered path on a tiny
    int4 Mixtral: bitwise the same slices run one by one, and equal to the
    gathered path (which takes the dequantized product on the CPU) to fp32
    rounding; it reads no id on the host."""
    cfg, lp, banks = _moe_layer(torch.float32)
    xt = torch.randn((K, cfg.hidden_size), generator=torch.Generator().manual_seed(K))
    probs = torch.softmax(xt @ lp["router"]["weight"].T, dim=-1)
    topw, topi = tlm.router_top_k(probs, cfg.num_experts_per_tok)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    tracer.reset()
    tracer.enable()
    try:
        got = tlm._moe_apply_indexed(xt, banks, topi, topw)
        assert tracer.counters()["moe.expert_id_reads"] == 0
        host = tlm._moe_apply_gathered(xt, banks, cfg, topi, topw)
        assert tracer.counters()["moe.expert_id_reads"] == 1
    finally:
        tracer.disable()
        tracer.reset()
    want = []
    for r in range(K):
        y = torch.zeros_like(xt[r])
        for j, e in enumerate(topi[r].tolist()):
            gw, uw, dw = ((b["w_int4pc"][e], b["scale"][e]) for b in banks)
            g = torch.nn.functional.silu(I4.int4_matvec_ref(xt[r][None], *gw))[0]
            u = I4.int4_matvec_ref(xt[r][None], *uw)[0]
            y = y + I4.int4_matvec_ref((g * u)[None], *dw)[0] * topw[r, j]
        want.append(y)
    assert torch.equal(got, torch.stack(want))
    torch.testing.assert_close(got, host, rtol=1e-5, atol=1e-5)


# -- the step in pieces, and the routing between them ------------------------------------------
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_pieces_without_capture_equal_the_forward(moe, monkeypatch):
    """The decode step run piece by piece over the static buffers (routing
    between the pieces, as a replay does) gives ``paged_text_forward``'s
    logits bitwise, and routes each MoE layer once."""
    cfg = decoder_config(moe)
    pd = paged_dialogues(cfg, decoder_params(cfg, "int4pc" if moe else None))
    K = 3
    table, lengths, toks = prefilled(pd, K)
    ids = torch.tensor(toks)[:, None]
    lens = lengths_tensor(pd, lengths)
    with torch.no_grad():
        want = pd._forward(table, lens, ids)
        step = tpaged._StepGraph(pd, K)
        step.load(table, lens, ids)
        router = CountingRouter(monkeypatch)
        got = step.run()
    assert torch.equal(got, want)
    assert router.calls == (cfg.num_layers if moe else 0) == len(step.probs)
    assert all(bool((w.sum(-1) > 0).all()) for w in step.topw)   # the routing was copied in


def test_patched_router_runs_once_a_layer_each_step(monkeypatch):
    """A whole paged Mixtral turn (prefill, then the lockstep decode): a
    ``router_top_k`` patched on the module sees ``layers`` calls in each
    decode step, ``layers × steps`` in all, as the benchmark's route
    recorder needs."""
    cfg = decoder_config(moe=True)
    pd = paged_dialogues(cfg, decoder_params(cfg, "int4pc"))
    router = CountingRouter(monkeypatch)
    per_step = []
    inner = tpaged.PagedDialogues._decode_step

    def counted(self, table, length, toks):
        before = router.calls
        out = inner(self, table, length, toks)
        per_step.append(router.calls - before)
        return out

    monkeypatch.setattr(tpaged.PagedDialogues, "_decode_step", counted)
    dids = ["a", "b", "c"]
    for d in dids:
        pd.open(d)
    plans = [build_splice_plan([1, 5 + r, VIDEO, 7], [3], VIDEO, 16) for r in range(3)]
    memories = [torch.randn((1, 8, cfg.hidden_size), generator=torch.Generator().manual_seed(r))
                for r in range(3)]
    before = router.calls
    toks = pd.run_turns(dids, plans, memories, max_new_tokens=[5, 3, 6])
    assert all(toks) and len(per_step) >= 5
    assert per_step == [cfg.num_layers] * len(per_step)
    assert router.calls - before == cfg.num_layers * (1 + len(per_step))  # and the prefill


# -- where the graph is taken --------------------------------------------------------------------
CUDA = torch.device("cuda")


@pytest.mark.parametrize("moe,scheme,dtype,want", [
    (True, "int4pc", torch.bfloat16, True),
    (False, None, torch.bfloat16, True),
    (False, "int8", torch.bfloat16, True),
    (True, "int8", torch.bfloat16, False),
    (True, None, torch.bfloat16, False),
    (True, "int4", torch.bfloat16, False),
    (True, "int4pc", torch.float32, False),
], ids=["mixtral-int4pc", "dense-bf16", "dense-int8", "mixtral-int8", "mixtral-bf16",
        "mixtral-int4-groups", "mixtral-int4pc-fp32"])
def test_graph_conditions(moe, scheme, dtype, want):
    """The graph is taken on a CUDA device, outside a sharded mesh and
    autograd, and for a MoE decoder only over per-channel int4 banks with
    bf16 activations; everything else runs the eager step."""
    cfg = decoder_config(moe)
    params = decoder_params(cfg, scheme, dtype=dtype)
    with torch.no_grad():   # as in the decode step
        assert tpaged.decode_graphed(CUDA, params, cfg) is want
        assert tpaged.decode_graphed(torch.device("cpu"), params, cfg) is False
        for mesh in (ShapeOnlyMesh(tp=2), ShapeOnlyMesh(dp=2)):
            with tmesh.set_mesh(mesh):
                assert tpaged.decode_graphed(CUDA, params, cfg) is False
        with tmesh.set_mesh(tmesh.make_mesh(1, 1, 1, "cpu")):
            assert tpaged.decode_graphed(CUDA, params, cfg) is want
        with torch.enable_grad():
            assert tpaged.decode_graphed(CUDA, params, cfg) is False


def test_cpu_steps_run_eagerly():
    """On the CPU a paged Mixtral's steps run eagerly: nothing is captured,
    and the counters say so."""
    cfg = decoder_config(moe=True)
    pd = paged_dialogues(cfg, decoder_params(cfg, "int4pc"))
    table, lengths, toks = prefilled(pd, 2)
    tracer.reset()
    tracer.enable()
    try:
        for _ in range(3):
            pd._decode_step(table, lengths_tensor(pd, lengths), toks)
            lengths = [n + 1 for n in lengths]
        counts = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
    assert pd._graphs == {} and "paged.graph_captures" not in counts
    assert counts["paged.graph_replays"] == 0
    assert counts["moe.expert_id_reads"] == 3 * cfg.num_layers


def test_recording_counts_again_on_each_replay():
    """What a captured block counts is collected, not counted, and each
    replay counts it once more; the wrappers' launches come back to what
    they were before the capture."""
    tracer.reset()
    tracer.enable()
    launches = I4.int4_matvec.launches
    try:
        with tracer.recording() as rec:
            tracer.count("moe.expert_id_reads", 0)
            tracer.count("paged.resets", 2)
            I4.int4_matvec.launches += 3
        assert I4.int4_matvec.launches == launches
        assert "paged.resets" not in tracer.counters()
        assert rec.counts == {"moe.expert_id_reads": 0, "paged.resets": 2}
        rec.replay()
        rec.replay()
        counts = tracer.counters()
        assert counts["paged.resets"] == 4 and counts["moe.expert_id_reads"] == 0
        assert counts["int4_matvec.launches"] == 6
    finally:
        I4.int4_matvec.launches = launches
        tracer.disable()
        tracer.reset()
