"""The port's hybrid decoder (Jamba: Mamba-1 and attention layers, dense
and sparse MLPs) on the paged serving path, on the CPU, against the plain
float32 reference ``portbench/reference/jamba.py``, which transformers'
``JambaForCausalLM`` holds in turn.

Imports torch only (and transformers where a test needs it).  The card's
side (the replayed hybrid step, the scan at the prefill's shapes) is
``tests/test_torch_jamba_gpu.py``, which builds its small decoders here.
"""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from streammind_torch import config as tconfig
from streammind_torch.models import jamba as tjamba
from streammind_torch.models import mistral as tlm
from streammind_torch.models.meta import build_splice_plan, splice_embeds
from streammind_torch.streaming import paged as tpaged
from streammind_torch.utils.profiling import tracer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "portbench"))
from reference import jamba as rjamba  # noqa: E402

VIDEO = -200   # the modal slot of a prompt (VIDEO_TOKEN_INDEX)

# A tiny Jamba: 8 layers (attention at 2 and 6, MoE on the odd layers),
# 4 experts top 2, d_state 16, in HF's config.json keys.
RAW = dict(model_type="jamba", vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=8, num_attention_heads=4, num_key_value_heads=2,
           attn_layer_period=4, attn_layer_offset=2, expert_layer_period=2,
           expert_layer_offset=1, num_experts=4, num_experts_per_tok=2, mamba_d_state=16,
           mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=8, mamba_conv_bias=True,
           mamba_proj_bias=False, rms_norm_eps=1e-6, tie_word_embeddings=False,
           use_mamba_kernels=False)


def hybrid_config(small: bool = False) -> tconfig.HybridTextConfig:
    """The tiny Jamba (``small``: head dim 64 and 8 experts, as the card's
    paged and indexed kernels take)."""
    cfg = tconfig.text_config_from_hf(RAW)
    if small:
        cfg = dataclasses.replace(cfg, vocab_size=512, hidden_size=256, intermediate_size=512,
                                  num_heads=4, num_kv_heads=2, head_dim=64, num_experts=8,
                                  mamba_dt_rank=16)
    return cfg


def hybrid_params(cfg, seed: int = 0):
    """Drawn float32 leaves, unfused (the reference reads q/k/v and gate/up
    apart); the mixers take mamba_ssm's dt init, so states carry over many
    tokens."""
    return tlm.init_text_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def paged(cfg, params, device="cpu", dtype=torch.float32, num_pages=64, page_size=8,
          max_dialogues=4) -> tpaged.PagedDialogues:
    """A page pool over a stand-in engine that holds only what the turn
    programs read (the tree fused as the engine serves it)."""
    eng = SimpleNamespace(params={"text": tlm.fuse_text_linears(params)},
                          cfg=SimpleNamespace(text=cfg), device=torch.device(device),
                          kv_capacity=256, eos_token_id=2)
    return tpaged.PagedDialogues(eng, num_pages=num_pages, page_size=page_size, dtype=dtype,
                                 max_dialogues=max_dialogues)


class Recording(tpaged.PagedDialogues):
    """Keeps the logits each prefill returns and each decode step makes."""

    def _prefill(self, table, length, plans, memory):
        out = super()._prefill(table, length, plans, memory)
        self.seen.append(("prefill", out.clone()))
        return out

    def _decode_step(self, table, length, toks):
        out = super()._decode_step(table, length, toks)
        self.seen.append(("step", out.clone()))
        return out


def run_turn(pd, dids, plans, memories, limits, book):
    """One batched turn, booked per dialogue as (embeddings fed, the
    program's logits at each position whose next token it served)."""
    pd.seen = []
    toks = pd.run_turns(dids, plans, memories, max_new_tokens=limits)
    emb = pd.engine.params["text"]["embed_tokens"]
    prefill = pd.seen[0][1]
    steps = [s for kind, s in pd.seen[1:] if kind == "step"]
    for r, (d, p, mem, t) in enumerate(zip(dids, plans, memories, toks)):
        n = p.length
        x = splice_embeds(pd.engine.params["text"], torch.as_tensor(p.token_ids)[None],
                          torch.as_tensor(p.mem_index)[None], torch.as_tensor(p.use_mem)[None],
                          mem)[0, :n]
        seq = book.setdefault(d, {"x": [], "logits": []})
        base = sum(len(xx) for xx in seq["x"])
        seq["x"] += [x, emb[torch.as_tensor(t, dtype=torch.long)]]
        seq["logits"].append((base + n - 1, prefill[r]))
        for j in range(len(t)):   # the token fed at step j is the j-th served
            seq["logits"].append((base + n + j, steps[j][r]))
    return toks


def reference_logits(params, cfg_raw, seq):
    x = torch.cat(seq["x"])
    at = torch.tensor([p for p, _ in seq["logits"]])
    return rjamba.sequence_logits(params, rjamba.dims(cfg_raw), x, at)


def plans_for(rng, K: int, bucket: int, vocab: int):
    """K prompts of ragged real lengths, each with one memory span, all
    right-padded to one bucket."""
    plans = []
    for r in range(K):
        n_ids = int(rng.integers(2, 6))
        span = int(rng.integers(2, 5))
        ids = [1] + rng.integers(3, vocab, n_ids).tolist() + [VIDEO, 7]
        plans.append(build_splice_plan(ids, [span], VIDEO, bucket))
    return plans


# -- (a) the reference against transformers' Jamba ---------------------------------------------
def _hf_tree(sd: dict, t) -> dict:
    """transformers' JambaForCausalLM state dict in the benchmark's (the
    port's) layout."""
    def st(keys):
        return torch.stack([sd[k] for k in keys])

    kinds = {kind: [i for i, p in enumerate(t.plan) if kind in (p[0], p[2])]
             for kind in ("attention", "mamba", "moe", "mlp")}
    L = range(t.layers)
    lay = {"input_norm": {"weight": st([f"model.layers.{i}.input_layernorm.weight" for i in L])},
           "post_norm": {"weight": st([f"model.layers.{i}.pre_ff_layernorm.weight" for i in L])}}
    for n in "qkvo":
        lay[n] = {"weight": st([f"model.layers.{i}.self_attn.{n}_proj.weight"
                                for i in kinds["attention"]])}

    def mk(name):
        return st([f"model.layers.{i}.mamba.{name}" for i in kinds["mamba"]])

    lay["mamba"] = {"in_proj": {"weight": mk("in_proj.weight")},
                    "conv1d": {"weight": mk("conv1d.weight")[:, :, 0], "bias": mk("conv1d.bias")},
                    "x_proj": {"weight": mk("x_proj.weight")},
                    "dt_proj": {"weight": mk("dt_proj.weight"), "bias": mk("dt_proj.bias")},
                    "A_log": mk("A_log"), "D": mk("D"), "out_proj": {"weight": mk("out_proj.weight")},
                    "dt_norm": {"weight": mk("dt_layernorm.weight")},
                    "b_norm": {"weight": mk("b_layernorm.weight")},
                    "c_norm": {"weight": mk("c_layernorm.weight")}}
    lay["mlp"] = {n: {"weight": st([f"model.layers.{i}.feed_forward.{n}_proj.weight"
                                    for i in kinds["mlp"]])} for n in ("gate", "up", "down")}
    lay["router"] = {"weight": st([f"model.layers.{i}.feed_forward.router.weight"
                                   for i in kinds["moe"]])}
    lay["experts"] = {n: torch.stack([
        st([f"model.layers.{i}.feed_forward.experts.{e}.{n}_proj.weight" for e in range(t.experts)])
        for i in kinds["moe"]]) for n in ("gate", "up", "down")}
    return {"embed_tokens": sd["model.embed_tokens.weight"], "layers": lay,
            "final_norm": {"weight": sd["model.final_layernorm.weight"]},
            "lm_head": {"weight": sd["lm_head.weight"]}}


def test_reference_matches_transformers_jamba():
    """The float32 reference against transformers' JambaForCausalLM (its
    slow path: use_mamba_kernels False) on the tiny config with the same
    seeded weights: fp32 logits within 1e-5 (both sum the same products in
    float32, in other orders; measured 1.8e-7 against logits of 0.6)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    conf = transformers.JambaConfig(**{k: v for k, v in RAW.items() if k != "model_type"})
    hf = transformers.JambaForCausalLM(conf).eval()
    t = rjamba.dims(RAW)
    assert [p[0] for p in t.plan].count("attention") == 2 and t.counts["moe"] == 4
    tree = _hf_tree(hf.state_dict(), t)
    ids = torch.randint(0, RAW["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(ids).logits[0]
        states = []
        got = rjamba.sequence_logits(tree, t, tree["embed_tokens"][ids[0]], torch.arange(40),
                                     states=states)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert len(states) == t.counts["mamba"]


# -- (b) the port's paged path against the reference --------------------------------------------
def test_paged_hybrid_turns_match_the_reference():
    """Three dialogues through ``PagedDialogues.run_turns`` on the tiny
    Jamba in float32: two batched turns each, prompts of ragged real
    lengths right-padded to one bucket, per-row limits so that rows finish
    early, then a reset of one dialogue and a turn from its re-carried
    text.  Every logit the program made for a served token (the prefill's
    and each decode step's) is the reference's over the dialogue's whole
    sequence within 2e-4 (float32 throughout; the two sum in other orders
    and the port's scan and conv take other but equal formulas; measured
    about 1e-6).  A pad folded into a state, or a finished row's state
    stepped on, parts the next turn's logits by far more."""
    cfg = hybrid_config()
    params = hybrid_params(cfg)
    pd = paged(cfg, params)
    pd.__class__ = Recording
    rng = np.random.default_rng(0)
    dids = ["a", "b", "c"]
    for d in dids:
        pd.open(d)
    book = {}
    mem = [torch.randn((1, 6, cfg.hidden_size), generator=torch.Generator().manual_seed(r))
           for r in range(3)]
    with torch.no_grad():
        for limits in ([5, 2, 7], [3, 6, 1]):
            plans = plans_for(rng, 3, 16, cfg.vocab_size)
            assert len({p.length for p in plans}) > 1   # ragged inside the bucket
            run_turn(pd, dids, plans, mem, limits, book)
        pd.reset("b")
        assert pd.lengths["b"] == 0
        book["b"] = {"x": [], "logits": []}
        run_turn(pd, ["b", "c"], plans_for(rng, 2, 16, cfg.vocab_size), mem[1:], [4, 4], book)
        for d in dids:
            want = reference_logits(params, RAW, book[d])
            got = torch.stack([lg for _, lg in book[d]["logits"]])
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4, msg=d)
        assert sum(len(v["logits"]) for v in book.values()) >= 25


def test_pad_and_finished_rows_leave_the_state_alone():
    """(a) A right-padded block leaves a row's state as if its pads had
    never been fed: the Mamba mixer's final state is bitwise the same
    whatever the pads hold, equal to its real tokens' alone (within fp32
    rounding: the products are taken over another number of rows), and
    far from the state at the block's end; a whole padded turn's states
    equal the unpadded turn's to 1e-5.  (b) The lockstep steps after a row
    has finished route it to the sink slot and leave its own slot's state
    bitwise as it was; ``paged.sink_rows`` counts those row-steps."""
    from streammind_torch.models import mamba as tmamba

    cfg = hybrid_config()
    params = hybrid_params(cfg)
    m = cfg.mamba_config()
    bp = tjamba.layer_view(params["layers"], cfg, 0)["mamba"]
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 16, cfg.hidden_size), generator=g)
    other = x.clone()
    other[0, 9:] = torch.randn((7, cfg.hidden_size), generator=g)
    conv0 = torch.randn((2, m.d_inner, m.d_conv), generator=g)
    ssm0 = torch.randn((2, m.d_inner, m.d_state), generator=g)
    real = torch.tensor([9, 16])
    with torch.no_grad():
        runs = [tmamba._mixer_forward(bp, m, xx, "pallas", conv0, ssm0, lengths=real)[1]
                for xx in (x, other)]
        alone = tmamba._mixer_forward(bp, m, x[:1, :9], "pallas", conv0[:1], ssm0[:1])[1]
        at_end = tmamba._mixer_forward(bp, m, x, "pallas", conv0, ssm0)[1]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for got, want, end in zip(runs[0], alone, at_end):
        torch.testing.assert_close(got[:1], want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1:], end[1:], rtol=0, atol=0)
        assert (got[0] - end[0]).abs().max() > 1e-3

    rng = np.random.default_rng(3)
    ids = [1] + rng.integers(3, cfg.vocab_size, 7).tolist()
    mem = torch.zeros((1, 1, cfg.hidden_size))
    states = []
    with torch.no_grad():
        for bucket in (len(ids), 16):
            pd = paged(cfg, params)
            pd.open("a")
            pd.run_turns(["a"], [build_splice_plan(ids, [], VIDEO, bucket)], [mem],
                         max_new_tokens=0)
            states.append(pd.states.gather(torch.tensor([pd.slots["a"]])))
        torch.testing.assert_close(states[1].conv, states[0].conv, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(states[1].ssm, states[0].ssm, rtol=1e-5, atol=1e-6)

        pd = paged(cfg, params)
        for d in ("a", "b"):
            pd.open(d)
        snaps = []
        inner = tpaged.PagedDialogues._decode_step

        def step(self, table, length, toks):
            snaps.append((self._step_slots.tolist(),
                          self.states.gather(torch.tensor([self.slots["a"]]))))
            return inner(self, table, length, toks)

        pd._decode_step = step.__get__(pd)
        tracer.reset()
        tracer.enable()
        try:
            mem = torch.randn((1, 6, cfg.hidden_size), generator=g)
            toks = pd.run_turns(["a", "b"], plans_for(rng, 2, 16, cfg.vocab_size), [mem, mem],
                                max_new_tokens=[2, 6])
            counts = tracer.counters()
        finally:
            tracer.disable()
            tracer.reset()
        final = pd.states.gather(torch.tensor([pd.slots["a"]]))
    fed = len(toks[0])
    assert len(snaps) > fed + 1
    for i, (slots, _) in enumerate(snaps):
        assert slots == [0 if i >= fed else pd.slots["a"], pd.slots["b"]]
    frozen = snaps[fed][1]
    for _, st in snaps[fed:] + [(None, final)]:
        assert torch.equal(st.ssm, frozen.ssm) and torch.equal(st.conv, frozen.conv)
    assert counts["paged.sink_rows"] == len(snaps) - fed > 0


def test_state_slots_open_close_reset():
    """Each open dialogue holds its own slot (slot 0 is the sink); close
    frees it; open and reset zero it and count a state reset; a pool of
    max_dialogues refuses one more."""
    cfg = hybrid_config()
    pd = paged(cfg, hybrid_params(cfg), max_dialogues=2)
    assert len(pd.pool.k) == 2 and pd.states.ssm.shape[:2] == (6, 3)
    tracer.reset()
    tracer.enable()
    try:
        pd.open("a")
        pd.open("b")
        assert sorted(pd.slots.values()) == [1, 2]
        with pytest.raises(ValueError, match="no free state slot"):
            pd.open("c")
        pd.states.ssm[:, pd.slots["a"]] = 1.0
        pd.reset("a")
        assert not pd.states.ssm[:, pd.slots["a"]].any()
        pd.close("b")
        pd.open("c")
        counts = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
    assert counts["paged.state_resets"] == 4 and set(pd.slots) == {"a", "c"}


# -- (c) the router's renormalisation ----------------------------------------------------------
@pytest.mark.parametrize("kind", ["mixtral", "jamba"])
def test_moe_router_renormalises_for_mixtral_only(kind):
    """``_moe_mlp``'s top-2 weights sum to 1 for Mixtral and are the router's
    probabilities as they are for Jamba: one expert bank in which every
    expert is the identity-like same MLP, so the output is that MLP's times
    the weights' sum."""
    cfg = (dataclasses.replace(tconfig.tiny_text_config(), num_experts=4, num_experts_per_tok=2)
           if kind == "mixtral" else hybrid_config())
    g = torch.Generator().manual_seed(2)
    d, f = cfg.hidden_size, cfg.intermediate_size
    one = [torch.randn((f, d), generator=g) * 0.1, torch.randn((f, d), generator=g) * 0.1,
           torch.randn((d, f), generator=g) * 0.1]
    lp = {"router": {"weight": torch.randn((4, d), generator=g) * 0.05},
          "experts": {n: w[None].expand(4, *w.shape).contiguous()
                      for n, w in zip(("gate", "up", "down"), one)}}
    x = torch.randn((1, 6, d), generator=g)
    with torch.no_grad():
        got = tlm._moe_mlp(x, lp, cfg)
        h = torch.nn.functional.silu(x @ one[0].T) * (x @ one[1].T) @ one[2].T
        probs = torch.softmax((x[0] @ lp["router"]["weight"].T).float(), dim=-1)
        top2 = probs.sort(dim=-1, descending=True).values[:, :2].sum(-1)
    scale = torch.ones_like(top2) if kind == "mixtral" else top2
    assert cfg.norm_topk_prob is (kind == "mixtral")
    torch.testing.assert_close(got[0], h[0] * scale[:, None], rtol=1e-5, atol=1e-6)
    assert (top2 < 0.999).all()


# -- (d) the dense-ring paths refuse a hybrid ----------------------------------------------------
def test_dense_ring_paths_refuse_a_hybrid_decoder():
    """``StreamSession`` and ``MultiStreamServer(kv_mode="dense")`` raise
    ``ValueError`` on a hybrid decoder before any frame; the paged server
    takes it, with a state slot a stream; ``text_forward`` refuses it."""
    from streammind_torch.streaming.engine import StreamSession
    from streammind_torch.streaming.multistream import MultiStreamServer

    cfg = tconfig.tiny_streammind_config().replace(text=hybrid_config())
    eng = SimpleNamespace(cfg=cfg, params={"text": hybrid_params(cfg.text)},
                          device=torch.device("cpu"), kv_capacity=256)
    with pytest.raises(ValueError, match="hybrid decoder"):
        StreamSession(eng, tokenizer=None)
    with pytest.raises(ValueError, match="hybrid decoder"):
        MultiStreamServer(eng, capacity=2, kv_mode="dense")
    with pytest.raises(ValueError, match="hybrid decoder"):
        tlm.text_forward(eng.params["text"], cfg.text, input_ids=torch.zeros((1, 2), dtype=int))


# -- the configuration ---------------------------------------------------------------------------
def test_jamba_config_from_hf_and_json():
    """``text_config_from_hf`` reads Jamba2-Mini's config.json keys into the
    layer layout (attention at i % 8 == 4, MoE on odd layers, no rope, no
    renormalisation), and the StreamMind config's JSON carries it back."""
    raw = {"model_type": "jamba", "attn_layer_offset": 4, "attn_layer_period": 8,
           "expert_layer_offset": 1, "expert_layer_period": 2, "hidden_size": 4096,
           "intermediate_size": 14336, "mamba_conv_bias": True, "mamba_d_conv": 4,
           "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
           "mamba_proj_bias": False, "max_position_embeddings": 262144,
           "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
           "num_hidden_layers": 32, "num_key_value_heads": 8, "rms_norm_eps": 1e-06,
           "tie_word_embeddings": False, "vocab_size": 65536}
    cfg = tconfig.text_config_from_hf(raw)
    assert cfg.hybrid and not cfg.use_rope and not cfg.norm_topk_prob
    assert [i for i in range(32) if cfg.is_attention(i)] == [4, 12, 20, 28]
    assert [i for i in range(32) if cfg.is_moe(i)] == list(range(1, 32, 2))
    assert tjamba.layer_counts(cfg) == {"attention": 4, "mamba": 28, "moe": 16, "mlp": 16}
    m = cfg.mamba_config()
    assert (m.d_inner, m.dt_rank_, m.d_state, m.layer_norm_eps) == (8192, 256, 16, 1e-6)
    full = tconfig.StreamMindConfig().replace(text=cfg)
    assert tconfig.StreamMindConfig.from_json(full.to_json()) == full
    plain = tconfig.mixtral_8x7b()
    assert not plain.hybrid and plain.use_rope and plain.norm_topk_prob
    assert "use_rope" not in dataclasses.asdict(plain)
