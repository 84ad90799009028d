"""The port's Mixtral (sparse MoE) decoder against the JAX package's, on the CPU.

Every non-sharded case of ``tests/test_moe.py``, each held against the JAX
function on the same inputs: one tiny MoE tree (4 experts, top 2) is made by
the JAX package's init and carried over with ``params_from_numpy``.  The
gathered, dense and grouped dispatches against each other and JAX's
(forward, and the grouped form's gradients), skewed routing, quantized
expert banks (int8, int4 in groups, int4 per channel) whose bytes equal
JAX's and carry over from its tree, ``free_source``, a quantized decode, a StreamSession and a paged
MultiStreamServer over a tiny Mixtral, ``train()`` on the llm and adapter
stages with a resume, the config from a checkpoint directory, and the
router's tie rule.  The three sharded cases of ``test_moe.py`` run in one
spawned gloo world of 4 (``test_torch_parallel.run_world``) on (1,2,2),
(2,1,2) and (1,1,4) meshes against JAX's ``_moe_apply_grouped_sharded`` on
its 2×2×2 and tp-only meshes; the rank-local grouped body is summed over
its ranks in one process.

fp32 throughout.  Tolerances: outputs 2e-5 (the same sums in another
order), gradients 5e-5 (JAX's own test's; the sharded cases' 2e-5), quantized bytes exact.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from test_torch_parallel import moe_world as _moe_world, run_world, save_tree
from test_train_run import FakeScoreDataset
from streammind_tpu.api import _load_config as j_load_config
from streammind_tpu.config import tiny_streammind_config, tiny_text_config
from streammind_tpu.models import mistral as jlm
from streammind_tpu.models.meta import init_streammind_params as j_init
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import StreamSession as JSession
from streammind_tpu.streaming.multistream import MultiStreamServer as JServer
from streammind_tpu.utils import params as jparams
from streammind_tpu.utils.quantize import quantize_text_params as j_quantize
from streammind_torch import config as tconfig
from streammind_torch.api import _load_config as t_load_config
from streammind_torch.models import mistral as tlm
from streammind_torch.parallel import collectives as C
from streammind_torch.parallel import mesh as tmesh
from streammind_torch.parallel import partitioning as tpart
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming import StreamSession as TSession
from streammind_torch.streaming.multistream import MultiStreamServer as TServer
from streammind_torch.train import run as trun
from streammind_torch.train import trainer as ttr
from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from streammind_torch.utils import checkpoint as tckpt
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_torch.utils.params import layer_slice, param_bytes, param_count
from streammind_torch.utils.quantize import quantize_text_params as t_quantize

FP32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
BANKS = ("gate", "up", "down")


def _moe(cfg, num_experts=4, top_k=2):
    return dataclasses.replace(cfg, num_experts=num_experts, num_experts_per_tok=top_k)


def _tree(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = _moe(tiny_text_config()), _moe(tconfig.tiny_text_config())
    jp = jlm.init_text_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, _tree(jp)


def _layer0(jp, tp):
    return jax.tree.map(lambda a: a[0], jp["layers"]), layer_slice(tp["layers"], 0)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dense(x, lt, cfg):
    """The layer's MoE through the dense form over the port's routing."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ lt["router"]["weight"].T, dim=-1)
    topw, topi = tlm.router_top_k(probs, cfg.num_experts_per_tok)
    banks = tuple({"weight": lt["experts"][n]} for n in BANKS)
    out = tlm._moe_apply_dense(xt, banks, cfg, topi, topw / topw.sum(-1, keepdim=True))
    return out.reshape(x.shape)


def _routing(lp_j, xt, cfg):
    """The JAX package's routing of ``xt`` through layer ``lp_j``'s router."""
    probs = jax.nn.softmax(jnp.asarray(xt) @ lp_j["router"]["weight"].T, axis=-1)
    topw, topi = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    return topw / jnp.sum(topw, axis=-1, keepdims=True), topi


def test_init_tree_has_the_jax_layout():
    """Own init for Mixtral and Qwen2 configs: JAX's leaf names and shapes;
    the per-layer init (``layer_fn``) gives the stacked init's shapes."""
    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in shapes(sub, f"{prefix}{key}.").items()}
        return {prefix[:-1]: tuple(tree.shape)}

    for change in (dict(num_experts=4), dict(qkv_bias=True)):
        jcfg = dataclasses.replace(tiny_text_config(), **change)
        tcfg = dataclasses.replace(tconfig.tiny_text_config(), **change)
        jp = jlm.init_text_params(jax.random.PRNGKey(0), jcfg)
        mine = tlm.init_text_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        assert shapes(mine) == shapes(jax.tree.map(np.asarray, jp))
        per_layer = tlm.init_text_params(torch.Generator().manual_seed(0), tcfg, device="cpu",
                                         layer_fn=lambda t: t)
        assert shapes(per_layer) == shapes(mine)
    q = t_quantize(mine, bits=4, scheme="pc")
    q_layers = tlm.init_text_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu",
        layer_fn=lambda t: t_quantize({"layers": t}, bits=4, scheme="pc")["layers"])
    assert shapes(q_layers) == shapes(q)


def test_gather_dispatch_matches_dense(moe):
    """T <= 4 tokens take the per-token gather: equal to the dense form and to
    JAX's gather."""
    jcfg, tcfg, jp, tp = moe
    lj, lt = _layer0(jp, tp)
    x = _x((2, 16, jcfg.hidden_size), 1)
    dense = _dense(torch.from_numpy(x), lt, tcfg)
    for t in (1, 2, 4):
        small = tlm._mlp(torch.from_numpy(x[:1, :t]), lt, tcfg)
        np.testing.assert_allclose(small.numpy(), dense[:1, :t].numpy(), **FP32)
        np.testing.assert_allclose(small.numpy(), np.asarray(jlm._mlp(jnp.asarray(x[:1, :t]),
                                                                      lj, jcfg)), **FP32)


def test_grouped_dispatch_matches_dense(moe):
    """The grouped dispatch (stable sort by expert, one matmul per expert)
    against the dense one and JAX's grouped one: forward and the gradients
    to x and to every bank; _mlp at T 64 takes it."""
    jcfg, tcfg, jp, tp = moe
    lj, lt = _layer0(jp, tp)
    x = _x((2, 32, jcfg.hidden_size), 2)
    xt = x.reshape(-1, jcfg.hidden_size)
    topw, topi = _routing(lj, xt, jcfg)
    tw, ti = torch.from_numpy(np.array(topw)), torch.from_numpy(np.array(topi)).long()
    banks = tuple({"weight": lt["experts"][n]} for n in BANKS)
    dense = tlm._moe_apply_dense(torch.from_numpy(xt), banks, tcfg, ti, tw)
    grouped = tlm._moe_apply_grouped(torch.from_numpy(xt), lt["experts"], tcfg, ti, tw)
    jgrouped = jlm._moe_apply_grouped(jnp.asarray(xt), lj["experts"], jcfg, topi, topw)
    np.testing.assert_allclose(grouped.numpy(), dense.numpy(), **FP32)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(jgrouped), **FP32)
    via_mlp = tlm._mlp(torch.from_numpy(x), lt, tcfg)
    np.testing.assert_allclose(via_mlp.reshape(-1, tcfg.hidden_size).numpy(), dense.numpy(),
                               **FP32)

    def jloss(xt, experts):
        return jnp.sum(jlm._moe_apply_grouped(xt, experts, jcfg, topi, topw) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xt), lj["experts"])
    grads = {}
    for form in ("dense", "grouped"):
        xg = torch.from_numpy(xt).requires_grad_(True)
        ex = {n: lt["experts"][n].clone().requires_grad_(True) for n in BANKS}
        if form == "dense":
            out = tlm._moe_apply_dense(xg, tuple({"weight": ex[n]} for n in BANKS), tcfg, ti, tw)
        else:
            out = tlm._moe_apply_grouped(xg, ex, tcfg, ti, tw)
        (out ** 2).sum().backward()
        grads[form] = [xg.grad] + [ex[n].grad for n in BANKS]
    want = [jg[0]] + [jg[1][n] for n in BANKS]
    for got_d, got_g, w in zip(grads["dense"], grads["grouped"], want):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(w), **GRAD)
        np.testing.assert_allclose(got_g.numpy(), got_d.numpy(), **GRAD)


def test_grouped_dispatch_skewed_routing(moe):
    """Every token on experts {1, 2}: the others' row blocks are empty."""
    jcfg, tcfg, jp, tp = moe
    lj, lt = _layer0(jp, tp)
    T = 16
    xt = _x((T, jcfg.hidden_size), 3)
    topi = np.tile(np.array([[1, 2]], np.int32), (T, 1))
    topw = np.full((T, 2), 0.5, np.float32)
    banks = tuple({"weight": lt["experts"][n]} for n in BANKS)
    ti, tw = torch.from_numpy(topi).long(), torch.from_numpy(topw)
    dense = tlm._moe_apply_dense(torch.from_numpy(xt), banks, tcfg, ti, tw)
    grouped = tlm._moe_apply_grouped(torch.from_numpy(xt), lt["experts"], tcfg, ti, tw)
    want = jlm._moe_apply_dense(jnp.asarray(xt), tuple({"weight": lj["experts"][n]}
                                                       for n in BANKS), jcfg,
                                jnp.asarray(topi), jnp.asarray(topw))
    np.testing.assert_allclose(grouped.numpy(), dense.numpy(), **FP32)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("bits,scheme,leaf", [(8, "group", "w_int8"), (4, "group", "w_int4"),
                                              (4, "pc", "w_int4pc")])
def test_quantized_expert_loading(moe, bits, scheme, leaf):
    """quantize_text_params over the expert banks: bytes and scales equal to
    JAX's; the dense (T 32) and gathered (T 1) forms over the quantized
    banks equal JAX's and each other; the router stays fp32."""
    jcfg, tcfg, jp, tp = moe
    jq = j_quantize(jp, bits=bits, scheme=scheme)
    tq = t_quantize(tp, bits=bits, scheme=scheme)
    for n in BANKS:
        for k, v in jq["layers"]["experts"][n].items():
            assert torch.equal(tq["layers"]["experts"][n][k], torch.from_numpy(np.array(v))), (
                n, k)
    assert leaf in tq["layers"]["experts"]["down"]
    assert tq["layers"]["router"]["weight"].dtype == torch.float32
    # JAX's quantized tree carried over: the same leaves, bytes and counts
    carried = _tree(jq)
    assert torch.equal(carried["layers"]["experts"]["gate"][leaf],
                       tq["layers"]["experts"]["gate"][leaf])
    assert param_count(carried) == param_count(tq) == jparams.param_count(jq)
    assert param_bytes(carried) == param_bytes(tq)
    lj, lt = _layer0(jq, tq)
    x = _x((2, 16, jcfg.hidden_size), 1)
    y = tlm._mlp(torch.from_numpy(x), lt, tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jlm._mlp(jnp.asarray(x), lj, jcfg)), **FP32)
    small = tlm._mlp(torch.from_numpy(x[:1, :1]), lt, tcfg)
    np.testing.assert_allclose(small.numpy(), y[:1, :1].numpy(), **FP32)


def test_quantize_free_source_frees_expert_banks(moe):
    """free_source pops each raw (L, E, F, D) bank out of the input tree."""
    _, tcfg, _, _ = moe
    params = tlm.init_text_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    q = t_quantize(params, bits=8, free_source=True)
    assert not set(BANKS) & set(params["layers"]["experts"])
    assert "w_int8" in q["layers"]["experts"]["gate"]


def test_full_forward_quantized_moe_decode(moe):
    """An int8 Mixtral through text_forward: the whole block (dense over
    quantized banks) and a cached prefill then one-token decode (gathered)
    equal to JAX's; the next-token argmax agrees with full precision."""
    jcfg, tcfg, jp, tp = moe
    jq, tq = j_quantize(jp, bits=8), t_quantize(tp, bits=8)
    ids = np.array([[1, 7, 23, 5]], np.int32)
    full, _ = tlm.text_forward(tp, tcfg, input_ids=torch.from_numpy(ids).long())
    q8, _ = tlm.text_forward(tq, tcfg, input_ids=torch.from_numpy(ids).long())
    jq8, _ = jlm.text_forward(jq, jcfg, input_ids=jnp.asarray(ids))
    np.testing.assert_allclose(q8.numpy(), np.asarray(jq8), **FP32)
    assert int(full[0, -1].argmax()) == int(q8[0, -1].argmax())
    tcache, jcache = tlm.init_kv_cache(tcfg, 1, 32, torch.float32, "cpu"), jlm.init_kv_cache(
        jcfg, 1, 32, jnp.float32)
    _, tcache = tlm.text_forward(tq, tcfg, input_ids=torch.from_numpy(ids).long(), cache=tcache)
    _, jcache = jlm.text_forward(jq, jcfg, input_ids=jnp.asarray(ids), cache=jcache)
    step = np.array([[9]], np.int32)
    tl, _ = tlm.text_forward(tq, tcfg, input_ids=torch.from_numpy(step).long(), cache=tcache)
    jl, _ = jlm.text_forward(jq, jcfg, input_ids=jnp.asarray(step), cache=jcache)
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)


class _Tok:
    bos_token_id = 1
    eos_token_id = 2
    eos_token = "</s>"

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([self.bos_token_id] + [3 + (ord(c) % 200) for c in text][:20])

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def mixtral_engines():
    base = tiny_streammind_config()
    jcfg = base.replace(text=_moe(base.text))
    tbase = tconfig.tiny_streammind_config()
    tcfg = tbase.replace(text=_moe(tbase.text))
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64))
    return jcfg, JEngine(jp, jcfg, **kw), TEngine(_tree(jp), tcfg, device="cpu", **kw)


def test_streaming_session_with_mixtral_decoder(mixtral_engines):
    """A StreamSession over the Mixtral decoder (prefill: grouped; decode:
    gathered): fires and greedy tokens equal to JAX's; then a paged
    MultiStreamServer with two streams firing together (a K = 2 lockstep
    turn: two tokens a step, gathered)."""
    cfg, jeng, teng = mixtral_engines
    rng = np.random.default_rng(4)
    s = cfg.vision.image_size
    frames = rng.standard_normal((5, 1, 3, s, s)).astype(np.float32)
    kw = dict(gate_threshold=2.0, max_new_tokens=4)
    js, ts = JSession(jeng, _Tok(), **kw), TSession(teng, _Tok(), **kw)
    fire = (2, 4)
    jout = [js.process_frame(jnp.asarray(f), force_fire=i in fire) for i, f in enumerate(frames)]
    tout = [ts.process_frame(torch.from_numpy(f), force_fire=i in fire)
            for i, f in enumerate(frames)]
    assert [o is not None for o in tout] == [i in fire for i in range(5)]
    assert tout == jout and ts.turns == js.turns

    outs = []
    for Server, conv in ((JServer, jnp.asarray), (TServer, torch.from_numpy)):
        srv = Server(jeng if Server is JServer else teng, capacity=2, kv_mode="paged",
                     num_pages=32, page_size=8)
        for sid in ("a", "b"):
            srv.add_stream(sid, _Tok(), gate_threshold=-1.0, max_new_tokens=3)
        outs.append(srv.step({"a": conv(frames[0]), "b": conv(frames[1])}))
    assert outs[1]["a"] and outs[1]["b"] and outs[1] == outs[0]


def test_llm_loss_and_expert_grads_match_jax(mixtral_engines):
    """stage1_llm_loss over the Mixtral tree (grouped dispatch under remat):
    the loss and the gradients of the router and every expert bank."""
    from test_torch_train import _batch, _losses, _paths, _to

    cfg = mixtral_engines[0]
    jp = j_init(jax.random.PRNGKey(1), cfg)
    stage1, _, _ = _batch(np.random.default_rng(5), cfg)
    tcfg = mixtral_engines[2].cfg
    jval, jg = jax.jit(jax.value_and_grad(lambda p, b: _losses(cfg, "jax", "auto")["llm"](
        p, b)))(jp, _to(stage1, "jax"))
    tp = _tree(jp)
    leaves = {k: v for k, v in ttr.named_leaves(tp).items()
              if k.startswith("text.layers.") and k.split(".")[2] in ("experts", "router")}
    for v in leaves.values():
        v.requires_grad_(True)
    tval = _losses(tcfg, "torch", "auto")["llm"](tp, _to(stage1, "torch"))
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    jgrads = _paths(jg)
    assert len(leaves) == 4
    for path, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[path]), err_msg=path,
                                   rtol=1e-4, atol=1e-5)


def _args(tmp, stage):
    ma = ModelArguments(train_skip_cls=stage == "llm", tune_mm_mlp_adapter=stage == "adapter")
    da = DataArguments(score_dataset_train_llm=stage == "llm", num_workers=2)
    ta = TrainingArguments(output_dir=str(tmp), learning_rate=1e-3, bf16=False, save_steps=2,
                           logging_steps=1, max_steps=4, resume=True, device="cpu")
    return ma, da, ta


@pytest.mark.parametrize("stage", ["llm", "adapter"])
def test_train_mixtral_and_resume(mixtral_engines, tmp_path, stage):
    """The port's train() over a tiny Mixtral (random from the seed): 4 steps,
    finite losses, checkpoints 2 and 4, a second call resuming at step 4;
    on the adapter stage the expert banks stay bitwise as initialized."""
    tcfg = mixtral_engines[2].cfg
    ds = FakeScoreDataset(SPLikeTokenizer(), mixtral_engines[0])
    args = _args(tmp_path, stage)
    state = trun.train(*args, dataset=ds, cfg=tcfg)
    assert state.step == 4
    with open(os.path.join(str(tmp_path), "logs", "metrics.jsonl")) as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert tckpt.sorted_checkpoints(str(tmp_path)) == [2, 4]
    if stage == "adapter":
        fresh = trun.init_streammind_params(torch.Generator().manual_seed(args[2].seed), tcfg,
                                            device="cpu")
        for n in BANKS:
            assert torch.equal(state.params["text"]["layers"]["experts"][n],
                               fresh["text"]["layers"]["experts"][n])
    assert trun.train(*_args(tmp_path, stage), dataset=ds, cfg=tcfg).step == 4


def test_train_derives_moe_config_from_checkpoint_dir(tmp_path):
    """A directory with a Mixtral config.json gives the same MoE config in
    both packages (what train() and model_init read)."""
    raw = {"model_type": "mixtral", "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 256, "num_local_experts": 4, "num_experts_per_tok": 2}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    cfg = t_load_config(str(tmp_path))
    assert (cfg.text.num_experts, cfg.text.num_experts_per_tok, cfg.text.hidden_size) == (4, 2, 64)
    assert cfg.to_json() == j_load_config(str(tmp_path)).to_json()


@pytest.mark.parametrize("probs", [
    [[0.25, 0.25, 0.25, 0.25]],                  # all tie
    [[0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]],  # ties past the first place, and at it
    [[0.2, 0.2, 0.5, 0.1], [0.0, 0.5, 0.0, 0.5]],  # a tie for the second place; zeros
])
def test_router_ties_go_to_the_lowest_expert(probs):
    """router_top_k against jax.lax.top_k on forced ties: the same values and
    expert ids, ties to the lowest id; and through _moe_mlp with a router
    whose logits tie for every token (bf16 router logits tie often)."""
    p = np.asarray(probs, np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = tlm.router_top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_router_ties_through_the_moe_layer(moe):
    """A router whose rows 1 and 2 are equal: experts 1 and 2 tie for every
    token, and the layer's output equals JAX's in every dispatch."""
    jcfg, tcfg, jp, tp = moe
    lj, lt = _layer0(jp, tp)
    w = np.asarray(lj["router"]["weight"]).copy()
    w[2] = w[1]
    w[[0, 3]] *= 0.01
    lj = dict(lj, router={"weight": jnp.asarray(w)})
    lt = dict(lt, router={"weight": torch.from_numpy(w)})
    x = _x((1, 8, jcfg.hidden_size), 6)
    want = np.asarray(jlm._mlp(jnp.asarray(x), lj, jcfg))
    for got in (tlm._mlp(torch.from_numpy(x), lt, tcfg), _dense(torch.from_numpy(x), lt, tcfg)):
        np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(tlm._mlp(torch.from_numpy(x[:, :2]), lt, tcfg).numpy(),
                               want[:, :2], **FP32)


def test_mesh_dispatch_is_refused(moe):
    """The resolver's guards are JAX's: with no mesh, or a mesh of one
    device, plain banks take the grouped form (the sharded cases below take
    a mesh)."""
    _, tcfg, _, _ = moe
    assert tlm._resolve_moe_dispatch(None, tcfg) == "grouped"
    assert tlm._resolve_moe_dispatch(tmesh.make_mesh(1, 1, 1), tcfg) == "grouped"


# --- expert parallel: the sharded cases of tests/test_moe.py -----------------
def _moe8(top_k=2):
    return _moe(tconfig.tiny_text_config(), 8, top_k), _moe(tiny_text_config(), 8, top_k)


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_world")
    _, jcfg = _moe8()
    _, jcfg1 = _moe8(top_k=1)
    jp8 = jlm.init_text_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    jp1 = jlm.init_text_params(jax.random.PRNGKey(8), jcfg1, jnp.float32)
    lj8 = jax.tree.map(lambda a: a[0], jp8["layers"])
    lj1 = jax.tree.map(lambda a: a[0], jp1["layers"])
    xt = _x((32, jcfg.hidden_size), 6)
    xt10 = _x((10, jcfg.hidden_size), 9)
    topw, topi = _routing(lj8, xt, jcfg)
    topw10, topi10 = _routing(lj1, xt10, jcfg1)
    topi_skew = np.full((32, 2), 5, np.int32)
    topi_skew[:, 1] = 6
    data = dict(xt=xt, topi=np.asarray(topi).astype(np.int64), topw=np.asarray(topw),
                topi_skew=topi_skew.astype(np.int64), topw_skew=np.full((32, 2), 0.5, np.float32),
                xt10=xt10, topi10=np.asarray(topi10).astype(np.int64), topw10=np.asarray(topw10),
                ids=(np.tile(np.arange(16)[None], (2, 1)) % jcfg.vocab_size).astype(np.int64))
    res = run_world(_moe_world, 4, tmp, save_tree(_tree(jp8), tmp / "moe8.pt"),
                    save_tree(_tree(jp1), tmp / "moe8k1.pt"), data)
    return jcfg, jcfg1, jp8, lj8, lj1, data, res


def test_sharded_grouped_dispatch_matches_dense(moe_world):
    """Expert banks split over tp (and fsdp), the rank-local grouped body,
    one all-reduce: forward and gradients (x and every bank) against JAX's
    shard_mapped form on its 2×2×2 mesh and its dense scan; skewed routing
    (every token on one rank's experts); the resolver's guards."""
    from streammind_tpu.parallel import make_mesh as j_make_mesh

    jcfg, _, _, lj, _, d, res = moe_world
    jmesh = j_make_mesh(dp=2, fsdp=2, tp=2)
    banks = tuple({"weight": lj["experts"][n]} for n in BANKS)
    xt, topi, topw = jnp.asarray(d["xt"]), jnp.asarray(d["topi"]), jnp.asarray(d["topw"])
    dense = np.asarray(jlm._moe_apply_dense(xt, banks, jcfg, topi, topw))
    jshard = np.asarray(jlm._moe_apply_grouped_sharded(xt, lj["experts"], jcfg, topi, topw,
                                                       jmesh))

    def jloss(x, experts):
        return jnp.sum(jlm._moe_apply_grouped_sharded(x, experts, jcfg, topi, topw, jmesh) ** 2)

    gx, gex = jax.jit(jax.grad(jloss, argnums=(0, 1)))(xt, lj["experts"])
    skew = np.asarray(jlm._moe_apply_dense(xt, banks, jcfg, jnp.asarray(d["topi_skew"]),
                                           jnp.asarray(d["topw_skew"])))
    for shape in ((1, 2, 2), (2, 1, 2)):
        out, dx, dex = res[("fwd", shape)]
        np.testing.assert_allclose(out, jshard, **FP32)
        np.testing.assert_allclose(out, dense, **FP32)
        np.testing.assert_allclose(dx, np.asarray(gx), **FP32)
        for n in BANKS:
            np.testing.assert_allclose(dex[n], np.asarray(gex[n]), **FP32, err_msg=n)
        np.testing.assert_allclose(res[("skew", shape)], skew, **FP32)
        assert res[("resolve", shape)] == "sharded_grouped"
        assert res[("tight", shape)] == "dense"


def test_sharded_grouped_under_remat_trains(moe_world):
    """text_forward with remat under the mesh, the sharded grouped form
    chosen from the ambient mesh: the loss equals JAX's under its mesh and
    the gradient norm is finite and nonzero."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from streammind_tpu.parallel import make_mesh as j_make_mesh
    from streammind_tpu.parallel import shard_params as j_shard

    jcfg, _, jp8, _, _, d, res = moe_world
    jmesh = j_make_mesh(dp=2, fsdp=2, tp=2)
    with jax.set_mesh(jmesh):
        sharded = j_shard({"text": jp8}, jmesh)["text"]
        ids = jax.device_put(jnp.asarray(d["ids"]), NamedSharding(jmesh, P("dp")))
        want = float(jax.jit(lambda p, i: jnp.mean(
            jlm.text_forward(p, jcfg, input_ids=i, remat=True)[0].astype(jnp.float32) ** 2)
        )(sharded, ids))
    for shape in ((1, 2, 2), (2, 1, 2)):
        loss, gnorm = res[("remat", shape)]
        np.testing.assert_allclose(loss, want, rtol=2e-5)
        assert np.isfinite(gnorm) and gnorm > 0


def test_sharded_grouped_tp_only_mesh(moe_world):
    """A (1,1,4) mesh (JAX: a mesh with only a tp axis), top 1, T 10."""
    from jax.sharding import Mesh

    _, jcfg1, _, _, lj1, d, res = moe_world
    jmesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    banks = tuple({"weight": lj1["experts"][n]} for n in BANKS)
    args = (jnp.asarray(d["xt10"]), jnp.asarray(d["topi10"]), jnp.asarray(d["topw10"]))
    dense = np.asarray(jlm._moe_apply_dense(args[0], banks, jcfg1, *args[1:]))
    jout = np.asarray(jlm._moe_apply_grouped_sharded(args[0], lj1["experts"], jcfg1, *args[1:],
                                                     jmesh))
    np.testing.assert_allclose(res["tp_only"], jout, **FP32)
    np.testing.assert_allclose(res["tp_only"], dense, **FP32)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_local_grouped_bodies_sum_to_grouped(tp):
    """In one process: the tp ranks' ``_moe_grouped_local`` over their E/tp
    banks sum to the one-device grouped dispatch."""
    cfg, _ = _moe8()
    g = torch.Generator().manual_seed(tp)
    tree = tlm.init_text_params(g, cfg, device="cpu")
    ex = {n: tree["layers"]["experts"][n][0] for n in BANKS}
    xt = torch.randn(24, cfg.hidden_size, generator=g)
    probs = torch.softmax(xt @ tree["layers"]["router"]["weight"][0].T, dim=-1)
    topw, topi = tlm.router_top_k(probs, 2)
    topw = topw / topw.sum(-1, keepdim=True)
    whole = tlm._moe_apply_grouped(xt, ex, cfg, topi, topw)
    total = sum(tlm._moe_grouped_local(xt, {n: e.chunk(tp)[r] for n, e in ex.items()}, cfg,
                                       topi, topw, r, tp) for r in range(tp))
    np.testing.assert_allclose(total.numpy(), whole.numpy(), **FP32)
