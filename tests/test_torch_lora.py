"""QLoRA and loading a released checkpoint in the port's train(), against
the JAX package on the CPU.

One tiny StreamMind tree is made by the JAX package's init, its decoder
quantized by JAX's ``quantize_text_params`` (int8, or int4 in groups of
64), and carried over with ``params_from_numpy``; LoRA factors are drawn
with numpy from a seed (B non-zero, so that A gets a gradient).  Held
equal: ``linear`` with LoRA over each leaf kind, the QLoRA
``stage1_llm_loss`` and every LoRA and projector gradient, three optimizer
steps against optax, the export merge over a quantized base, ``lora_only``
checkpoints crossing the packages both ways, and the starting tree of
``train()`` from a ``--model-path`` directory plus
``--pretrain-mm-mlp-adapter`` (bitwise).  Then the port's ``train()`` with
``--bits`` and ``--lora-enable``, and with ``--dataset matchtime`` whose
tokenizer is read from the ``--model-path`` directory (a ``tokenizers``
WordLevel tokenizer written there).

fp32 throughout.  Tolerances: losses 1e-5 relative; gradients and params
after three steps 1e-5 + 1e-4·|ref| (LOSS and GRAD of test_torch_train:
the same sums in another order); linear 1e-5 relative; merges 1e-6
relative (one fp32 einsum in another order); everything else bitwise.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from test_torch_convert import _synth_sd, _tiny_manifest
from test_torch_train import GRAD, LOSS, _batch, _paths, _port_tree, _to
from test_train_run import FakeScoreDataset
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models.meta import init_streammind_params as j_init
from streammind_tpu.train import lora as jlora
from streammind_tpu.train import objectives as jobj
from streammind_tpu.train import run as jrun
from streammind_tpu.train import trainer as jtr
from streammind_tpu.train.args import DataArguments as JData
from streammind_tpu.train.args import ModelArguments as JModel
from streammind_tpu.train.args import TrainingArguments as JTraining
from streammind_tpu.utils import checkpoint as jckpt
from streammind_tpu.utils import params as jparams
from streammind_tpu.utils import quantize as jquant
from streammind_torch import config as tconfig
from streammind_torch.models.mistral import fuse_text_linears
from streammind_torch.train import lora as tlora
from streammind_torch.train import objectives as tobj
from streammind_torch.train import run as trun
from streammind_torch.train import trainer as ttr
from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from streammind_torch.utils import checkpoint as tckpt
from streammind_torch.utils import params as tparams
from streammind_torch.utils.from_jax import params_from_numpy

R, ALPHA = 4, 8
SCALE = ALPHA / R


@pytest.fixture(scope="module")
def trees():
    jcfg = tiny_streammind_config()
    return jcfg, tconfig.tiny_streammind_config(), j_init(jax.random.PRNGKey(0), jcfg)


def _np_lora(jtext, seed, b_scale=0.02):
    """LoRA factors at the shapes of JAX's init_lora_params over a float
    decoder (every quantized one has the same), drawn by numpy."""
    rng = np.random.default_rng(seed)
    shapes = jlora.init_lora_params(jax.random.PRNGKey(0), jtext, r=R)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * b_scale).astype(np.float32), shapes)


def _qlora_tree(jp, bits, seed=3):
    """The JAX tree with its decoder quantized and numpy LoRA factors."""
    jtree = dict(jp)
    if bits != 16:
        jtree["text"] = jquant.quantize_text_params(jp["text"], bits=bits)
    jtree["lora"] = jax.tree.map(jnp.asarray, _np_lora(jp["text"], seed))
    return jtree


def _masks(jtree):
    """The trainable masks of both packages' LoRA runs: the projector minus
    the gate, and every LoRA leaf."""
    jmask = jtr.trainable_mask({k: v for k, v in jtree.items() if k != "lora"}, "adapter")
    jmask["lora"] = jax.tree.map(lambda _: True, jtree["lora"])
    return jmask


def _tmask(tp):
    mask = ttr.trainable_mask({k: v for k, v in tp.items() if k != "lora"}, "adapter")
    mask["lora"] = tparams.tree_map(lambda _: True, tp["lora"])
    return mask


def _jloss(cfg, attn):
    def loss(p, b, **kw):
        eff = {**p, "text": jlora.attach_lora(p["text"], p["lora"], SCALE)}
        return jobj.stage1_llm_loss(eff, cfg, b["frames"], b["token_ids"], b["mem_index"],
                                    b["use_mem"], b["attn_mask"], b["labels"], remat=True,
                                    attn_impl=attn, **kw)
    return loss


def _tloss(cfg, attn):
    def loss(p, b, **kw):
        eff = {**p, "text": tlora.attach_lora(p["text"], p["lora"], SCALE)}
        return tobj.stage1_llm_loss(eff, cfg, b["frames"], b["token_ids"], b["mem_index"],
                                    b["use_mem"], b["attn_mask"], b["labels"], remat=True,
                                    attn_impl=attn, **kw)
    return loss


def _trainable_paths(tree):
    return {k: v for k, v in _paths(tree).items() if v is not None}


# ---------------------------------------------------------------------------
# lora.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,scheme", [(16, None), (8, None), (4, "group"), (4, "pc")])
def test_init_lora_params_shapes_and_zero_b(trees, bits, scheme):
    """(L, r, in) A ~ N(0, 0.02) and (L, out, r) zero B at every target, the
    shapes JAX's init gives over the same (maybe quantized) decoder; JAX's
    init does not read per-channel int4 leaves, so theirs are the float
    decoder's shapes."""
    _, _, jp = trees
    jtext = jp["text"] if bits == 16 else jquant.quantize_text_params(
        jp["text"], bits=bits, **({"scheme": scheme} if scheme else {}))
    want = _paths(jlora.init_lora_params(jax.random.PRNGKey(1),
                                         jp["text"] if scheme == "pc" else jtext, r=R))
    ttext = params_from_numpy(jax.tree.map(np.asarray, jtext), "cpu")
    got = ttr.named_leaves(tlora.init_lora_params(torch.Generator().manual_seed(1), ttext, r=R))
    assert set(got) == set(want) and len(got) == 14
    for path, t in got.items():
        assert tuple(t.shape) == tuple(want[path].shape) and t.dtype == torch.float32, path
        if path.endswith(".B"):
            assert not t.any(), path
    a = torch.cat([t.ravel() for p, t in got.items() if p.endswith(".A")])
    assert abs(float(a.std()) - 0.02) < 2e-3 and abs(float(a.mean())) < 1e-3


@pytest.mark.parametrize("kind", ["weight", "w_int8", "w_int4", "w_int4pc"])
def test_linear_with_lora_matches_jax(kind, rng):
    """Base product, then (x Aᵀ) Bᵀ · scale, then the bias, over each leaf kind."""
    w = jnp.asarray(rng.standard_normal((48, 128)).astype(np.float32) * 0.05)
    leaf = {"weight": w} if kind == "weight" else {
        "w_int8": jquant.quantize_linear_weight,
        "w_int4": jquant.quantize_linear_weight_int4,
        "w_int4pc": jquant.quantize_linear_weight_int4_pc,
    }[kind](w)
    leaf = dict(leaf, bias=jnp.asarray(rng.standard_normal(48).astype(np.float32)),
                lora_a=jnp.asarray(rng.standard_normal((R, 128)).astype(np.float32) * 0.02),
                lora_b=jnp.asarray(rng.standard_normal((48, R)).astype(np.float32) * 0.02),
                lora_scale=jnp.float32(SCALE))
    assert kind in leaf
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = np.asarray(jparams.linear(jnp.asarray(x), leaf))
    got = tparams.linear(torch.from_numpy(x), params_from_numpy(jax.tree.map(np.asarray, leaf),
                                                                "cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    bare = {k: v for k, v in leaf.items() if not k.startswith("lora")}
    assert not np.allclose(np.asarray(jparams.linear(jnp.asarray(x), bare)), want)


def test_attach_lora_equals_apply_lora_and_jax(trees, rng):
    """The matmul-time attach and the merged tree give one forward, and the
    port's merged forward is JAX's."""
    from streammind_tpu.models import mistral as jlm
    from streammind_torch.models import mistral as tlm

    jcfg, tcfg, jp = trees
    jl = _np_lora(jp["text"], 5)
    tl = params_from_numpy(jl, "cpu")
    ttext = _port_tree(jp)["text"]
    ids = rng.integers(0, jcfg.text.vocab_size, (1, 12))
    attached, _ = tlm.text_forward(tlora.attach_lora(ttext, tl, SCALE), tcfg.text,
                                   input_ids=torch.from_numpy(ids))
    merged, _ = tlm.text_forward(tlora.apply_lora(ttext, tl, SCALE), tcfg.text,
                                 input_ids=torch.from_numpy(ids))
    base, _ = tlm.text_forward(ttext, tcfg.text, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(attached.numpy(), merged.numpy(), rtol=1e-4, atol=1e-5)
    assert not np.allclose(attached.numpy(), base.numpy(), atol=1e-3)
    jmerged, _ = jlm.text_forward(jlora.apply_lora(jp["text"], jl, SCALE), jcfg.text,
                                  input_ids=jnp.asarray(ids))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="LoRA"):
        fuse_text_linears(tlora.attach_lora(ttext, tl, SCALE))


@pytest.mark.parametrize("bits,scheme", [(8, "group"), (4, "group"), (4, "pc")])
def test_merge_lora_into_params_over_a_quantized_base(trees, bits, scheme):
    """The export merge dequantizes the base (int8, int4 groups, int4 per
    channel) and adds scale · B A: JAX's merged weights, bias kept."""
    _, _, jp = trees
    jtext = jquant.quantize_text_params(jp["text"], bits=bits, scheme=scheme)
    jl = _np_lora(jp["text"], 6)
    want = jlora.merge_lora_into_params({**jp, "text": jtext}, jl, r=R, alpha=ALPHA)["text"]
    ttext = params_from_numpy(jax.tree.map(np.asarray, jtext), "cpu")
    got = tlora.merge_lora_into_params({"text": ttext}, params_from_numpy(jl, "cpu"), r=R,
                                       alpha=ALPHA)["text"]
    wp, gp = _paths(want), ttr.named_leaves(got)
    assert set(gp) == set(wp)
    assert all(k.endswith(".weight") for k in gp if ".q." in k or ".mlp." in k)
    for path, t in gp.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(wp[path]), rtol=1e-6, atol=1e-7,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# the QLoRA loss, gradients and optimizer against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_loss_and_grads_match_jax(trees, rng, bits):
    """stage1_llm_loss over a quantized decoder with LoRA attached (remat;
    the default attention, whose flash form test_torch_train holds): value,
    accumulation weight, and the gradient of every LoRA and projector leaf
    (the gate and the base get none)."""
    jcfg, tcfg, jp = trees
    batch = _batch(rng, jcfg)[0]
    jtree = _qlora_tree(jp, bits)
    jmask = _masks(jtree)
    t, f = jtr.partition_params(jtree, jmask)
    jfn = _jloss(jcfg, "auto")
    (jval, jw), jg = jax.jit(jax.value_and_grad(
        lambda tt: jfn(jtr.combine_params(tt, f), _to(batch, "jax"), with_tokens=True),
        has_aux=True))(t)
    tp = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    mask = _tmask(tp)
    ttr.apply_trainable(tp, mask)
    tfn = _tloss(tcfg, "auto")
    (tval, tw), tg = ttr.make_grad_step(lambda p, b: tfn(p, b, with_tokens=True), mask,
                                        has_aux=True)(tp, _to(batch, "torch"))
    np.testing.assert_allclose(float(tval), float(jval), **LOSS)
    assert float(tw) == float(jw) > 0
    jgrads = _trainable_paths(jg)
    assert set(tg) == set(jgrads) and sum(p.startswith("lora.") for p in tg) == 14
    for path, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[path]), err_msg=path, **GRAD)
        assert path.startswith("projector.") or float(g.abs().max()) > 0, path


def test_three_qlora_optimizer_steps_match_optax(trees, rng):
    """Three steps over an int4 base as train() takes them (JAX: the split
    step over the trainable subtree; the port: requires_grad): losses, grad
    norms, every trainable leaf after, the base and the gate bitwise."""
    jcfg, tcfg, jp = trees
    batch = _batch(rng, jcfg)[0]
    jtree = _qlora_tree(jp, 4)
    jmask = _masks(jtree)
    kw = dict(projector_lr=3e-3, weight_decay=0.01, grad_clip=0.05)
    jopt = jtr.make_optimizer(jtr.cosine_schedule(1e-3, 3),
                              jtr.partition_params(jmask, jmask)[0], **kw)
    jstate = jtr.init_split_train_state(jtree, jopt, jmask)
    jstep = jax.jit(jtr.make_split_train_step(_jloss(jcfg, "auto"), jopt, jmask))
    tp = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    tmask = _tmask(tp)
    topt = ttr.make_optimizer(ttr.cosine_schedule(1e-3, 3), **kw)
    tstate = ttr.init_train_state(tp, topt, tmask)
    tstep = ttr.make_train_step(_tloss(tcfg, "auto"), topt, tmask)
    jb, tb = _to(batch, "jax"), _to(batch, "torch")
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LOSS)
    want = _paths(jstate.params)
    trainable = ttr.named_leaves(tstate.params, tmask)
    for path, t in trainable.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[path]), err_msg=path,
                                   **GRAD)
    frozen = set(ttr.named_leaves(tp)) - set(trainable)
    assert any(".w_int4" in p for p in frozen)
    for p in frozen:
        assert np.array_equal(ttr.named_leaves(tstate.params)[p].numpy(), np.asarray(want[p])), p


# ---------------------------------------------------------------------------
# train(): --bits, --lora-enable, --model-path, --pretrain-mm-mlp-adapter
# ---------------------------------------------------------------------------
def _args(tmp, stage="llm", bits=4, lora=True, max_steps=4, **model):
    ma = ModelArguments(bits=bits, tune_mm_mlp_adapter=stage == "adapter", **model)
    da = DataArguments(score_dataset_train_llm=stage == "llm", num_workers=2)
    ta = TrainingArguments(output_dir=str(tmp), learning_rate=1e-3, bf16=False, save_steps=2,
                           logging_steps=1, max_steps=max_steps, resume=True, device="cpu",
                           lora_enable=lora, lora_r=R, lora_alpha=ALPHA)
    return ma, da, ta


def _jargs(ma, da, ta):
    """The same arguments as the JAX package's dataclasses."""
    def same(cls, obj):
        names = cls.__dataclass_fields__
        return cls(**{k: v for k, v in vars(obj).items() if k in names})
    return same(JModel, ma), same(JData, da), same(JTraining, ta)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_train_runs_checkpoints_and_resumes(trees, tmp_path, monkeypatch, bits):
    """train() on the llm stage with --bits and --lora-enable: 4 steps of two
    microbatches, finite losses; the quantized base is JAX's quantization of
    the start tree and stays bitwise (so do the vision tower and the gate);
    every LoRA B moves; checkpoints hold {lora, projector} (lora_only) with
    the optimizer state.  Resumed from checkpoint 2, the last two steps give
    the same bits as the first run's."""
    jcfg, tcfg, jp = trees
    monkeypatch.setattr(trun, "init_streammind_params", lambda *a, **k: _port_tree(jp))
    ds = FakeScoreDataset(SPLikeTokenizer(), tcfg)
    state = trun.train(*_args(tmp_path, bits=bits), dataset=ds, cfg=tcfg)
    assert state.step == 4
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        assert all(np.isfinite(json.loads(line)["train/loss"]) for line in f)
    want_text = _paths(jquant.quantize_text_params(jp["text"], bits=bits))
    after = ttr.named_leaves(state.params)
    start = ttr.named_leaves(_port_tree(jp))
    for path, t in after.items():
        if path.startswith("text."):
            assert np.array_equal(t.numpy(), np.asarray(want_text[path[5:]])), path
        elif path.startswith(("vision.", "projector.cls_net.")):
            assert torch.equal(t, start[path]), path
    b_leaves = [p for p in after if p.startswith("lora.") and p.endswith(".B")]
    assert len(b_leaves) == 7 and all(after[p].abs().max() > 0 for p in b_leaves)
    assert tckpt.sorted_checkpoints(str(tmp_path)) == [2, 4]
    loaded, opt, meta = tckpt.load_checkpoint(str(tmp_path / "checkpoint-4"))
    assert meta["lora_only"] and not meta["adapter_only"] and set(loaded) == {"lora",
                                                                              "projector"}
    assert opt is not None and opt["count"] == {"base": 4}
    for path, t in ttr.named_leaves(loaded).items():
        assert torch.equal(t, after[path]), path

    # resume from checkpoint 2 (its optimizer state restored): the same run
    shutil.rmtree(tmp_path / "checkpoint-4")
    again = trun.train(*_args(tmp_path, bits=bits), dataset=ds, cfg=tcfg)
    assert again.step == 4
    for path, t in ttr.named_leaves(again.params).items():
        assert torch.equal(t, after[path]), path


def test_lora_only_checkpoints_cross_between_packages(trees, tmp_path, monkeypatch):
    """A port lora_only checkpoint reads in the JAX package bitwise; a JAX
    one (with its optax state) resumes in the port: LoRA and projector
    bitwise, its step, and a fresh optimizer (neither reads the other's)."""
    jcfg, tcfg, jp = trees
    monkeypatch.setattr(trun, "init_streammind_params", lambda *a, **k: _port_tree(jp))
    ds = FakeScoreDataset(SPLikeTokenizer(), tcfg)
    state = trun.train(*_args(tmp_path / "t", max_steps=2), dataset=ds, cfg=tcfg)
    loaded, _, meta = jckpt.load_checkpoint(str(tmp_path / "t" / "checkpoint-2"))
    assert meta["lora_only"] and set(loaded) == {"lora", "projector"}
    got = _paths(loaded)
    want = ttr.named_leaves({k: state.params[k] for k in ("lora", "projector")})
    assert set(got) == set(want)
    for path, t in want.items():
        assert np.array_equal(np.asarray(got[path]), t.detach().numpy()), path

    jtree = _qlora_tree(jp, 4, seed=8)
    jroot = str(tmp_path / "j")
    path = jckpt.save_checkpoint(jroot, 3, {"lora": jtree["lora"], "projector": jp["projector"]},
                                 extra={"lora_only": True})
    jmask = _masks(jtree)
    t, _ = jtr.partition_params(jtree, jmask)
    jckpt.save_opt_state(path, jtr.make_optimizer(jtr.cosine_schedule(1e-3, 4),
                                                  jtr.partition_params(jmask, jmask)[0]).init(t))
    resumed = []
    real = trun._resume

    def recording(*a):
        out = real(*a)
        resumed.append((out.step, {k: v.detach().clone()
                                   for k, v in ttr.named_leaves(out.params).items()},
                        out.opt_state))
        return out

    monkeypatch.setattr(trun, "_resume", recording)
    state = trun.train(*_args(jroot, max_steps=4), dataset=ds, cfg=tcfg)
    step, leaves, opt = resumed[0]
    assert step == 3 and state.step == 4 and opt["count"] == {"base": 0}
    for p, v in _paths({"lora": jtree["lora"], "projector": jp["projector"]}).items():
        assert np.array_equal(leaves[p].numpy(), np.asarray(v)), p


class _Start(Exception):
    pass


def _model_dir(tmp_path, jcfg):
    """A released full-SFT directory (every key of the manifest at the tiny
    widths, one .bin, the config) and an mm_projector.bin beside it."""
    d = tmp_path / "StreamMind-tiny"
    d.mkdir()
    torch.save(_synth_sd(_tiny_manifest(jcfg), 11), d / "pytorch_model.bin")
    (d / "streammind_config.json").write_text(jcfg.to_json())
    proj = {k: v for k, v in _synth_sd(_tiny_manifest(jcfg, vision=False), 12).items()
            if k.startswith("model.mm_projector.")}
    torch.save(proj, tmp_path / "mm_projector.bin")
    return str(d), str(tmp_path / "mm_projector.bin")


@pytest.mark.parametrize("stage,bits,lora", [("adapter", 16, False), ("adapter", 8, False),
                                             ("llm", 4, True)])
def test_train_from_model_path_starts_where_jax_does(trees, tmp_path, monkeypatch, stage, bits,
                                                     lora):
    """train() with --model-path (config and weights from the directory) and
    --pretrain-mm-mlp-adapter, with and without --bits: the tree the
    optimizer starts from is JAX's train()'s, bitwise (LoRA factors: same
    shapes, B zero); the checkpoint's config, not a default, sizes it."""
    jcfg, _, _ = trees
    path, proj = _model_dir(tmp_path, jcfg)
    ma, da, ta = _args(tmp_path / "out", stage, bits, lora, model_path=path,
                       pretrain_mm_mlp_adapter=proj)
    starts = {}

    def capture(name, params):
        starts[name] = params
        raise _Start

    monkeypatch.setattr(trun, "init_train_state", lambda p, *a: capture("torch", p))
    monkeypatch.setattr(jrun, "init_split_train_state", lambda p, *a: capture("jax", p))
    ds = FakeScoreDataset(SPLikeTokenizer(), jcfg)
    with pytest.raises(_Start):
        trun.train(ma, da, ta, dataset=ds)
    with pytest.raises(_Start):
        jrun.train(*_jargs(ma, da, ta), dataset=ds)
    got, want = ttr.named_leaves(starts["torch"]), _paths(starts["jax"])
    assert set(got) == set(want)
    assert got["text.embed_tokens"].shape == (jcfg.text.vocab_size, jcfg.text.hidden_size)
    for p, t in got.items():
        ref = np.asarray(want[p])
        assert t.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int8"): torch.int8}[ref.dtype] and t.shape == ref.shape, p
        if p.startswith("lora."):
            assert not p.endswith(".B") or not t.any(), p
        else:
            assert np.array_equal(t.detach().numpy(), ref), p
    # the adapter file, not the directory's projector, sits in the tree
    from streammind_torch.utils.convert import convert_projector, load_state_dict

    tcfg = tconfig.StreamMindConfig.from_json(jcfg.to_json())
    adapter = ttr.named_leaves(convert_projector(load_state_dict(proj), tcfg),
                               prefix="projector.")
    assert all(torch.equal(got[p], t) for p, t in adapter.items())
    assert any(".w_int8" in p for p in got) == (bits == 8)
    assert any(".w_int4" in p for p in got) == (bits == 4)


def test_bits_on_the_llm_stage_without_lora_raises_as_jax_does(trees, tmp_path):
    jcfg, tcfg, _ = trees
    ma, da, ta = _args(tmp_path, "llm", bits=8, lora=False)
    ds = FakeScoreDataset(SPLikeTokenizer(), jcfg, n=2)
    with pytest.raises(NotImplementedError, match="bits<16 freezes the decoder"):
        jrun.train(*_jargs(ma, da, ta), dataset=ds, cfg=jcfg)
    with pytest.raises(NotImplementedError, match="bits<16 freezes the decoder"):
        trun.train(ma, da, ta, dataset=ds, cfg=tcfg)
    ma.bits = 6
    with pytest.raises(ValueError, match="--bits must be 4, 8 or 16"):
        trun.train(ma, da, ta, dataset=ds, cfg=tcfg)


def _write_tokenizer(path, words):
    """A word-level tokenizer, offline: ``tokenizers`` WordLevel saved by
    ``PreTrainedTokenizerFast.save_pretrained``; BOS prepended."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in words:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(path)
    return len(vocab)


def test_train_matchtime_dataset_from_model_path(trees, tmp_path, monkeypatch):
    """--dataset matchtime with --model-path: the tokenizer is read from the
    checkpoint directory (no patched AutoTokenizer), and the QLoRA llm stage
    trains two steps on it; the samples are the JAX dataset's with the same
    tokenizer."""
    from test_torch_data import _make_matchtime_tree

    from streammind_torch import data as tdata
    from streammind_tpu import data as jdata

    jcfg, tcfg, _ = trees
    path, _ = _model_dir(tmp_path, jcfg)
    n = _write_tokenizer(path, "a the goal kick off pass corner half second late event quick "
                               "[INST] [/INST] <<SYS>> <</SYS>> is of to and".split())
    assert n <= jcfg.text.vocab_size
    root = _make_matchtime_tree(tmp_path, n_matches=1)
    s = jcfg.vision.image_size

    def window(self, video_path, start_ts, end_ts):  # the video decoder's place
        k = max(int((end_ts - start_ts) * self.cur_fps) // 60, 1)
        return np.random.default_rng(int(end_ts)).standard_normal((k, 3, s, s)).astype(np.float32)

    built = []

    class Recording(tdata.MatchTimeDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tdata.MatchTimeDataset, "_decode_window", window)
    monkeypatch.setattr(jdata.MatchTimeDataset, "_decode_window", window)
    monkeypatch.setattr(tdata, "MatchTimeDataset", Recording)
    ma, da, ta = _args(tmp_path / "out", "llm", 4, True, max_steps=2, model_path=path)
    da.dataset, da.data_path, da.cur_fps = "matchtime", root, 2.0
    state = trun.train(ma, da, ta)
    assert state.step == 2 and len(built) == 1
    with open(tmp_path / "out" / "logs" / "metrics.jsonl") as f:
        assert all(np.isfinite(json.loads(line)["train/loss"]) for line in f)
    import transformers

    tok = transformers.AutoTokenizer.from_pretrained(path)
    jds = jdata.MatchTimeDataset(root, tok, cur_fps=2.0, seed=ta.seed)
    assert len(built[0]) == len(jds)
    sample = built[0][0]
    assert sample["input_ids"][0, 0] == 1 and (sample["input_ids"] != 0).any()
    for k, v in jds[0].items():
        assert np.array_equal(np.asarray(sample[k]), np.asarray(v)), k
