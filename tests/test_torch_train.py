"""The port's training path against the JAX package's, on the CPU.

One tiny StreamMind tree is made by the JAX package's init and carried over
with ``params_from_numpy``; both packages then get the same numpy batches.
Held equal: the three losses and their trainable-leaf gradients, the freeze
masks, three optimizer steps against optax (clip, projector learning rate,
weight decay, a warm-up whose first update has lr 0), the sampler's order,
the microbatch builder, and checkpoints written by either package and read
by the other.  Then the port's own ``train()`` for each stage.  JAX's
``train()`` is not called (its own tests of it are marked slow).

fp32 throughout.  Tolerances: losses 1e-5 relative; gradients and params
after three steps 1e-5 + 1e-4·|ref| (the same sums in another order,
compounded over a few layers); everything else exact.
"""
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from test_train_run import FakeScoreDataset
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.data.preprocess import build_score_sample as j_build_score_sample
from streammind_tpu.models.meta import build_splice_plan
from streammind_tpu.models.meta import init_streammind_params as j_init
from streammind_tpu.train import objectives as jobj
from streammind_tpu.train import run as jrun
from streammind_tpu.train import trainer as jtr
from streammind_tpu.train.sampler import LengthGroupedSampler as JSampler
from streammind_tpu.utils import checkpoint as jckpt
from streammind_torch import config as tconfig
from streammind_torch.constants import VIDEO_TOKEN_INDEX
from streammind_torch.data.preprocess import build_score_sample
from streammind_torch.train import objectives as tobj
from streammind_torch.train import run as trun
from streammind_torch.train import trainer as ttr
from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from streammind_torch.train.sampler import LengthGroupedSampler as TSampler
from streammind_torch.utils import checkpoint as tckpt
from streammind_torch.utils.from_jax import params_from_numpy

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def trees():
    jcfg = tiny_streammind_config()
    tcfg = tconfig.tiny_streammind_config()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


def _port_tree(jp):
    """A fresh carried-over copy (the port trains in place)."""
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _paths(tree, prefix=""):
    """{dotted path: leaf} of a JAX tree, as ``named_leaves`` names the port's."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _paths(sub, prefix + key + ".").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _paths(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _batch(rng, cfg, t=5, n_ids=20):
    """A stage-1 batch: features, a one-slot splice plan, supervised answer."""
    ids = [1] + list(rng.integers(3, cfg.text.vocab_size, n_ids - 2)) + [2]
    ids.insert(4, VIDEO_TOKEN_INDEX)
    labels = [-100] * 10 + ids[10:]
    plan = build_splice_plan(ids, [t], VIDEO_TOKEN_INDEX, 32, labels=labels)
    feats = rng.standard_normal((1, t, 9, cfg.mm_hidden_size)).astype(np.float32)
    arrays = dict(frames=feats, token_ids=plan.token_ids[None], mem_index=plan.mem_index[None],
                  use_mem=plan.use_mem[None], attn_mask=plan.attn_mask[None],
                  labels=plan.labels[None])
    gate = dict(frames=feats, labels=np.array([[0, 0, 1, 0, 1]]),
                mask=np.array([[True, True, True, True, False]]))
    text = dict(token_ids=plan.token_ids[None], attn_mask=plan.attn_mask[None],
                labels=plan.labels[None])
    return arrays, gate, text


def _to(batch, pkg):
    if pkg == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _losses(cfg, pkg, attn):
    obj = jobj if pkg == "jax" else tobj
    return {
        "llm": lambda p, b, **kw: obj.stage1_llm_loss(
            p, cfg, b["frames"], b["token_ids"], b["mem_index"], b["use_mem"], b["attn_mask"],
            b["labels"], remat=True, attn_impl=attn, **kw),
        "text": lambda p, b, **kw: obj.text_only_llm_loss(
            p, cfg, b["token_ids"], b["attn_mask"], b["labels"], attn_impl=attn, **kw),
        "cls": lambda p, b, **kw: obj.stage2_gate_loss(
            p, cfg, b["frames"], b["labels"], b["mask"], **kw),
    }


@pytest.mark.parametrize("loss", ["llm", "text", "cls"])
def test_losses_and_trainable_grads_match_jax(trees, rng, loss):
    """stage1_llm_loss (remat, flash), text_only_llm_loss and
    stage2_gate_loss: value, accumulation weight and every trainable leaf's
    gradient."""
    jcfg, tcfg, jp = trees
    stage1, gate, text = _batch(rng, jcfg)
    batch = {"llm": stage1, "text": text, "cls": gate}[loss]
    stage = "cls" if loss == "cls" else "llm"
    jfn = _losses(jcfg, "jax", "flash!")[loss]
    tfn = _losses(tcfg, "torch", "flash!")[loss]
    (jval, jw), jg = jax.value_and_grad(lambda p: jfn(p, _to(batch, "jax"), with_tokens=True),
                                        has_aux=True)(jp)
    tp = _port_tree(jp)
    mask = ttr.trainable_mask(tp, stage)
    ttr.apply_trainable(tp, mask)
    (tval, tw), tg = ttr.make_grad_step(
        lambda p, b: tfn(p, b, with_tokens=True), mask, has_aux=True)(tp, _to(batch, "torch"))
    np.testing.assert_allclose(float(tval), float(jval), **LOSS)
    assert float(tw) == float(jw) > 0
    jgrads = _paths(jg)
    assert set(tg) == set(ttr.named_leaves(tp, mask)) and len(tg) > 10
    for path, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[path]), err_msg=path, **GRAD)


@pytest.mark.parametrize("stage", ["llm", "adapter", "cls"])
def test_trainable_mask_matches_jax(trees, stage):
    _, _, jp = trees
    jm = _paths(jtr.trainable_mask(jp, stage))
    tp = _port_tree(jp)
    tm = ttr.trainable_mask(tp, stage)
    assert set(ttr.named_leaves(tp, tm)) == {p for p, m in jm.items() if m}
    assert set(ttr.named_leaves(tp)) == set(jm)


@pytest.mark.parametrize("stage", ["llm", "adapter"])
def test_three_optimizer_steps_match_optax(trees, rng, stage):
    """Clip (a limit the first gradients cross), a separate projector
    learning rate, weight decay and the warm-up (first update lr 0): losses,
    grad norms and the trainable params after three steps.  llm goes through
    JAX's make_train_step, adapter through make_split_train_step."""
    jcfg, tcfg, jp = trees
    batch = _batch(rng, jcfg)[0]
    kw = dict(projector_lr=3e-3, weight_decay=0.01, grad_clip=0.05)
    jloss = _losses(jcfg, "jax", "auto")["llm"]
    tloss = _losses(tcfg, "torch", "auto")["llm"]
    jsched = jtr.cosine_schedule(1e-3, 3)
    jmask = jtr.trainable_mask(jp, stage)
    if stage == "llm":
        jopt = jtr.make_optimizer(jsched, jmask, **kw)
        jstate = jtr.init_train_state(jp, jopt)
        jstep = jtr.make_train_step(lambda p, b: jloss(p, b), jopt)
    else:
        jopt = jtr.make_optimizer(jsched, jtr.partition_params(jmask, jmask)[0], **kw)
        jstate = jtr.init_split_train_state(jp, jopt, jmask)
        jstep = jtr.make_split_train_step(lambda p, b: jloss(p, b), jopt, jmask)
    tp = _port_tree(jp)
    tmask = ttr.trainable_mask(tp, stage)
    topt = ttr.make_optimizer(ttr.cosine_schedule(1e-3, 3), **kw)
    tstate = ttr.init_train_state(tp, topt, tmask)
    tstep = ttr.make_train_step(lambda p, b: tloss(p, b), topt, tmask)
    jb, tb = _to(batch, "jax"), _to(batch, "torch")
    assert jsched(0) == ttr.cosine_schedule(1e-3, 3)(0) == 0.0
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **LOSS)
        assert float(jm["grad_norm"]) > kw["grad_clip"]  # the clip is active
    assert tstate.step == int(jstate.step) == 3
    jparams = _paths(jstate.params)
    for path, t in ttr.named_leaves(tstate.params, tmask).items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[path]), err_msg=path,
                                   **GRAD)
    frozen = set(ttr.named_leaves(tp)) - set(ttr.named_leaves(tp, tmask))
    assert frozen and all(np.array_equal(ttr.named_leaves(tstate.params)[p].numpy(),
                                         np.asarray(jparams[p])) for p in frozen)


@pytest.mark.parametrize("modal", [False, True])
def test_sampler_order_matches_jax(modal):
    rng = np.random.default_rng(4)
    lengths = [int(x) for x in rng.integers(1, 300, 23)]
    if modal:
        lengths = [-n if i % 3 == 0 else n for i, n in enumerate(lengths)]
    kw = dict(batch_size=2, world_size=3, lengths=lengths, seed=11, group_by_modality=modal)
    js, ts = JSampler(23, **kw), TSampler(23, **kw)
    for epoch in range(3):
        assert ts.epoch_indices(epoch) == js.epoch_indices(epoch)
    assert (TSampler(23, seed=5).epoch_indices(1) == JSampler(23, seed=5).epoch_indices(1))


@pytest.mark.parametrize("caption", ["a goal is scored", "</s>"])
def test_build_score_sample_matches_jax(caption):
    """The copied prompt/label construction, speech and silence."""
    j = j_build_score_sample(caption, "v.mkv", 1, 12.5, SPLikeTokenizer(), past_review_caption="x y")
    t = build_score_sample(caption, "v.mkv", 1, 12.5, SPLikeTokenizer(), past_review_caption="x y")
    assert set(t) == set(j)
    for k in j:
        assert np.array_equal(np.asarray(t[k]), np.asarray(j[k])), k


def _sft_records(cfg):
    """A media SFT record (pixels, one <video> slot) and a text-only one."""
    rng = np.random.default_rng(2)
    ids = [1, 5, 6, VIDEO_TOKEN_INDEX, 7, 8, 9, 2]
    video = rng.standard_normal((3, 3, cfg.vision.image_size, cfg.vision.image_size))
    media = {"input_ids": np.array([ids]), "labels": np.array([[-100] * 5 + ids[5:]]),
             "modal": "VIDEO", "video": video.astype(np.float32)}
    text = {"input_ids": np.array([[1, 11, 12, 13, 2]]),
            "labels": np.array([[-100, -100, 12, 13, 2]]), "modal": None}
    return [media], [text, text]


@pytest.mark.parametrize("stage", ["llm", "cls", "sft_media", "sft_text"])
def test_make_microbatch_matches_jax(trees, stage):
    """Score samples (pixels through the frozen ViT, frame buckets, a padded
    third row) and SFT records: every array of the stacked microbatch."""
    jcfg, tcfg, jp = trees
    if stage.startswith("sft"):
        media, text = _sft_records(jcfg)
        samples, stage = (media if stage == "sft_media" else text), "llm"
    else:
        samples = FakeScoreDataset(SPLikeTokenizer(), jcfg, n=2).samples
    jkind, jb = jrun.make_microbatch(samples, jcfg, jp["vision"], stage, pad_to=3)
    tkind, tb = trun.make_microbatch(samples, tcfg, _port_tree(jp)["vision"], stage, pad_to=3)
    assert tkind == jkind and set(tb) == set(jb)
    for k in tb:
        if k == "frames":
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("adapter_only", [False, True])
def test_checkpoints_cross_between_packages(trees, tmp_path, adapter_only):
    """A checkpoint written by either package loads in the other, bitwise
    (bf16 leaves included); rotation keeps the newest two."""
    _, _, jp = trees
    jtree = dict(jp)
    jtree["text"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp["text"])
    ttree = _port_tree(jtree)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    for step in (1, 2, 3):
        jckpt.save_checkpoint(jroot, step, jtree, adapter_only=adapter_only, keep=2)
        tckpt.save_checkpoint(troot, step, ttree, adapter_only=adapter_only, keep=2)
    assert tckpt.sorted_checkpoints(troot) == jckpt.sorted_checkpoints(jroot) == [2, 3]
    from_jax, _, jmeta = tckpt.load_checkpoint(tckpt.latest_checkpoint(jroot))
    from_port, _, tmeta = jckpt.load_checkpoint(jckpt.latest_checkpoint(troot))
    assert jmeta == {**tmeta, "step": 3} and {k: tmeta[k] for k in jmeta} == jmeta
    want = {k: v for k, v in _paths(jtree).items()
            if not adapter_only or k.startswith("projector.")}
    got_t, got_j = ttr.named_leaves(from_jax), _paths(from_port)
    assert set(got_t) == set(got_j) == set(want)
    for path, ref in want.items():
        ref = np.asarray(ref.astype(jnp.float32))
        assert got_t[path].dtype == (torch.bfloat16 if path.startswith("text.") else torch.float32)
        assert str(got_j[path].dtype) == ("bfloat16" if path.startswith("text.") else "float32")
        np.testing.assert_array_equal(got_t[path].float().numpy(), ref, err_msg=path)
        np.testing.assert_array_equal(np.asarray(got_j[path].astype(jnp.float32)), ref, err_msg=path)


def _args(tmp, stage, **kw):
    ma = ModelArguments(train_skip_cls=stage == "llm", tune_mm_mlp_adapter=stage == "adapter")
    da = DataArguments(score_dataset_train_llm=stage == "llm",
                       score_dataset_train_cls=stage == "cls", num_workers=2)
    ta = TrainingArguments(output_dir=str(tmp), learning_rate=1e-3, bf16=False, save_steps=2,
                           logging_steps=1, max_steps=4, resume=True, device="cpu", **kw)
    return ma, da, ta


@pytest.mark.parametrize("stage", ["llm", "adapter", "cls"])
def test_train_runs_each_stage_and_resumes(trees, tmp_path, monkeypatch, stage):
    """train() for 4 steps of one sample a microbatch and two microbatches a
    step (the accumulation path): finite losses, checkpoints 2 and 4,
    adapter-only for adapter/cls, the frozen leaves untouched, and a second
    call that resumes at step 4 and does nothing."""
    jcfg, tcfg, jp = trees
    applies = []
    real = trun.make_accum_apply

    def counting(*a):
        apply = real(*a)

        def wrapped(*b):
            applies.append(1)
            return apply(*b)
        return wrapped

    monkeypatch.setattr(trun, "make_accum_apply", counting)
    start = _port_tree(jp)
    before = {k: v.clone() for k, v in ttr.named_leaves(start).items()}
    monkeypatch.setattr(trun, "init_streammind_params", lambda *a, **k: start)
    ds = FakeScoreDataset(SPLikeTokenizer(), tcfg)
    attn = {"attn_impl": "flash"} if stage == "adapter" else {}
    state = trun.train(*_args(tmp_path, stage, **attn), dataset=ds, cfg=tcfg)
    assert state.step == 4 and len(applies) == 4
    with open(os.path.join(str(tmp_path), "logs", "metrics.jsonl")) as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert tckpt.sorted_checkpoints(str(tmp_path)) == [2, 4]
    with open(os.path.join(str(tmp_path), "checkpoint-4", "meta.json")) as f:
        assert json.load(f)["adapter_only"] == (stage != "llm")
    mask = ttr.named_leaves(state.params, ttr.trainable_mask(state.params, stage))
    after = ttr.named_leaves(state.params)
    for path, t in after.items():
        if path in mask:
            continue
        if stage == "llm" and path.startswith("projector.cls_net.layers."):
            continue  # train_skip_cls copied decoder layers into the gate
        assert torch.equal(t, before[path]), path
    assert any(not torch.equal(after[p], before[p]) for p in mask)
    monkeypatch.setattr(trun, "init_streammind_params", lambda *a, **k: _port_tree(jp))
    again = trun.train(*_args(tmp_path, stage), dataset=ds, cfg=tcfg)
    assert again.step == 4 and len(applies) == 4


def test_copy_decoder_layers_into_gate_matches_jax(trees):
    jcfg, tcfg, jp = trees
    jout = jrun.copy_decoder_layers_into_gate(jax.tree.map(jnp.copy, jp), jcfg)
    tout = trun.copy_decoder_layers_into_gate(_port_tree(jp), tcfg)
    jpaths = _paths(jout["projector"]["cls_net"])
    for path, t in ttr.named_leaves(tout["projector"]["cls_net"]).items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jpaths[path]), err_msg=path)


@pytest.mark.parametrize("change", [
    dict(training=dict(dp=2)), dict(training=dict(lora_enable=True)),
    dict(model=dict(bits=8)), dict(model=dict(pretrain_mm_mlp_adapter="mm_projector.bin")),
    dict(dataset=None),
])
def test_unported_options_raise(trees, tmp_path, change):
    _, tcfg, _ = trees
    ma, da, ta = _args(tmp_path, "adapter")
    for k, v in change.get("model", {}).items():
        setattr(ma, k, v)
    for k, v in change.get("training", {}).items():
        setattr(ta, k, v)
    ds = change.get("dataset", FakeScoreDataset(SPLikeTokenizer(), tcfg, n=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trun.train(ma, da, ta, dataset=ds, cfg=tcfg)


def test_parse_args_and_stage():
    ma, da, ta = importlib.import_module("streammind_torch.train.args").parse_args(
        ["--tune-mm-mlp-adapter", "true", "--learning-rate", "3e-4", "--device", "cpu",
         "--mm-projector-lr", "1e-3"])
    assert ma.tune_mm_mlp_adapter and ta.learning_rate == 3e-4 and ta.device == "cpu"
    assert ta.mm_projector_lr == 1e-3 and trun._stage_of(ma, da) == "adapter"
    assert TrainingArguments().device == "cuda"
