"""The port's last helpers against the JAX package's, and the launchers'
training configs through the port's parser.

``merge_scenes`` (int cuts, ``.get_frames()`` cuts, scene lists over and
under ``max_scene_num``, no scene), ``add_norm`` (rms / layer norm, with
and without a residual, fp32 within 1e-6 and bf16 bitwise after the same
rounding), ``MetricLogger.log_every``'s lines under a scripted clock and
the meters as attributes, ``MetricsWriter``'s JSONL records (equal but for
``ts``), its TensorBoard events where ``torch.utils.tensorboard`` imports
and JSONL alone where it does not, ``close()`` at the end of the port's
``train()``; every training JSON under ``scripts/custom/`` and
``scripts/vllava/*/`` parsed by both packages' ``parse_args`` into the same
fields (the port adds ``device``).
"""
import dataclasses
import glob
import itertools
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_torch import mm_utils as tmm
from streammind_torch.ops import norms as tnorms
from streammind_torch.utils import logging as tlog
from streammind_torch.utils import metrics_writer as tmw
from streammind_tpu import mm_utils as jmm
from streammind_tpu.ops import norms as jnorms
from streammind_tpu.utils import logging as jlog
from streammind_tpu.utils import metrics_writer as jmw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Cut:
    """A PySceneDetect-style cut: its frame behind ``get_frames()``."""

    def __init__(self, frame):
        self.frame = frame

    def get_frames(self):
        return self.frame


SCENES = [(0, 10), (10, 25), (25, 40), (40, 52), (52, 70), (70, 90)]
CUTS = [10, 25, 40, 52, 70]
SCORES = [0.9, 0.2, 0.7, 0.1, 0.5]


@pytest.mark.parametrize("case", ["ints", "get_frames", "over_max", "under_max", "empty"])
def test_merge_scenes_matches_jax(case):
    cuts, scenes, kw = CUTS, SCENES, dict(num_frames=100, max_scene_num=4)
    if case == "get_frames":
        cuts = [_Cut(c) for c in CUTS]
    elif case == "over_max":
        kw = dict(num_frames=90, max_scene_num=2, num_frame_per_scene=5)
    elif case == "under_max":
        cuts, scenes = CUTS[:2], SCENES[:3]
        kw = dict(num_frames=40, max_scene_num=4, num_frame_per_scene=3)
    elif case == "empty":
        cuts, scenes = [], []
        kw = dict(num_frames=33, num_frame_per_scene=6)
    t = tmm.merge_scenes(cuts, SCORES[:len(cuts)], scenes, **kw)
    j = jmm.merge_scenes(cuts, SCORES[:len(cuts)], scenes, **kw)
    assert len(t) == len(j) and len(t) >= 1
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case != "empty":
        ts, tc = tmm.merge_scenes_not_exceed_max_scene_num(cuts, SCORES[:len(cuts)], scenes,
                                                            kw["max_scene_num"])
        assert (ts, tc) == jmm.merge_scenes_not_exceed_max_scene_num(
            cuts, SCORES[:len(cuts)], scenes, kw["max_scene_num"])
        assert len(ts) <= kw["max_scene_num"] and all(isinstance(f, int) for f, _ in tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_add_norm_matches_jax(rms, with_residual, dtype):
    rng = np.random.default_rng(7)
    x, r = (rng.standard_normal((2, 5, 48)).astype(np.float32) for _ in range(2))
    w, b = 1 + 0.1 * rng.standard_normal(48), 0.1 * rng.standard_normal(48)
    w, b = w.astype(np.float32), b.astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    res_t = torch.from_numpy(r) if with_residual else None
    res_j = jnp.asarray(r) if with_residual else None
    bias_t, bias_j = (None, None) if rms else (torch.from_numpy(b), jnp.asarray(b))
    tn, tr = tnorms.add_norm(torch.from_numpy(x).to(tdt), res_t, torch.from_numpy(w), bias_t,
                             eps=1e-6, rms=rms)
    jn, jr = jnorms.add_norm(jnp.asarray(x).astype(jdt), res_j, jnp.asarray(w), bias_j,
                             eps=1e-6, rms=rms)
    assert tn.dtype == tdt and tr.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))  # the fp32 residual: one add
    got, want = tn.float().numpy(), np.asarray(jn.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:  # the same fp32 result rounded once to bf16
        np.testing.assert_array_equal(got, want)


def _scripted_clock(monkeypatch, step=0.75):
    """Both packages' ``time.time`` read one clock that advances ``step`` a call."""
    for mod in (tlog, jlog):
        ticks = itertools.count()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda ticks=ticks: next(ticks) * step))


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.mark.parametrize("sized", [True, False])
def test_log_every_lines_match_jax(monkeypatch, sized):
    _scripted_clock(monkeypatch)
    out = {}
    for name, mod in (("torch", tlog), ("jax", jlog)):
        ml, sink = mod.MetricLogger(), _Lines()
        items = list(range(7)) if sized else iter(range(7))
        for i in ml.log_every(items, 3, logger=sink, header="Epoch: [0]"):
            ml.update(loss=1.0 / (i + 1), lr=1e-3)
        out[name] = sink.lines
        assert ml.loss.count == 7 and ml.lr.global_avg == pytest.approx(1e-3)
        with pytest.raises(AttributeError):
            ml.missing_meter
    assert out["torch"] == out["jax"]
    if sized:  # items 0, 3 and 6 of 7, then the total
        assert [line.split(" eta")[0] for line in out["torch"][:3]] == [
            f"Epoch: [0] [{i}/7]" for i in (0, 3, 6)]
        assert out["torch"][0].startswith("Epoch: [0] [0/7] eta: 0:00:05 ")
    else:  # no length: the total alone
        assert len(out["torch"]) == 1
    assert out["torch"][-1].startswith("Epoch: [0] Total time: 0:00:")


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert all(isinstance(r.pop("ts"), float) for r in recs)
    return recs


def test_metrics_writer_jsonl_matches_jax(tmp_path):
    steps = [(1, {"train/loss": 2.5, "train/grad_norm": np.float32(0.25)}),
             (2, {"train/loss": 2.25, "train/grad_norm": 0.5})]
    writers = {"t": tmw.MetricsWriter(str(tmp_path / "t"), use_tensorboard=False),
               "j": jmw.MetricsWriter(str(tmp_path / "j"), use_tensorboard=False)}
    for w in writers.values():
        for step, metrics in steps:
            w.write(step, metrics)
        w.close()
    t, j = (_records(tmp_path / k / "metrics.jsonl") for k in "tj")
    assert t == j == [{"step": 1, "train/loss": 2.5, "train/grad_norm": 0.25},
                      {"step": 2, "train/loss": 2.25, "train/grad_norm": 0.5}]
    assert os.listdir(tmp_path / "t") == ["metrics.jsonl"]


def _tensorboard_stub():
    # tensorboard's documented switch to its TensorFlow stub (TensorFlow's
    # own import takes ~17 s)
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("notf"))


@pytest.mark.parametrize("tensorboard", ["imports", "missing"])
def test_metrics_writer_tensorboard(tmp_path, monkeypatch, tensorboard):
    if tensorboard == "missing":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    else:
        pytest.importorskip("tensorboard")
        _tensorboard_stub()
    w = tmw.MetricsWriter(str(tmp_path))
    w.write(3, {"train/loss": 1.5})
    w.write(4, {"train/loss": 1.25})
    w.close()
    events = sorted(glob.glob(str(tmp_path / "events.out.tfevents.*")))
    assert [r["train/loss"] for r in _records(tmp_path / "metrics.jsonl")] == [1.5, 1.25]
    if tensorboard == "missing":
        assert w._tb is None and not events
        return
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    assert len(events) == 1
    acc = EventAccumulator(events[0])
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("train/loss")] == [(3, 1.5), (4, 1.25)]


def test_train_closes_its_metrics_writer(tmp_path, monkeypatch):
    """The port's train() closes its writer at the end of the run (one
    llm-stage step on the tiny config), as the JAX package's does."""
    pytest.importorskip("tensorboard")
    _tensorboard_stub()
    from sp_like_tokenizer import SPLikeTokenizer
    from test_train_run import FakeScoreDataset
    from streammind_torch import config as tconfig
    from streammind_torch.train import run as trun
    from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments

    closed = []

    class Recording(tmw.MetricsWriter):
        def close(self):
            closed.append(self.log_dir)
            super().close()

    monkeypatch.setattr(trun, "MetricsWriter", Recording)
    cfg = tconfig.tiny_streammind_config()
    ta = TrainingArguments(output_dir=str(tmp_path), learning_rate=1e-3, bf16=False,
                           save_steps=10, logging_steps=1, max_steps=1, device="cpu")
    state = trun.train(ModelArguments(train_skip_cls=True),
                       DataArguments(score_dataset_train_llm=True, num_workers=1), ta,
                       dataset=FakeScoreDataset(SPLikeTokenizer(), cfg, n=2), cfg=cfg)
    logs = str(tmp_path / "logs")
    assert state.step == 1 and closed == [logs]
    assert glob.glob(os.path.join(logs, "events.out.tfevents.*"))
    assert len(_records(os.path.join(logs, "metrics.jsonl"))) == 1


LAUNCHER_CONFIGS = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "scripts", "custom", "*.json"))
    + glob.glob(os.path.join(REPO, "scripts", "vllava", "*", "*.json")))


def test_launcher_configs_found():
    assert len(LAUNCHER_CONFIGS) >= 8 and any("vllava" in p for p in LAUNCHER_CONFIGS)


@pytest.mark.parametrize("config", LAUNCHER_CONFIGS)
def test_launcher_config_parses_as_jax(config):
    from streammind_torch.train import args as targs
    from streammind_tpu.train import args as jargs

    path = os.path.join(REPO, config)
    t = [dataclasses.asdict(a) for a in targs.parse_args(["--config", path])]
    j = [dataclasses.asdict(a) for a in jargs.parse_args(["--config", path])]
    assert t[2].pop("device") == "cuda"
    assert t == j
    with open(path) as f:
        raw = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
    fields = {k: v for part in t for k, v in part.items()}
    assert {k: fields[k] for k in raw} == raw
