"""The port's utils/profiling.py and utils/manifest.py against the JAX
package's, on the CPU.

Profiling: the same latency samples give the same summaries (percentiles
by numpy, exact) and the JSONL sink the same records; ``device_trace``
writes a Chrome trace of its block, and ``force_execute`` is a no-op on CPU
tensors.  The tracer's spans and counters: ``tests/test_torch_tracing.py``.
Manifests: every builder's key/shape surface equals JAX's, and the 7B ones
equal the committed ``tests/data/checkpoint_manifest_*.json`` that
chip_smoke.py checks names against (the card's machine has no
``transformers``).
"""
import json
import os

import numpy as np
import pytest
import torch

from streammind_torch.utils import profiling as tprof
from streammind_tpu.utils import profiling as jprof

transformers = pytest.importorskip("transformers")
from streammind_torch.utils import manifest as tman  # noqa: E402
from streammind_tpu.utils import manifest as jman  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


def _samples(n, seed=0):
    return list(np.random.default_rng(seed).exponential(0.02, n))


@pytest.mark.parametrize("n,capacity", [(0, 10), (1, 10), (57, 10000), (300, 100)])
def test_latency_tracker_summary_matches_jax(n, capacity):
    t, j = tprof.LatencyTracker(capacity), jprof.LatencyTracker(capacity)
    for s in _samples(n):
        t.add(s)
        j.add(s)
    assert t.summary() == j.summary() and len(t.samples) == min(n, capacity)
    assert (t.p50, t.p99, t.mean, t.fps()) == (j.p50, j.p99, j.mean, j.fps())


def test_stage_profiler_and_sink_match_jax(tmp_path, monkeypatch):
    clock = iter(np.cumsum(_samples(40, seed=1)))
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    out = {}
    for name, mod in (("torch", tprof), ("jax", jprof)):
        prof = mod.StageProfiler(str(tmp_path / name / "stages.jsonl"))
        for i, s in enumerate(_samples(30, seed=2)):
            prof.add("prefill" if i % 3 else "tick", s)
        out[name] = prof
    tp = out["torch"]
    for _ in range(5):
        with tp.timed("first_token"):
            pass
    want = np.diff(np.cumsum(_samples(40, seed=1))[:10])[::2]
    assert list(tp.stages["first_token"].samples) == list(want)
    jp = out["jax"]
    for s in want:
        jp.add("first_token", s)
    assert tp.summary() == jp.summary()
    for name in ("torch", "jax"):
        out[name].flush({"step": 3})
        out[name].flush()
    rec = [[json.loads(x) for x in (tmp_path / n / "stages.jsonl").read_text().splitlines()]
           for n in ("torch", "jax")]
    for t, j in zip(*rec):
        assert {k: v for k, v in t.items() if k != "ts"} == {k: v for k, v in j.items()
                                                             if k != "ts"}
    assert rec[0][0]["step"] == 3 and "step" not in rec[0][1]
    tprof.StageProfiler().flush()  # no sink: nothing written


def test_device_trace_and_force_execute_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).relu()
        tprof.force_execute({"out": [y], "n": y.sum()})
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert tprof.force_execute(x) is None


@pytest.mark.parametrize("name,kw", [
    ("mistral_lm_manifest", dict(hidden_size=64, intermediate_size=128, num_layers=2,
                                 num_heads=4, num_kv_heads=2, vocab_size=256, head_dim=16)),
    ("clip_vision_manifest", dict(hidden_size=32, intermediate_size=64, num_layers=3,
                                  num_heads=4, image_size=56, patch_size=14)),
    ("projector_manifest", dict(mm_hidden_size=32, hidden_size=64, n_ssm=2, gate_layers=2,
                                gate_hidden=64, gate_intermediate=128, gate_heads=4,
                                gate_kv_heads=2)),
    ("projector_manifest", {}),
])
def test_manifests_match_jax(name, kw):
    assert getattr(tman, name)(**kw) == getattr(jman, name)(**kw)


@pytest.mark.parametrize("name,file", [
    ("full_sft_manifest_7b", "checkpoint_manifest_full_sft_7b.json"),
    ("mm_projector_bin_manifest_7b", "checkpoint_manifest_mm_projector_7b.json"),
])
def test_7b_manifests_match_the_committed_json(name, file):
    with open(os.path.join(DATA, file)) as f:
        committed = json.load(f)
    assert getattr(tman, name)() == committed == getattr(jman, name)()
