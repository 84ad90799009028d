"""A two-turn StreamSession in streammind_torch against streammind_tpu.

Both packages get one tiny tree (the JAX package's init, carried over with
params_from_numpy), the same frames and the same forced gate fires; the
greedy tokens of each turn must be identical, the gate probabilities and
the memory ring equal within fp32 tolerance.  Also: export_state/resume
(within the port, and a bf16 session exported by the JAX package), the
KV-capacity guard over many turns, and that importing the port loads
neither jax nor streammind_tpu.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.constants import VIDEO_TOKEN_INDEX
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import StreamSession as JSession
from streammind_tpu.streaming import init_stream_state as j_init_state
from streammind_torch import config as tconfig
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming import StreamSession as TSession
from streammind_torch.utils.from_jax import params_from_numpy

REPO = Path(__file__).resolve().parent.parent
FIRE = (2, 5)      # frames on which the gate is forced to fire
N_FRAMES = 7
PROMPT = [1, 10, 11, VIDEO_TOKEN_INDEX, 12]


class FakeTokenizer:
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
def engines():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64), quantize_gate="int4")
    jeng = JEngine(jp, cfg, **kw)
    teng = TEngine(tp, tconfig.tiny_streammind_config(), device="cpu", **kw)
    return cfg, jeng, teng


def _frames(cfg):
    rng = np.random.default_rng(1)
    s = cfg.vision.image_size
    return rng.standard_normal((N_FRAMES, 1, 3, s, s)).astype(np.float32)


def test_two_turn_session_matches_jax(engines):
    cfg, jeng, teng = engines
    frames = _frames(cfg)
    kw = dict(prompt_ids=list(PROMPT), gate_threshold=2.0, max_new_tokens=6,
              stop_strings=["</s>"])
    js, ts = JSession(jeng, FakeTokenizer(), **kw), TSession(teng, FakeTokenizer(), **kw)
    jout, tout = [], []
    for i, f in enumerate(frames):
        jout.append(js.process_frame(jnp.asarray(f), force_fire=i in FIRE))
        tout.append(ts.process_frame(torch.from_numpy(f), force_fire=i in FIRE))
    assert [o is None for o in tout] == [i not in FIRE for i in range(N_FRAMES)]
    assert tout == jout  # identical greedy tokens in both turns
    assert len(ts.turns) == 2 and ts.turns == js.turns
    np.testing.assert_allclose(ts.state.memory.numpy(), np.asarray(js.state.memory),
                               rtol=2e-5, atol=2e-5)
    assert int(ts.cache.length[0]) == int(js.cache.length[0])
    n = int(ts.cache.length[0])
    np.testing.assert_allclose(ts.cache.k[:, :, :n].numpy(), np.asarray(js.cache.k[:, :, :n]),
                               rtol=1e-4, atol=1e-4)
    assert ts.pending_ids == js.pending_ids and ts.interval_ids == js.interval_ids

    # gate probabilities frame by frame
    jstate, tstate = j_init_state(cfg), teng.new_stream_state()
    for f in frames:
        jprob, jstate = jeng.perceive_step(jnp.asarray(f), jstate)
        tprob, tstate = teng.perceive_step(torch.from_numpy(f), tstate)
        np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-4, atol=1e-5)
        assert abs(float(tprob.sum()) - 1.0) < 1e-6


def test_export_resume_round_trip(engines):
    cfg, _, teng = engines
    frames = _frames(cfg)
    kw = dict(prompt_ids=list(PROMPT), gate_threshold=2.0, max_new_tokens=5)
    a = TSession(teng, FakeTokenizer(), **kw)
    for i in range(4):
        a.process_frame(torch.from_numpy(frames[i]), force_fire=i == 2)
    blob = a.export_state()
    b = TSession.resume(teng, FakeTokenizer(), blob)
    assert b.state.frame_idx == a.state.frame_idx and b.state.last_fire == a.state.last_fire
    assert torch.equal(b.cache.k, a.cache.k) and torch.equal(b.state.memory, a.state.memory)
    for i in range(4, N_FRAMES):
        fire = i == 5
        assert (a.process_frame(torch.from_numpy(frames[i]), force_fire=fire)
                == b.process_frame(torch.from_numpy(frames[i]), force_fire=fire))
    assert a.turns == b.turns and torch.equal(a.state.mamba.ssm, b.state.mamba.ssm)


def test_kv_capacity_guard_matches_jax():
    """ensure_turn_capacity and rebuild_history_pending: 24 frames with a
    forced fire on every second one (12 turns) into a KV cache of 128
    positions, so three turns find no room and start a fresh cache with
    the recent turns re-carried as text; the ring clamps past the config's
    16 frames.  Every frame's utterance, the cache length and the pending
    ids match the JAX package's (0 mismatches), as does the ring."""
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64), quantize_gate="int4", kv_capacity=128)
    jeng = JEngine(jp, cfg, **kw)
    teng = TEngine(tp, tconfig.tiny_streammind_config(), device="cpu", **kw)
    s = cfg.vision.image_size
    frames = np.random.default_rng(2).standard_normal((24, 1, 3, s, s)).astype(np.float32)
    skw = dict(prompt_ids=list(PROMPT), gate_threshold=2.0, max_new_tokens=8)
    js, ts = JSession(jeng, FakeTokenizer(), **skw), TSession(teng, FakeTokenizer(), **skw)
    mismatches, resets, last = 0, 0, 0
    for i, f in enumerate(frames):
        fire = i % 2 == 1
        jo = js.process_frame(jnp.asarray(f), force_fire=fire)
        to = ts.process_frame(torch.from_numpy(f), force_fire=fire)
        n = int(ts.cache.length[0])
        mismatches += (jo != to) + (n != int(js.cache.length[0])) + (ts.pending_ids != js.pending_ids)
        if fire:
            resets += n < last
            last = n
    assert mismatches == 0
    assert len(ts.turns) == 12 and ts.turns == js.turns and resets == 3
    assert int(ts.state.frame_idx) == 24 > cfg.max_stream_frames
    np.testing.assert_allclose(ts.state.memory.numpy(), np.asarray(js.state.memory),
                               rtol=2e-5, atol=2e-5)


def test_jax_exported_bf16_session_resumes_in_the_port():
    """A bf16 session exported by the JAX package (its KV cache comes out as
    ml_dtypes.bfloat16 arrays) resumes in the port; both then take the same
    frames under the gate's own decisions and speak the same greedy tokens
    on the same frames."""
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64))
    jeng = JEngine(jp, cfg, **kw)
    teng = TEngine(tp, tconfig.tiny_streammind_config(), device="cpu", **kw)
    frames = _frames(cfg)
    js = JSession(jeng, FakeTokenizer(), prompt_ids=list(PROMPT), gate_threshold=2.0,
                  max_new_tokens=5)
    for i in range(4):  # one (forced) fire before the export
        js.process_frame(jnp.asarray(frames[i]), force_fire=i == 2)
    blob = js.export_state()
    assert blob["kv_k"].dtype.name == "bfloat16" and len(blob["turns"]) == 1
    ts = TSession.resume(teng, FakeTokenizer(), blob)
    assert ts.cache.k.dtype == torch.bfloat16
    assert torch.equal(ts.cache.k.float(), torch.from_numpy(blob["kv_k"].astype(np.float32)))
    js.gate_threshold = ts.gate_threshold = None  # from here the gate decides: p[1] > p[0]
    jout, tout = [], []
    for f in frames[4:]:
        jout.append(js.process_frame(jnp.asarray(f)))
        tout.append(ts.process_frame(torch.from_numpy(f)))
    assert [o is None for o in tout] == [o is None for o in jout]
    assert tout == jout and any(o is not None for o in tout)
    assert ts.turns == js.turns and int(ts.cache.length[0]) == int(js.cache.length[0])


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        "streammind_torch." + ".".join(p.relative_to(REPO / "streammind_torch").with_suffix("").parts)
        for p in (REPO / "streammind_torch").rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        "import streammind_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'streammind_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "streammind_torch.streaming.engine" in mods and "streammind_torch.ops._build" in mods
    assert "streammind_torch.train.run" in mods and "streammind_torch.train.trainer" in mods
    assert "streammind_torch.ops.int8_matvec" in mods and "streammind_torch.ops.scan" in mods
    assert "streammind_torch.utils.quantize" in mods
    for m in ("api", "utils.convert", "serve.model_worker", "serve.controller", "serve.cli",
              "serve.safety", "mm_utils", "utils.checkpoint", "native", "data.matchtime",
              "data.ego4d", "data.sft", "data.extract", "data.run_extract", "eval.metrics",
              "eval.mcqa", "eval.nlg", "eval.gpt_judge", "eval.run_gate_stream",
              "eval.run_ego4d_stream", "eval.run_ego4d_lta", "eval.run_mcqa", "eval.run_oqa",
              "models.mistral", "models.projector", "models.meta", "utils.from_jax",
              "utils.params", "streaming.paged", "streaming.multistream", "utils.dist",
              "parallel.mesh", "parallel.partitioning", "parallel.collectives",
              "parallel.serving", "tools.real_weights_smoke"):
        assert "streammind_torch." + m in mods
