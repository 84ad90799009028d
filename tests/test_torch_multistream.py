"""Multi-stream serving in streammind_torch against streammind_tpu, on the CPU.

Both packages get one tiny tree (the JAX package's init, carried over
with params_from_numpy) and the same numpy frames.  Batched perception is
held to fp32 tolerance (probs 1e-4, rings 2e-5); greedy decode, utterances
and turn histories must be identical, for the engine's batched decode and
for MultiStreamServer in both KV modes, with batched and sequential
cognition.  Also: memory subsampling, and the broker's batching and
error isolation (the port alone).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.constants import VIDEO_TOKEN_INDEX
from streammind_tpu.models.meta import build_splice_plan, init_streammind_params
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import engine as jengine_mod
from streammind_tpu.streaming import memory_subsample as jsub
from streammind_tpu.streaming.multistream import MultiStreamServer as JServer
from streammind_tpu.streaming.state import init_multistream_state
from streammind_torch import config as tconfig
from streammind_torch.serve import BatchedSessionBroker
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming import engine as tengine_mod
from streammind_torch.streaming import memory_subsample as tsub
from streammind_torch.streaming.multistream import MultiStreamServer as TServer
from streammind_torch.utils.from_jax import params_from_numpy

PROMPTS = {"a": [1, 10, VIDEO_TOKEN_INDEX, 12], "b": [1, 11, VIDEO_TOKEN_INDEX, 13],
           "c": [1, 14, VIDEO_TOKEN_INDEX, 15]}
LIMITS = {"a": 4, "b": 6, "c": 3}


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


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64), quantize_gate="int4")
    return cfg, JEngine(jp, cfg, **kw), TEngine(tp, tconfig.tiny_streammind_config(),
                                                device="cpu", **kw)


def _frames(cfg, n_ticks, sids, seed=1):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    return [{sid: rng.standard_normal((1, 3, s, s)).astype(np.float32) for sid in sids}
            for _ in range(n_ticks)]


def test_perceive_step_batch_partial_feed_matches_jax(engines):
    cfg, jeng, teng = engines
    S = 3
    jstate, tstate = init_multistream_state(cfg, S), teng.new_stream_state(S)
    rng = np.random.default_rng(2)
    size = cfg.vision.image_size
    for mask in ([True, True, True], [True, False, True], [False, True, False]):
        px = rng.standard_normal((S, 3, size, size)).astype(np.float32)
        jp, jstate = jeng.perceive_step_batch(jnp.asarray(px), jstate, jnp.asarray(mask))
        tp, tstate = teng.perceive_step_batch(_t(px), tstate, _t(mask))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tstate.memory.numpy(), np.asarray(jstate.memory),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(tstate.frame_idx.numpy(), np.asarray(jstate.frame_idx))
        np.testing.assert_allclose(tstate.mamba.ssm.numpy(), np.asarray(jstate.mamba.ssm),
                                   rtol=2e-5, atol=2e-5)
    # the unfed rows of the last tick kept their state exactly
    assert tstate.frame_idx.tolist() == [2, 2, 2]


def test_perceive_step_batch_feed_mask_over_many_ticks_matches_jax(engines):
    """S = 3 streams over 20 ticks under a seeded feed mask: stream 0 is fed
    on every tick but one (its ring clamps past the config's 16 frames), the
    others on about 70 % and 40 % of ticks, and that one tick feeds none.  Probs, ring,
    Mamba state and frame counters tick by tick against the JAX package."""
    cfg, jeng, teng = engines
    S, ticks = 3, 20
    rng = np.random.default_rng(4)
    masks = rng.random((ticks, S)) < np.asarray([1.0, 0.7, 0.4])
    masks[7] = False
    jstate, tstate = init_multistream_state(cfg, S), teng.new_stream_state(S)
    size = cfg.vision.image_size
    for mask in masks:
        px = rng.standard_normal((S, 3, size, size)).astype(np.float32)
        jp, jstate = jeng.perceive_step_batch(jnp.asarray(px), jstate, jnp.asarray(mask))
        tp, tstate = teng.perceive_step_batch(_t(px), tstate, _t(mask))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tstate.memory.numpy(), np.asarray(jstate.memory),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tstate.mamba.ssm.numpy(), np.asarray(jstate.mamba.ssm),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(tstate.frame_idx.numpy(), np.asarray(jstate.frame_idx))
    assert tstate.frame_idx.tolist() == masks.sum(0).tolist()
    assert tstate.frame_idx[0] == ticks - 1 > cfg.max_stream_frames > tstate.frame_idx[2]


def test_generate_from_prefill_batch_limits_and_padding_match_jax(engines):
    """Per-row limits, a padding row, and a stop matrix per row."""
    cfg, jeng, teng = engines
    ids = [[1, 5, 9, VIDEO_TOKEN_INDEX, 7, 4], [1, 8, VIDEO_TOKEN_INDEX, 6],
           [1, VIDEO_TOKEN_INDEX, 13, 14, 15]]
    plans = [build_splice_plan(x, [3], VIDEO_TOKEN_INDEX, 32) for x in ids]
    mem = np.random.default_rng(3).standard_normal(
        (3, cfg.max_stream_frames, cfg.text.hidden_size)).astype(np.float32)
    stops = tengine_mod.stack_stop_ids([None, np.asarray([[-1, 77], [5, 6]], np.int32), None])
    kw = dict(active=[True, True, False], stop_ids=stops)
    jc = jengine_mod.stack_kv_caches([jeng.new_kv_cache() for _ in plans])
    tc = tengine_mod.stack_kv_caches([teng.new_kv_cache() for _ in plans])
    jl, jc = jeng.prefill_batch(plans, jnp.asarray(mem), jc)
    tl, tc = teng.prefill_batch(plans, _t(mem), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jt, jsteps, jc = jeng.generate_from_prefill_batch(jl, jc, [7, 2, 5], **kw)
    tt, tsteps, tc = teng.generate_from_prefill_batch(tl, tc, [7, 2, 5], **kw)
    assert tt == jt and tsteps == jsteps and tt[2] == []
    assert tc.length.tolist() == np.asarray(jc.length).tolist()
    parts = tengine_mod.split_kv_cache(tc, 3)
    assert [int(p.length[0]) for p in parts] == tc.length.tolist()


def _run_server(Server, eng, cfg, to_frame, kv_mode, batch, frames, schedule):
    """Serve ``frames`` (one dict a tick); schedule[t] lists the streams whose
    gate is forced open on tick t (threshold -1), the others stay shut (2.0)."""
    srv = Server(eng, capacity=4, batch_cognition=batch, kv_mode=kv_mode, num_pages=64,
                 page_size=8, stop_strings=["</s>"])
    tok = FakeTokenizer()
    for sid in PROMPTS:
        srv.add_stream(sid, tok, prompt_ids=PROMPTS[sid], max_new_tokens=LIMITS[sid])
    log = []
    for t, f in enumerate(frames):
        for s in srv.slots:
            if s is not None:
                s.gate_threshold = -1.0 if s.stream_id in schedule[t] else 2.0
        log.append(srv.step({sid: to_frame(x) for sid, x in f.items()}))
    turns = {s.stream_id: (list(s.turns), list(s.interval_ids)) for s in srv.slots if s}
    return log, turns


@pytest.mark.parametrize("kv_mode,batch", [("dense", True), ("dense", False),
                                           ("paged", True), ("paged", False)])
def test_multistream_server_matches_jax(engines, kv_mode, batch):
    """Three streams; ticks with three, two, one and no fires (one stream
    unfed on tick 2)."""
    cfg, jeng, teng = engines
    frames = _frames(cfg, 5, PROMPTS)
    del frames[2]["c"]
    schedule = [{"a", "b", "c"}, {"a", "c"}, {"b", "c"}, set(), {"b"}]
    jout = _run_server(JServer, jeng, cfg, jnp.asarray, kv_mode, batch, frames, schedule)
    tout = _run_server(TServer, teng, cfg, _t, kv_mode, batch, frames, schedule)
    assert tout == jout
    log = tout[0]
    assert [sorted(k for k, v in o.items() if v is not None) for o in log] == [
        ["a", "b", "c"], ["a", "c"], ["b"], [], ["b"]]


def test_paged_pool_pressure_resets_and_recarries_like_jax(engines):
    """A 10-page pool of 8 tokens under two always-firing streams: the
    capacity guard resets dialogues and re-carries their turns as text;
    both packages make the same choices and say the same things."""
    cfg, jeng, teng = engines
    frames = _frames(cfg, 5, ("a", "b"), seed=4)
    outs = []
    for Server, eng, conv in ((JServer, jeng, jnp.asarray), (TServer, teng, _t)):
        srv = Server(eng, capacity=2, kv_mode="paged", num_pages=10, page_size=8)
        for sid in ("a", "b"):
            srv.add_stream(sid, FakeTokenizer(), gate_threshold=-1.0, max_new_tokens=4)
        log, lengths = [], []
        for f in frames:
            log.append(srv.step({k: conv(v) for k, v in f.items()}))
            lengths.append(dict(srv.paged.lengths))
        outs.append((log, lengths, [list(s.turns) for s in srv.slots],
                     [list(s.pending_ids) for s in srv.slots]))
    assert outs[1] == outs[0]
    lengths = outs[1][1]
    assert any(lengths[t + 1][s] < lengths[t][s] for t in range(4) for s in "ab") or any(
        v == 0 for ln in lengths for v in ln.values())


def test_sample_token_rows_mixes_greedy_and_sampled_rows():
    """Greedy rows take the argmax; sampled rows draw inside their own
    filtered support (top_k 2 here), which filtered_logits shares with JAX."""
    from streammind_torch.streaming.logit_filters import sample_token_rows

    logits = _t(np.random.default_rng(6).standard_normal((3, 50)).astype(np.float32))
    top2 = torch.topk(logits, 2, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        toks = sample_token_rows(g, logits, [0.0, 1.0, 0.0], [0, 2, 0], [0.0, 0.0, 0.0])
        assert toks[0] == int(logits[0].argmax()) and toks[2] == int(logits[2].argmax())
        assert toks[1] in top2[1].tolist()
    assert sample_token_rows(None, logits, [0.0] * 3, [0] * 3, [0.0] * 3) == \
        logits.argmax(-1).tolist()


def test_stop_id_stacks_match_jax():
    mats = [np.asarray([[-1, 7], [5, 6]], np.int32), None, np.asarray([[9, 8, 3]], np.int32)]
    for fn in ("stack_stop_ids", "merge_stop_ids"):
        np.testing.assert_array_equal(getattr(tengine_mod, fn)(mats),
                                      getattr(jengine_mod, fn)(mats))
        assert getattr(tengine_mod, fn)([None, None]) is None


@pytest.mark.parametrize("kind,per", [("log", 0.5), ("similarity", 0.4), ("all", 0.5)])
def test_memory_subsample_matches_jax(kind, per):
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((11, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tsub.subsample_memory(_t(tokens), kind, per).numpy(),
        np.asarray(jsub.subsample_memory(jnp.asarray(tokens), kind, per)))
    ring = rng.standard_normal((1, 16, 8)).astype(np.float32)
    span = list(range(2, 13))
    assert (tsub.subsample_span(span, _t(ring), kind, per)
            == jsub.subsample_span(span, jnp.asarray(ring), kind, per))


def test_broker_batches_concurrent_streams_and_isolates_a_bad_frame(engines):
    cfg, _, teng = engines
    broker = BatchedSessionBroker(teng, capacity=4, max_wait_ms=2000.0, kv_mode="paged",
                                  page_size=8)
    size = cfg.vision.image_size
    try:
        for sid in ("a", "b", "c"):
            broker.add(sid, FakeTokenizer(), prompt_ids=PROMPTS[sid], gate_threshold=-1.0,
                       max_new_tokens=3)
        results = {sid: [] for sid in ("a", "b", "c")}
        barrier = threading.Barrier(3)

        def run(sid, rounds):
            r = np.random.default_rng(ord(sid))
            for bad in rounds:
                barrier.wait()
                frame = (np.zeros((2, 2), np.float32) if bad
                         else r.standard_normal((1, 3, size, size)).astype(np.float32))
                results[sid].append(broker.submit(sid, frame, timeout=300))

        plan = {"a": [False, True, False], "b": [False] * 3, "c": [False] * 3}
        threads = [threading.Thread(target=run, args=(sid, plan[sid])) for sid in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for sid, outs in results.items():
            # the bad frame failed its tick (all three callers), nothing else
            assert ["error" in o for o in outs] == [False, True, False], outs
            assert outs[0]["fire"] and outs[2]["fire"] and isinstance(outs[2]["text"], str)
            assert [outs[0]["frame_idx"], outs[2]["frame_idx"]] == [1, 2]
        assert "ValueError" in results["a"][1]["error"] or "RuntimeError" in results["a"][1][
            "error"]
        assert broker.frames_seen == 9 and broker.ticks < broker.frames_seen
        out = broker.remove("a")
        assert len(out["turns"]) == 2
        with pytest.raises(KeyError):
            broker.submit("a", np.zeros((1, 3, size, size), np.float32))
    finally:
        broker.shutdown()
