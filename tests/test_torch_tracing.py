"""The port's tracer (``streammind_torch/utils/profiling.py::tracer``) on the
CPU: off it records nothing and changes no token; spans nest per thread and
carry the server's tick number as their event id; on a 2-stream paged
server over the benchmark's tiny int4 Mixtral every serving span appears
where it belongs and the expert-id reads are counted; and a span's start
lies on the profiler's clock.
"""
import json
import statistics
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from streammind_torch.serve import BatchedSessionBroker
from streammind_torch.streaming import StreamMindEngine
from streammind_torch.streaming.multistream import MultiStreamServer
from streammind_torch.utils import profiling
from streammind_torch.utils.profiling import tracer

PORTBENCH = Path(__file__).resolve().parents[1] / "portbench"
sys.path.insert(0, str(PORTBENCH))
sys.path.insert(0, str(PORTBENCH / "tests"))
import harness  # noqa: E402
import tiny  # noqa: E402
import weights  # noqa: E402

SEED = 2 ** 31 + 7
LINE = 3   # the fired turn's max_new_tokens


@pytest.fixture
def fresh():
    """The module's one tracer, emptied and off before and after the test."""
    tracer.disable()
    tracer.reset()
    yield tracer
    tracer.disable()
    tracer.reset()


@pytest.fixture(scope="module")
def mixtral():
    """The tiny int4 Mixtral StreamMind engine of the benchmark's CPU tests,
    and its config and stand-in tokenizer."""
    config = tiny.tiny_config(mixtral=True)
    serve = harness.load_module(PORTBENCH, "drivers", "serve")
    tree = weights.build(config, SEED, "cpu")
    eng_kw = config["serving"]["engine"]
    engine = StreamMindEngine(tree, serve.port_config(config), eos_token_id=2,
                              attn_impl=eng_kw["attn_impl"], quantize_gate=eng_kw["quantize_gate"],
                              device=torch.device("cpu"))
    return engine, config, serve.StandInTokenizer()


def _frames(engine, ticks: int):
    s = engine.cfg.vision.image_size
    rng = np.random.default_rng(SEED)
    return [{sid: torch.from_numpy(rng.standard_normal((1, 3, s, s)).astype(np.float32))
             for sid in ("a", "b")} for _ in range(ticks)]


def _server(engine, tok):
    srv = MultiStreamServer(engine, capacity=2, kv_mode="paged", page_size=8)
    rng = np.random.default_rng(SEED)
    for sid in ("a", "b"):
        prompt = [1] + rng.integers(3, engine.cfg.text.vocab_size, 6).tolist()
        srv.add_stream(sid, tok, prompt_ids=prompt, max_new_tokens=LINE, gate_threshold=2.0)
    return srv


def _run(engine, tok, ticks: int = 3, fire_at: int = 1):
    """Three ticks of a 2-stream paged server; stream "a" fires once."""
    srv = _server(engine, tok)
    outs = []
    for t, frames in enumerate(_frames(engine, ticks)):
        srv.slots[0].gate_threshold = -1.0 if t == fire_at else 2.0
        outs.append(srv.step(frames))
    return srv, outs


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_records_nothing_and_changes_no_token(fresh, mixtral):
    engine, _, tok = mixtral
    assert tracer.span("a") is tracer.span("b", event=3, k=1) is profiling._NO_SPAN
    with tracer.span("a") as sp:
        sp.set(k=2)
    tracer.count("c")
    off, outs_off = _run(engine, tok)
    assert tracer.records() == [] and tracer.summary() == {}
    assert "c" not in tracer.counters() and "moe.expert_id_reads" not in tracer.counters()
    tracer.enable()
    on, outs_on = _run(engine, tok)
    assert tracer.records()
    assert outs_off == outs_on and outs_on[1]["a"] is not None
    assert [s.turns for s in off.slots] == [s.turns for s in on.slots]
    assert torch.equal(off.state.memory, on.state.memory)
    assert torch.equal(off.state.mamba.ssm, on.state.mamba.ssm)


def test_spans_nest_per_thread(fresh):
    tracer.enable()
    go = threading.Barrier(2)

    def work(event):
        go.wait(timeout=30)
        with tracer.span("outer", event=event, n=event):
            with tracer.span("mid") as mid:
                mid.set(depth=2)
                with tracer.span("inner"):
                    pass
            with tracer.span("mid"):
                pass

    threads = [threading.Thread(target=work, args=(e,)) for e in (5, 9)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    recs = tracer.records()
    assert len(recs) == 8
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "outer":
            assert r["parent"] is None and r["attrs"] == {"n": r["event"]}
            continue
        parent = by_id[r["parent"]]
        assert parent["thread"] == r["thread"] and parent["event"] == r["event"]
        assert parent["t0"] <= r["t0"] <= r["t1"] <= parent["t1"]
        assert parent["name"] == {"mid": "outer", "inner": "mid"}[r["name"]]
    assert {r["event"] for r in recs} == {5, 9}
    assert len({r["thread"] for r in recs}) == 2
    assert [r["attrs"] for r in recs if r["name"] == "mid"].count({"depth": 2}) == 2
    summary = tracer.summary()
    assert summary["mid"]["n"] == 4 and summary["outer"]["n"] == 2


def test_event_ids_across_the_broker_thread_and_the_paged_turn(fresh, mixtral):
    engine, _, tok = mixtral
    tracer.enable()
    broker = BatchedSessionBroker(engine, capacity=2, kv_mode="paged", page_size=8,
                                  max_wait_ms=5000)
    try:
        for sid in ("a", "b"):
            broker.add(sid, tok, prompt_ids=[1, 5, 6, 7], max_new_tokens=LINE,
                       gate_threshold=2.0)
        results = {}
        for t, frames in enumerate(_frames(engine, 3)):
            broker._slot("b").gate_threshold = -1.0 if t == 1 else 2.0
            threads = [threading.Thread(target=lambda s=sid, f=f: results.__setitem__(
                (t, s), broker.submit(s, f, timeout=120))) for sid, f in frames.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
        tick_thread = broker._thread.ident
    finally:
        broker.shutdown()
    assert results[(1, "b")]["fire"] and not results[(1, "a")]["fire"]
    spans = _by_name(tracer.records())
    for name in ("broker.collect", "broker.publish", "server.step"):
        assert [r["event"] for r in spans[name]] == [0, 1, 2], name
    assert all(r["attrs"]["frames"] == 2 and r["attrs"]["active"] == 2
               for r in spans["broker.collect"])
    steps = {r["event"]: r for r in spans["server.step"]}
    for r in spans["broker.collect"]:
        assert r["t1"] <= steps[r["event"]]["t0"]
    for r in spans["broker.publish"]:
        assert r["t0"] >= steps[r["event"]]["t1"]
    turn = [r for n in ("server.cognify", "paged.prefill", "paged.decode", "paged.decode_step",
                        "moe.expert_ids", "decode.sample") for r in spans[n]]
    assert turn and {r["event"] for r in turn} == {1}
    assert {r["thread"] for rs in spans.values() for r in rs} == {tick_thread}


# where each serving span sits: its parent's name (None: a root).  The
# ``bench.*`` ranges stand for a benchmark's ranges around the methods it
# wraps: the program's spans open around those methods, not inside them, so
# a benchmark's range stays the innermost around the prefill's and the
# step's work (a profiler puts each kernel under the innermost range only)
PARENT = {"server.step": None, "server.stage": "server.step", "engine.perceive": "server.step",
          "engine.vit": "engine.perceive", "engine.mamba": "engine.perceive",
          "engine.gate": "engine.perceive", "server.gate_read": "server.step",
          "server.cognify": "server.step", "paged.prefill": "server.cognify",
          "bench._prefill": "paged.prefill", "paged.decode": "server.cognify",
          "paged.decode_step": "paged.decode", "bench._decode_step": "paged.decode_step",
          "decode.sample": "paged.decode", "moe.expert_ids": "bench._decode_step"}


def _ranged(monkeypatch, name: str):
    """Wrap ``PagedDialogues.<name>`` in a range of its own, as the benchmark's
    recording subclass wraps it in a ``record_function`` range."""
    from streammind_torch.streaming.paged import PagedDialogues

    inner = getattr(PagedDialogues, name)

    def ranged(self, *a, **kw):
        with tracer.span(f"bench.{name}"):
            return inner(self, *a, **kw)

    monkeypatch.setattr(PagedDialogues, name, ranged)


def test_serving_spans_on_a_paged_mixtral_server(fresh, mixtral, monkeypatch):
    engine, config, tok = mixtral
    for name in ("_prefill", "_decode_step"):
        _ranged(monkeypatch, name)
    tracer.enable()
    srv, outs = _run(engine, tok, ticks=3, fire_at=1)
    recs = tracer.records()
    assert outs[1]["a"] is not None and outs[1]["b"] is None
    spans = _by_name(recs)
    assert set(spans) == set(PARENT)
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id.get(r["parent"])
        assert (parent["name"] if parent else None) == PARENT[r["name"]], r["name"]
        if parent:
            assert parent["t0"] <= r["t0"] <= r["t1"] <= parent["t1"]
    assert [r["event"] for r in spans["server.step"]] == [0, 1, 2]
    assert len(spans["engine.perceive"]) == 3
    assert all(r["attrs"] == {"rows": 2} for r in spans["engine.perceive"])
    (cog,), (pre,), (dec,) = spans["server.cognify"], spans["paged.prefill"], spans["paged.decode"]
    assert cog["event"] == pre["event"] == dec["event"] == 1
    assert cog["attrs"] == {"batched": 0, "alone": 1}
    assert pre["attrs"]["K"] == 1 and pre["attrs"]["bucket"] >= 8
    steps = len(spans["paged.decode_step"])
    assert dec["attrs"] == {"K": 1, "steps": steps} and 1 <= steps <= LINE
    assert len(spans["decode.sample"]) == steps
    layers = config["num_hidden_layers"]
    counts = tracer.counters()
    assert counts["moe.expert_id_reads"] == layers * steps == len(spans["moe.expert_ids"])
    assert counts["int4_matvec.launches"] == 0    # the plain path on CPU tensors
    assert counts.get("paged.resets", 0) == 0
    summary = tracer.summary()
    assert summary["paged.decode_step"]["n"] == steps and summary["server.step"]["n"] == 3


def test_paged_resets_are_counted(fresh, mixtral):
    engine, _, tok = mixtral
    tracer.enable()
    srv = _server(engine, tok)
    srv._reset_paged_slot(0, 1)
    srv._reset_paged_slot(1, 1)
    assert tracer.counters()["paged.resets"] == 2
    tracer.reset()
    assert "paged.resets" not in tracer.counters()


def test_flush_writes_the_summary_then_the_spans(fresh, tmp_path):
    tracer.enable()
    tracer.sink_path = str(tmp_path / "spans.jsonl")
    try:
        with tracer.span("server.step", event=4):
            with tracer.span("server.stage"):
                tracer.count("paged.resets")
        tracer.flush({"tick": 4})
        tracer.flush()
    finally:
        tracer.sink_path = None
    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [sorted(x) for x in lines[:1]] == [["counters", "stages", "tick", "ts"]]
    assert lines[0]["counters"]["paged.resets"] == 1
    assert lines[0]["stages"]["server.step"]["n"] == 1
    assert [x["name"] for x in lines[1:3]] == ["server.stage", "server.step"]
    assert lines[1]["parent"] == lines[2]["id"] and lines[1]["event"] == 4
    assert "stages" in lines[3] and len(lines) == 4   # the second flush: no spans left
    assert tracer.records() == []


def test_spans_start_on_the_profilers_clock(fresh):
    """Under a CPU profiler, each span's start against its ``record_function``
    range's start (kineto's clock, Unix-epoch nanoseconds)."""
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracer.span("on") is not profiling._NO_SPAN
        for i in range(60):
            with tracer.span(f"clock.{i}"):
                with tracer.span(f"clock.{i}.inner"):
                    x = torch.tanh(x @ x)
    assert tracer.span("off") is profiling._NO_SPAN
    starts = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("clock."):
            starts[ev.name()] = ev.start_ns()
    recs = tracer.records()
    assert len(recs) == 120 and set(starts) == {r["name"] for r in recs}
    gaps = [abs(starts[r["name"]] - r["t0"]) for r in recs]
    assert statistics.median(gaps) < 50_000 and max(gaps) < 1_000_000, (
        statistics.median(gaps), max(gaps))
