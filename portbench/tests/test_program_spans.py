"""The readers of the program's own spans and counters
(``portbench/program_spans.py`` and the metrics that use it), on the CPU:

    python -m pytest portbench/tests -q

Synthetic spans and busy intervals with answers worked by hand; a program
without the tracer, whose metrics are left out; and whole traced runs of
the tiny cells through ``run.main``.
"""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import harness  # noqa: E402
import program_spans  # noqa: E402
import tiny  # noqa: E402

harness.fix_environment()

MS = 1_000_000   # ns
NEW = ("broker.collect_ms", "server.stage_ms", "perceive.idle_ms", "moe.expert_id_reads",
       "decode.host_ms", "event.to_prefill_ms")


def _span(sid, name, t0, t1, parent=None, event=None, thread=1, **attrs):
    return {"name": name, "id": sid, "parent": parent, "event": event, "thread": thread,
            "t0": t0 * MS, "t1": t1 * MS, "attrs": attrs}


def _read(metric, run):
    return harness.load_module(HERE.parent, "metrics", metric).read(run)


# two watch ticks on the tick thread (1), and a client's span on thread 2
WATCH = [
    _span(0, "broker.collect", 0, 4, event=0, frames=32, active=32),
    _span(1, "server.step", 5, 20, event=0),
    _span(2, "server.stage", 5, 7, parent=1, event=0),
    _span(3, "engine.perceive", 7, 15, parent=1, event=0),
    _span(4, "engine.vit", 7, 12, parent=3, event=0),
    _span(5, "server.gate_read", 15, 18, parent=1, event=0),
    _span(6, "broker.publish", 20, 21, event=0),
    _span(7, "broker.collect", 22, 28, event=1),
    _span(8, "server.step", 30, 50, event=1),
    _span(9, "server.stage", 30, 34, parent=8, event=1),
    _span(10, "engine.perceive", 34, 44, parent=8, event=1),
    _span(11, "server.gate_read", 44, 49, parent=8, event=1),
    _span(12, "client", 0, 60, thread=2),
]
BUSY = [[a * MS, b * MS] for a, b in
        [(0, 1), (2, 8), (9, 10), (13, 14), (16, 17), (18, 25), (33, 40), (43, 60), (62, 63)]]


def _watch_run():
    return NS(trace=NS(busy=BUSY), program=(WATCH, {}))


def test_idle_join_by_hand():
    """Each gap goes to the innermost span open at its middle on the tick
    thread; where only the client's span is open, to it; outside every
    span, to None."""
    idle = program_spans.idle_by_span(_watch_run())
    # gap middles: 1.5 collect; 8.5 and 11.5 vit; 15 and 17.5 gate_read (perceive has
    # ended at 15); 29 only the client; 41.5 perceive; 61 none
    assert idle == {0: 1 * MS, 4: 4 * MS, 5: 3 * MS, 12: 8 * MS, 10: 3 * MS, None: 2 * MS}
    assert sum(idle.values()) == sum(s1 - e0 for (_, e0), (s1, _) in zip(BUSY, BUSY[1:]))
    assert program_spans.enclosing(WATCH, "engine.perceive") == {3: 3, 4: 3, 10: 10}


def test_watch_readers_by_hand():
    run = _watch_run()
    assert _read("broker.collect_ms", run) == pytest.approx((4 + 6) / 2)
    assert _read("server.stage_ms", run) == pytest.approx((2 + 4) / 2)
    # vit 1 + 3, perceive 3 (ms), over 2 ticks
    assert _read("perceive.idle_ms", run) == pytest.approx(7 / 2)
    for metric in ("moe.expert_id_reads", "decode.host_ms", "event.to_prefill_ms"):
        assert _read(metric, run) is None


# a tick whose gate fired K 2 turns (one batched prefill, two decode steps), a tick with
# one turn, and a prefill whose tick began before the traced window
MATCH = [
    _span(20, "server.step", 100, 300, event=7),
    _span(22, "server.cognify", 130, 290, parent=20, event=7, batched=2, alone=0),
    _span(21, "paged.prefill", 140, 200, parent=22, event=7, K=2, bucket=128),
    _span(23, "paged.decode", 200, 290, parent=22, event=7, K=2, steps=2),
    _span(24, "paged.decode_step", 200, 240, parent=23, event=7),
    _span(25, "moe.expert_ids", 210, 215, parent=24, event=7),
    _span(26, "moe.expert_ids", 220, 232, parent=24, event=7),
    _span(29, "decode.sample", 240, 245, parent=23, event=7),
    _span(27, "paged.decode_step", 245, 285, parent=23, event=7),
    _span(28, "moe.expert_ids", 250, 251, parent=27, event=7),
    _span(30, "server.step", 400, 500, event=8),
    _span(31, "paged.prefill", 420, 450, parent=30, event=8, K=1, bucket=64),
    _span(32, "paged.prefill", 50, 60, event=6, K=3, bucket=64),
]


def test_match_readers_by_hand():
    run = NS(trace=NS(busy=[]), program=(MATCH, {"moe.expert_id_reads": 6}))
    assert _read("moe.expert_id_reads", run) == 3.0
    # step 24: 40 - (5 + 12); step 27: 40 - 1
    assert _read("decode.host_ms", run) == pytest.approx((23 + 39) / 2)
    # K 2 turns 40 ms after their tick began, one turn 20 ms; event 6's tick is not traced
    assert _read("event.to_prefill_ms", run) == pytest.approx((2 * 40 + 20) / 3)
    assert _read("perceive.idle_ms", run) is None        # no device work, no ticks' perceive
    assert _read("broker.collect_ms", run) is None


def test_no_tracer_in_the_program_reads_nothing(monkeypatch):
    """A program without the tracer (the benchmark over an older checkout):
    every new metric is left out, and nothing raises."""
    monkeypatch.setitem(sys.modules, "streammind_torch.utils.profiling",
                        types.ModuleType("streammind_torch.utils.profiling"))
    import streammind_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", sys.modules["streammind_torch.utils.profiling"],
                        raising=False)
    for trace in (None, NS(busy=BUSY)):
        run = NS(trace=trace)
        assert program_spans.of(run) == ([], {})
        for metric in NEW:
            assert _read(metric, run) is None


# read from device operations, which a CPU run's trace holds none of
NEEDS_DEVICE_OPS = {"exact_attention_roofline", "flash_attention_roofline",
                    "paged_attention_roofline", "int4_matvec_roofline", "moe.prefill_ms",
                    "perceive.idle_ms"}


@pytest.mark.parametrize("name,new", [
    ("tiny.watch", {"broker.collect_ms", "server.stage_ms"}),
    ("tinymix.match", {"moe.expert_id_reads", "decode.host_ms", "event.to_prefill_ms"}),
])
def test_traced_tiny_cell_reads_every_metric(tmp_path, capsys, name, new):
    """A whole ``--trace 1`` run of a tiny cell through ``run.main`` on the
    CPU: every per-layer metric of the cell, old and new, reads a number,
    but those read from device operations."""
    import run
    from streammind_torch.utils.profiling import tracer

    tracer.reset()
    root = tiny.tiny_checkout(tmp_path)
    argv = ["--workload", name, "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "1"]
    try:
        assert run.main(argv, root=root, device="cpu") == 0
    finally:
        tracer.reset()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    cell = harness.Cell(name, root=root, here=root / "portbench")
    want = {m["name"] for m in cell.per_layer} - NEEDS_DEVICE_OPS
    assert new <= want and set(out["metrics"]) == want
    if name == "tinymix.match":
        layers = tiny.tiny_config(mixtral=True)["num_hidden_layers"]
        assert out["metrics"]["moe.expert_id_reads"]["value"] == layers
