"""The serving driver for a hybrid decoder (Jamba): ``drivers/serve.py``'s
clients, schedule, recorder and recording subclasses over StreamMind with
a Jamba decoder, and a check that judges the Mamba layers' state too.

A traffic file with ``"driver": "hybrid"`` gives the same parameters as a
serving mix.  The set-up is ``serve.serve``'s with this decoder's tree
(``hybrid_weights.py``); beside what ``serve`` records, each turn leaves a
copy of its dialogues' state slots (the conv windows and SSM states of
every Mamba layer), and with ``trace`` the Mamba layers' calls in prefills
enter the profiler as a ``portbench.mamba`` range.

The check: perception as ``checks.perception``; cognition as
``checks.cognition`` with the Jamba reference (``reference/jamba.py``):
the widest logit gap of a served token and the share of routes off the
reference router's clear top 2 over the MoE layers, and
``hybrid_state_relerr``, the relative rms error of the states the program
held for each judged dialogue after its last turn against the reference's
after the same sequence (the larger of the SSM states' and the conv
windows', over every Mamba layer).  The control puts the reference at fp8
in the program's place for each.

A checkout whose port does not know ``model_type: "jamba"`` ends the run
with exit code 5 before any weight is drawn.
"""
from __future__ import annotations

import gc
import sys
from pathlib import Path

import numpy as np
import torch

import harness
from modelcfg import dims

S = harness.load_module(Path(__file__).resolve().parents[1], "drivers", "serve")
PC = S.PC


def require_hybrid_port(config: dict) -> None:
    """Exit with code 5 where the port reads this config as no hybrid."""
    from streammind_torch.config import text_config_from_hf

    if not getattr(text_config_from_hf(config), "hybrid", False):
        print(f"portbench: the port does not serve model_type {config.get('model_type')!r} as a "
              "hybrid decoder; no run", file=sys.stderr)
        raise SystemExit(5)


def _swap_hybrid(broker, rec, snaps: dict):
    """``serve._swap_classes``, then the Mamba layers' prefill calls in a
    ``portbench.mamba`` range (with ``trace``) and each turn's state slots
    copied for the check: snaps[sid] = (segment index, conv, ssm)."""
    from streammind_torch.models import jamba

    restore = S._swap_classes(broker, rec)
    mixer = jamba.mamba_mixer

    def mixer_hooked(*a, **kw):
        if rec.in_prefill and rec.trace:
            with torch.profiler.record_function("portbench.mamba"):
                return mixer(*a, **kw)
        return mixer(*a, **kw)

    jamba.mamba_mixer = mixer_hooked
    paged = broker.server.paged
    base = type(paged)

    class HybridPaged(base):
        def run_turns(self, dids, plans, memories, **kw):
            toks = super().run_turns(dids, plans, memories, **kw)
            slots = torch.tensor([self.slots[d] for d in dids], device=self.states.ssm.device)
            st = self.states.gather(slots)
            for r, d in enumerate(dids):
                snaps[d] = (len(rec.dialogues[d]) - 1, st.conv[:, r], st.ssm[:, r])
            return toks

    paged.__class__ = HybridPaged

    def restore_all():
        restore()
        jamba.mamba_mixer = mixer

    return restore_all


def serve_hybrid(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float):
    """``serve.serve`` over a hybrid decoder: set up, warm up, measure, and
    hand back (record, weights, what the window counted, state copies)."""
    from streammind_torch.ops import _build
    from streammind_torch.serve import BatchedSessionBroker
    from streammind_torch.streaming import StreamMindEngine

    import hybrid_weights as HW

    dev = torch.device(device)
    dm = dims(config)
    if dev.type == "cuda":
        _build.build_all()
    tree = HW.build(config, seed, dev)
    eng_kw = config["serving"]["engine"]
    engine = StreamMindEngine(tree, S.port_config(config), eos_token_id=config.get("eos_token_id", 2),
                              attn_impl=eng_kw["attn_impl"], quantize_gate=eng_kw["quantize_gate"],
                              device=dev)
    broker = BatchedSessionBroker(engine, capacity=traffic["streams"], kv_mode="paged",
                                  page_size=traffic["page_size"],
                                  max_wait_ms=traffic["max_wait_ms"])
    sched = S.Schedule(traffic, seed, dm, dev)
    rec = S.Recorder(trace, np.random.default_rng([seed, 2]))
    snaps = {}
    restore = _swap_hybrid(broker, rec, snaps)
    tok = S.StandInTokenizer()
    lock = S.Lockstep(broker, sched.seats)
    warm = max(S.WARMUP_TICKS, sched.first_moment() + 1 if sched.moments else 0)
    prof = None
    out = dict(frames_ok=0, frames_failed=0, events=[], window_s=None)
    g = 0

    def stop_trace(end: float):
        S._note(f"stopping the profiler after {rec.window_ticks} ticks")
        prof.stop()
        S._note("profiler stopped")
        out["trace_window"] = (t_win, end)
        out["prof"] = prof
    try:
        while True:
            if not rec.window and g >= warm:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                if trace:
                    prof = S._start_profiler()
                    S._note("profiler started")
                rec.window = True
                out["setup_s"] = PC() - t_start
                t_win = PC()
                counters0 = (broker.ticks, broker.frames_seen)
                trace_end = t_win + traffic.get("trace_seconds", seconds)
            if rec.window:
                now = PC()
                if prof is not None and now >= trace_end and (g - 1) in sched.moments:
                    stop_trace(now)
                    prof = None
                if now - t_win >= seconds and sched.closes_cycle(g - 1):
                    break
            todo = {}
            for seat in range(sched.seats):
                v, new = sched.viewer_at(seat, g)
                if new:
                    if len(sched.viewers[seat]) > 1:
                        broker.remove(sched.viewers[seat][-2]["sid"])
                    broker.add(v["sid"], tok, prompt_ids=v["prompt"], max_new_tokens=sched.line_max,
                               gate_threshold=2.0)
                line = sched.fires(seat, g)
                slot = broker._slot(v["sid"])
                slot.gate_threshold = 2.0 if line is None else -1.0
                if line is not None:
                    slot.max_new_tokens = line
                todo[seat] = (v["sid"], sched.frame(seat, g))
            results = lock.tick(todo)
            if prof is not None and rec.window_ticks % 50 == 0:
                S._note(f"{rec.window_ticks} ticks traced")
            if rec.window:
                for seat, (sid, t0, t1, r) in results.items():
                    if "error" in r or r.get("closed"):
                        out["frames_failed"] += 1
                        out.setdefault("errors", []).append(r.get("error", "closed"))
                        continue
                    out["frames_ok"] += 1
                    if r["fire"]:
                        out["events"].append(rec.first_token_at[sid] - t0)
            g += 1
        out["window_s"] = PC() - t_win
        out["ticks"] = broker.ticks - counters0[0]
        out["frames_seen"] = broker.frames_seen - counters0[1]
        if prof is not None:
            stop_trace(PC())
    finally:
        lock.close()
        broker.shutdown()
        restore()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["card"] = harness.card_state()   # the SM clock as the window closed
    out["frames_total"] = g
    del engine, broker, lock
    return rec, tree, out, snaps


def _state_relerr(states, conv, ssm) -> float:
    """The larger of the SSM states' and the conv windows' relative rms
    error, every Mamba layer together: (conv (Lm, inner, W), ssm (Lm,
    inner, n)) against the reference's list of (window, state)."""
    import checks

    return max(checks.relrms(ssm, torch.stack([h for _, h in states])),
               checks.relrms(conv, torch.stack([w for w, _ in states])))


def cognition(dialogues: dict, snaps: dict, tree, t, n: int, seed: int, device,
              control: bool = False):
    """``checks.cognition`` over a Jamba decoder, with the states: returns
    (numbers, control numbers, tokens judged, states judged)."""
    import checks
    from reference import jamba as rj
    from reference.model import FP8, FP32

    prog = {"token_gap": 0.0, "hybrid_state_relerr": 0.0}
    ctl = {"token_gap": 0.0, "hybrid_state_relerr": 0.0}
    counts = {"prog": [0, 0], "ctl": [0, 0]}
    judged = states_judged = 0

    def gap(logits, rows, pick):
        return float((logits.max(dim=-1).values - logits[rows, pick]).max())

    for sid, seg in checks.sample_dialogues(dialogues, n, seed):
        x, at, toks, routes = checks._sequence(tree, seg, device)
        rows = torch.arange(len(toks), device=x.device)
        seen, states = [], []
        logits = rj.sequence_logits(tree["text"], t, x, at, FP32, routes=routes, seen=seen,
                                    states=states)
        prog["token_gap"] = max(prog["token_gap"], gap(logits, rows, toks))
        judged += len(toks)
        counts["prog"] = [a + b for a, b in zip(counts["prog"], checks._route_miss(seen))]
        snap = snaps.get(sid)   # taken after the dialogue's last turn, of its last segment
        if snap is not None and seg is dialogues[sid][-1] and snap[0] == len(dialogues[sid]) - 1:
            prog["hybrid_state_relerr"] = max(prog["hybrid_state_relerr"],
                                              _state_relerr(states, snap[1], snap[2]))
            states_judged += 1
        if control:
            seen_c, states_c = [], []
            pick = rj.sequence_logits(tree["text"], t, x, at, FP8, seen=seen_c,
                                      states=states_c).argmax(dim=-1)
            seen_r, states_r = [], []
            logits = rj.sequence_logits(tree["text"], t, x, at, FP32,
                                        routes=torch.stack([s[2] for s in seen_c]), seen=seen_r,
                                        states=states_r)
            counts["ctl"] = [a + b for a, b in zip(counts["ctl"], checks._route_miss(seen_r))]
            ctl["token_gap"] = max(ctl["token_gap"], gap(logits, rows, pick))
            ctl["hybrid_state_relerr"] = max(
                ctl["hybrid_state_relerr"],
                _state_relerr(states_r, torch.stack([w for w, _ in states_c]),
                              torch.stack([h for _, h in states_c])))
        del logits, x
    if counts["prog"][1]:
        prog["route_miss"] = counts["prog"][0] / counts["prog"][1]
        if control:
            ctl["route_miss"] = counts["ctl"][0] / max(counts["ctl"][1], 1)
    return prog, ctl, judged, states_judged


def run(cell, args, t_start: float, device: str = "cuda"):
    """The entry ``run.py`` calls: one run of a hybrid serving cell, measured and
    checked (``serve.run``'s record, with the hybrid's numbers)."""
    import checks
    import tracing
    from reference import jamba as rj
    from reference import model as ref

    require_hybrid_port(cell.config)
    dm = dims(cell.config)
    rec, tree, out, snaps = serve_hybrid(cell.config, cell.traffic, args.seed, args.seconds,
                                         bool(args.trace), device, t_start)
    run = harness.RunRecord(cell)
    run.dm, run.rec, run.out = dm, rec, out
    run.hybrid = rj.dims(cell.config)
    run.setup_s, run.window_s = out["setup_s"], out["window_s"]
    run.attempted, run.failed = out["frames_ok"] + out["frames_failed"], out["frames_failed"]
    if "prof" in out:
        t0, t1 = out["trace_window"]
        run.trace = tracing.Trace(out.pop("prof"), t1 - t0)
        print(f"portbench: trace: {len(run.trace.ops)} device ops, {len(run.trace.cpu_ranges)} "
              f"host spans, device-side spans "
              f"{sorted((k, len(v)) for k, v in run.trace.gpu_ranges.items())}", file=sys.stderr)
        run.breakdown = run.trace.breakdown()
    cuda = torch.device(device).type == "cuda"
    run.device = {"platform": "gpu" if cuda else device,
                  "kind": torch.cuda.get_device_name(0) if cuda else device,
                  "count": cell.chips, "memory_peak_bytes": int(out.get("memory_peak_bytes", 0)),
                  "card": out.get("card", device)}
    if run.trace is not None:
        run.device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref.tf32_off()
    control = bool(args.control)
    judged = [c for c in rec.captures if "feats" in c]
    with torch.no_grad():
        perc = checks.perception(judged, tree, dm, control=control)
        cog = cognition(rec.dialogues, snaps, tree, run.hybrid, S.CHECK_DIALOGUES, args.seed,
                        device, control=control)
    prog, ctl = perc if control else (perc, {})
    prog.update(cog[0])
    ctl.update(cog[1])
    run.numbers = prog
    run.control = ctl if control else None
    ticks = [c["tick"] for c in judged if c["window"]]
    run.sound = [("no failed submit", out["frames_failed"] == 0),
                 ("a window tick judged", len(ticks) >= 1),
                 ("a served token judged", cog[2] > 0),
                 ("a dialogue's state judged", cog[3] > 0)]
    run.notes = {"window_ticks": rec.window_ticks, "ticks_judged": ticks,
                 "errors": out.get("errors", [])[:3], "tokens_judged": cog[2],
                 "states_judged": cog[3]}
    return run
