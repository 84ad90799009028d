"""The serving driver: client threads submit frames to the port's
``BatchedSessionBroker`` in lockstep, as viewers of one broadcast.

A traffic file ``traffic/<mix>.json`` with ``"driver": "serve"`` gives the
mix's parameters; ``run`` sets up, measures, checks and hands back the
run's record.

Each tick every seat's client sends its stream's next frame once every
client's previous result is back (a closed loop on the broadcast's frame
clock).  Between ticks the director swaps viewers whose clip has ended and
sets the per-stream knobs: the gate threshold (-1 opens a gate, 2 holds it
shut) and, on a seat that fires, the line's ``max_new_tokens``.  The
broker's server, its page pool and the engine are swapped for subclasses
that stamp host times where the host already waits (the gate probs, the
first tokens, each lockstep step's tokens), record each turn's inputs and
served tokens for the check, and keep device copies of the inputs and
outputs of sampled ticks.  With ``trace`` the same spans also enter the
profiler as ``record_function`` ranges.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time

import numpy as np
import torch

import harness
from modelcfg import dims

PC = time.perf_counter

WARMUP_TICKS = 3       # ticks before the window (and at least the first moment's turn)
CHECK_TICKS = 2        # window ticks whose perception is judged, drawn over the whole window
CHECK_DIALOGUES = 3    # dialogues whose served tokens are judged


# -- traffic from the seed ---------------------------------------------------------------
def value_pool(lo: int, hi: int, n: int) -> list:
    """n values spread evenly over [lo, hi]: every seed draws the same set."""
    return [int(round(v)) for v in np.linspace(lo, hi, n)]


def k_pool(seats: int, p: float, n: int) -> list:
    """n fire counts at the quantiles of Binomial(seats, p) given at least
    one fire: every seed gets the same mix of K."""
    from math import comb

    pk = np.array([comb(seats, k) * p ** k * (1 - p) ** (seats - k) for k in range(seats + 1)])
    cdf = np.cumsum(pk[1:] / pk[1:].sum())
    return [int(np.searchsorted(cdf, (i + 0.5) / n) + 1) for i in range(n)]


def moment_pool(mo: dict, seats: int) -> list:
    """The pool of moments, (gap before it, gates it fires, the line's
    tokens), the same set for every seed: gaps, fire counts and line
    lengths each spread over their range, paired once in a fixed order."""
    n = mo["pool"]
    pair = np.random.default_rng(0)
    ks = k_pool(seats, mo["fire_p"], n)
    lines = value_pool(*mo["max_new_tokens"], n)
    ks = [ks[i] for i in pair.permutation(n)]
    lines = [lines[i] for i in pair.permutation(n)]
    return list(zip(value_pool(*mo["gap_frames"], n), ks, lines))


class Cycle:
    """The values of a fixed pool in one order, over and over: any run of
    ``len(values)`` consecutive draws holds the whole pool."""

    def __init__(self, values, rng):
        self.values = [values[i] for i in rng.permutation(len(values))]
        self.i = 0

    def next(self):
        v = self.values[self.i % len(self.values)]
        self.i += 1
        return v


class Schedule:
    """Who watches from each seat, when moments fire which gates with what
    line, and what each viewer's dialogue starts from.  The traffic file
    fixes the sets of sizes and arrivals (the pool of moments, the prompt
    and clip lengths); the seed draws their order, the seats that fire, the
    prompts' ids and the frames, a seeded cycle a seat made on the card and
    kept on the host in bfloat16.  Any pool-long run of moments holds the
    whole pool, so a window that closes on whole pools does the same work
    for every seed."""

    def __init__(self, traffic: dict, seed: int, dm, device):
        rng = np.random.default_rng(seed)
        order = np.random.default_rng([seed, 1])
        self.seats = traffic["streams"]
        self.vocab = dm.text.vocab
        mo = traffic.get("moments")
        self.moments = {}      # frame -> (seats that fire, the line's max_new_tokens)
        self.closing = set()   # moments that complete a whole pool after the first
        self.viewers = {s: [] for s in range(self.seats)}
        self.line_max = mo["max_new_tokens"][1] if mo else 16
        if mo is not None:
            n = mo["pool"]
            pool = Cycle(moment_pool(mo, self.seats), order)
            self.prompt_len = Cycle(value_pool(*mo["prompt_tokens"], n), order)
            self.clip = Cycle(value_pool(*mo["clip_frames"], n), order)
            g, i = 0, 0
            while g < 20000:   # far more frames than a run of 51 s reaches
                gap, k, line = pool.next()
                g += gap
                self.moments[g] = (set(order.choice(self.seats, k, replace=False).tolist()), line)
                if i > 0 and i % n == 0:
                    self.closing.add(g)
                i += 1
        self.rng = rng
        self.cycle = traffic["frame_cycle"]
        size = dm.vision.image
        gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63) + 1)
        pix = torch.empty((self.seats, self.cycle, 1, 3, size, size), device=device,
                          dtype=torch.bfloat16).normal_(generator=gen)
        self.frames = pix.cpu()
        self._joined = {s: None for s in range(self.seats)}

    def first_moment(self) -> int:
        return min(self.moments) if self.moments else 0

    def closes_cycle(self, g: int) -> bool:
        """Frame g is the moment that completes a whole pool of moments
        after the first (the warm-up's); no moments: every frame."""
        return not self.moments or g in self.closing

    def fires(self, seat: int, g: int):
        """The line's max_new_tokens if seat's gate fires at frame g, else None."""
        m = self.moments.get(g)
        return m[1] if m is not None and seat in m[0] else None

    def viewer_at(self, seat: int, g: int):
        """(viewer, new) of the viewer in ``seat`` at frame g, a dict of its
        sid, prompt ids and clip end; a viewer leaves once its clip is over."""
        cur = self._joined[seat]
        if cur is not None and (cur["end"] is None or g < cur["end"]):
            return cur, False
        k = len(self.viewers[seat])
        if self.moments:
            n = self.prompt_len.next()
            prompt = [1] + self.rng.integers(3, self.vocab, n - 1).tolist()
            v = dict(sid=f"s{seat}v{k}", prompt=prompt, end=g + self.clip.next())
        else:
            v = dict(sid=f"s{seat}v{k}", prompt=None, end=None)
        self.viewers[seat].append(v)
        self._joined[seat] = v
        return v, True

    def frame(self, seat: int, g: int) -> torch.Tensor:
        return self.frames[seat, g % self.cycle]


class StandInTokenizer:
    """Character-level stand-in: ids 3..202, BOS 1, EOS 2, at most 24 ids
    a call.  Served text is the ids, joined."""

    bos_token_id = 1
    eos_token_id = 2
    eos_token = "</s>"

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([self.bos_token_id] + [3 + (ord(c) % 200) for c in text][:24])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


# -- the port, built and swapped for recording subclasses -------------------------------------
def port_config(config: dict):
    from streammind_torch.config import (MambaConfig, StreamMindConfig, TextConfig, VisionConfig,
                                         text_config_from_hf)

    sm = config["streammind"]
    v, m, g = sm["vision"], sm["mamba"], sm["gate"]
    return StreamMindConfig(
        vision=VisionConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                            hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                            num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
                            layer_norm_eps=v["layer_norm_eps"], select_layer=v["select_layer"],
                            select_feature=v["select_feature"]),
        mamba=MambaConfig(d_model=m["d_model"], d_state=m["d_state"], d_conv=m["d_conv"],
                          expand=m["expand"], dt_rank=m["dt_rank"], conv_bias=m["conv_bias"],
                          bias=m["bias"], layer_norm_eps=m["layer_norm_eps"], n_layers=m["n_layers"]),
        text=text_config_from_hf(config),
        gate=TextConfig(vocab_size=g["vocab_size"], hidden_size=g["hidden_size"],
                        intermediate_size=g["intermediate_size"], num_layers=g["num_hidden_layers"],
                        num_heads=g["num_attention_heads"], num_kv_heads=g["num_key_value_heads"],
                        head_dim=g["head_dim"], rms_norm_eps=g["rms_norm_eps"],
                        rope_theta=g["rope_theta"]),
        mm_hidden_size=v["hidden_size"], max_stream_frames=sm["max_stream_frames"])


class Recorder:
    """Host stamps, counters, turn inputs and sampled ticks of one run."""

    def __init__(self, trace: bool, pick):
        self.trace = trace
        self.window = False
        self.pick = pick            # draws the judged window ticks
        self.ticks = 0
        self.window_ticks = 0
        self.first = None           # the run's first tick, from a fresh stream state
        self.sampled = [None] * CHECK_TICKS
        self.tick_spans = []       # (t0, t1, fired) in the window
        self.prefills = []         # dict(k, bucket, offsets, lengths, t0, t1) in the window
        self.decodes = []          # dict(k, offsets, fed, gaps, steps, step_s, t0) in the window
        self.first_token_at = {}
        self.dialogues = {}        # sid -> list of segments (lists of items)
        self.cur_dids = None
        self.in_prefill = False
        self.routes = None          # expert ids collected during one forward (Mixtral)
        self.prefill_routes = None
        self.step_routes = []

    @property
    def captures(self) -> list:
        return [c for c in [self.first] + self.sampled if c is not None]

    def capture(self):
        """A capture for this tick, or None: the run's first tick, and
        CHECK_TICKS window ticks drawn uniformly over the whole window (a
        reservoir: tick i replaces a held one with probability k / (i + 1))."""
        if self.ticks == 0:
            self.first = {"tick": 0, "window": False}
            return self.first
        if not self.window:
            return None
        i = self.window_ticks
        slot = i if i < CHECK_TICKS else int(self.pick.integers(i + 1))
        if slot >= CHECK_TICKS:
            return None
        self.sampled[slot] = {"tick": self.ticks, "window": True}
        return self.sampled[slot]

    def span(self, name: str):
        if self.trace:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _swap_classes(broker, rec: Recorder):
    from streammind_torch.models import mistral
    from streammind_torch.streaming import engine as engine_mod
    from streammind_torch.streaming.multistream import MultiStreamServer
    from streammind_torch.streaming.paged import PagedDialogues

    srv = broker.server
    eng = srv.engine
    vit_forward = engine_mod.vit_forward
    moe_mlp = mistral._moe_mlp
    top_k = mistral.router_top_k
    hook = {"armed": False, "out": None}

    def vit_hooked(*a, **kw):
        out = vit_forward(*a, **kw)
        if hook["armed"]:
            hook["out"] = out.clone()
        return out

    def top_k_hooked(probs, k):
        vals, idx = top_k(probs, k)
        if rec.routes is not None:   # the experts each token took, a layer at a time
            rec.routes.append(idx.clone())
        return vals, idx

    def moe_hooked(*a, **kw):
        if rec.in_prefill and rec.trace:
            with torch.profiler.record_function("portbench.moe"):
                return moe_mlp(*a, **kw)
        return moe_mlp(*a, **kw)

    engine_mod.vit_forward = vit_hooked
    mistral._moe_mlp = moe_hooked
    mistral.router_top_k = top_k_hooked
    base_engine = type(eng)

    class RecEngine(base_engine):
        def perceive_step_batch(self, pixels, state, feed_mask=None):
            cap = self.capture
            if cap is not None:
                cap.update(pixels=pixels.clone(), feed=feed_mask.clone(),
                           conv=state.mamba.conv.clone(), ssm=state.mamba.ssm.clone(),
                           frame_idx=state.frame_idx.clone())
                hook["armed"] = True
            with rec.span("portbench.perceive"):
                probs, new = super().perceive_step_batch(pixels, state, feed_mask)
            if cap is not None:
                hook["armed"] = False
                rows = torch.arange(probs.shape[0], device=probs.device)
                slots = torch.clamp(cap["frame_idx"].long(), max=new.memory.shape[1] - 1)
                cap.update(feats=hook["out"], probs=probs.clone(),
                           memory=new.memory[rows, slots].clone(), ssm_after=new.mamba.ssm.clone())
                hook["out"] = None
                self.capture = None
            return probs, new

    class RecServer(MultiStreamServer):
        def step(self, frames):
            t0 = PC()
            cap = rec.capture()
            if cap is not None:
                self.engine.capture = cap
            with rec.span("portbench.tick"):
                out = super().step(frames)
            rec.ticks += 1
            if rec.window:
                rec.window_ticks += 1
                rec.tick_spans.append((t0, PC(), any(v is not None for v in out.values())))
            return out

    class RecPaged(PagedDialogues):
        def run_turns(self, dids, plans, memories, **kw):
            memories = list(memories)
            before = {d: self.lengths[d] for d in dids}
            items = []
            for d, p, mem in zip(dids, plans, memories):
                segs = rec.dialogues.setdefault(d, [[]])
                if before[d] == 0 and segs[-1]:
                    segs.append([])   # the pool was reset: a new sequence from position 0
                n = int(p.length)
                use = np.asarray(p.use_mem[:n], bool)
                idx = torch.as_tensor(np.asarray(p.mem_index[:n])[use].astype(np.int64),
                                      device=mem.device)
                items.append(dict(kind="prefill", ids=np.asarray(p.token_ids[:n]), use=use,
                                  mem=mem[0].index_select(0, idx).clone(), routes=None))
                segs[-1].append(items[-1])
            rec.cur_dids = list(dids)
            rec.step_routes = []
            toks = super().run_turns(dids, plans, memories, **kw)
            bucket = len(plans[0].token_ids)
            for r, (d, p, t) in enumerate(zip(dids, plans, toks)):
                n = int(p.length)
                if rec.prefill_routes is not None:   # (layers, K * bucket, k) expert ids
                    items[r]["routes"] = rec.prefill_routes[:, r * bucket: r * bucket + n]
                routes = None
                if t and rec.step_routes and rec.step_routes[0] is not None:
                    routes = torch.stack([rec.step_routes[j][:, r] for j in range(len(t))], dim=1)
                rec.dialogues[d][-1].append(dict(kind="gen", toks=list(t), judged=rec.window,
                                                 routes=routes))
                if self.lengths[d] != before[d] + n + len(t):
                    raise RuntimeError(f"dialogue {d}: pool length {self.lengths[d]} is not "
                                       f"{before[d]} + {n} + {len(t)}")
            if rec.window and rec.decodes:
                rec.decodes[-1]["fed"] = [len(t) for t in toks]
            return toks

        def _prefill(self, table, length, plans, memory):
            t0 = PC()
            rec.in_prefill, rec.routes = True, []
            try:
                with rec.span("portbench.prefill"):
                    out = super()._prefill(table, length, plans, memory)
            finally:
                rec.in_prefill = False
            rec.prefill_routes = torch.stack(rec.routes) if rec.routes else None
            rec.routes = None
            if rec.window:
                rec.prefills.append(dict(k=len(plans), bucket=len(plans[0].token_ids),
                                         offsets=[self.lengths[d] for d in rec.cur_dids],
                                         lengths=[int(p.length) for p in plans], t0=t0))
            return out

        def _decode_step(self, table, length, toks):
            t0 = PC()
            self._marks.append(t0)
            rec.routes = []
            with rec.span("portbench.decode_step"):
                out = super()._decode_step(table, length, toks)
            self._spans.append(PC() - t0)
            rec.step_routes.append(torch.stack(rec.routes) if rec.routes else None)
            rec.routes = None
            return out

        def _decode(self, table, length, first, *a, **kw):
            t0 = PC()   # the first tokens are on the host here
            for d in rec.cur_dids:
                rec.first_token_at[d] = t0
            self._marks, self._spans = [], []
            out = super()._decode(table, length, first, *a, **kw)
            marks = [t0] + self._marks[1:] + [PC()] if self._marks else [t0]
            if rec.window:
                if rec.prefills:
                    rec.prefills[-1]["t1"] = t0
                rec.decodes.append(dict(k=len(first), offsets=[int(n) for n in length], t0=t0,
                                        gaps=list(np.diff(marks)), steps=len(self._marks),
                                        step_s=list(self._spans)))
            return out

    eng.__class__ = RecEngine
    eng.capture = None
    srv.__class__ = RecServer
    srv.paged.__class__ = RecPaged

    def restore():
        engine_mod.vit_forward = vit_forward
        mistral._moe_mlp = moe_mlp
        mistral.router_top_k = top_k

    return restore


class Lockstep:
    """One client thread a seat; ``tick`` releases every client with its
    frame and returns once every submit has returned."""

    def __init__(self, broker, seats: int):
        self.broker = broker
        self.go = threading.Barrier(seats + 1)
        self.done = threading.Barrier(seats + 1)
        self.todo = {}
        self.results = {}
        self.stop = False
        self.threads = [threading.Thread(target=self._client, args=(s,), daemon=True)
                        for s in range(seats)]
        for th in self.threads:
            th.start()

    def _client(self, seat: int):
        while True:
            self.go.wait()
            if self.stop:
                return
            sid, frame = self.todo[seat]
            t0 = PC()
            try:
                r = self.broker.submit(sid, frame, timeout=1200)
            except Exception as e:  # noqa: BLE001 - a failed submit is counted, not fatal
                r = {"error": f"{type(e).__name__}: {e}"}
            self.results[seat] = (sid, t0, PC(), r)
            self.done.wait()

    def tick(self, todo: dict) -> dict:
        self.todo, self.results = todo, {}
        self.go.wait()
        self.done.wait()
        return self.results

    def close(self):
        self.stop = True
        try:
            self.go.wait(timeout=60)
        except threading.BrokenBarrierError:
            pass
        for th in self.threads:
            th.join(timeout=60)


def serve(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float):
    """Set up, warm up, measure, and hand back what the check and the
    metrics read: (record, weights, what the window counted)."""
    from streammind_torch.ops import _build
    from streammind_torch.serve import BatchedSessionBroker
    from streammind_torch.streaming import StreamMindEngine

    import weights as W

    dev = torch.device(device)
    dm = dims(config)
    if dev.type == "cuda":
        _build.build_all()
    tree = W.build(config, seed, dev)
    eng_kw = config["serving"]["engine"]
    engine = StreamMindEngine(tree, port_config(config), eos_token_id=config.get("eos_token_id", 2),
                              attn_impl=eng_kw["attn_impl"], quantize_gate=eng_kw["quantize_gate"],
                              device=dev)
    broker = BatchedSessionBroker(engine, capacity=traffic["streams"], kv_mode="paged",
                                  page_size=traffic["page_size"],
                                  max_wait_ms=traffic["max_wait_ms"])
    sched = Schedule(traffic, seed, dm, dev)
    rec = Recorder(trace, np.random.default_rng([seed, 2]))
    restore = _swap_classes(broker, rec)
    tok = StandInTokenizer()
    lock = Lockstep(broker, sched.seats)
    warm = max(WARMUP_TICKS, sched.first_moment() + 1 if sched.moments else 0)
    prof = None
    out = dict(frames_ok=0, frames_failed=0, events=[], window_s=None)
    g = 0

    def stop_trace(end: float):
        _note(f"stopping the profiler after {rec.window_ticks} ticks")
        prof.stop()
        _note("profiler stopped")
        out["trace_window"] = (t_win, end)
        out["prof"] = prof
    try:
        while True:
            if not rec.window and g >= warm:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                if trace:
                    prof = _start_profiler()
                    _note("profiler started")
                rec.window = True
                out["setup_s"] = PC() - t_start
                t_win = PC()
                counters0 = (broker.ticks, broker.frames_seen)
                trace_end = t_win + traffic.get("trace_seconds", seconds)
            if rec.window:
                now = PC()
                # the traced part ends after a moment's turn, never in half a turn;
                # the window after the turn that closes a whole pool of moments, so
                # every run's window holds the same work
                if prof is not None and now >= trace_end and (not sched.moments
                                                              or (g - 1) in sched.moments):
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
                _note(f"{rec.window_ticks} ticks traced")
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
    return rec, tree, out


def _note(msg: str) -> None:
    print(f"portbench: [{PC():.3f}] {msg}", file=sys.stderr, flush=True)


def _start_profiler():
    # every thread's ranges: the spans are taken on the broker's tick thread
    extra = {}
    try:
        extra["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False, profile_memory=False, **extra)
    prof.start()
    return prof


def run(cell, args, t_start: float, device: str = "cuda"):
    """The driver's entry: one run of a serving cell, measured and checked.
    Returns the run's record, with the program's compared numbers and, with
    ``args.control``, the control's."""
    import checks
    import tracing
    from reference import model as ref

    dm = dims(cell.config)
    rec, tree, out = serve(cell.config, cell.traffic, args.seed, args.seconds, bool(args.trace),
                           device, t_start)
    run = harness.RunRecord(cell)
    run.dm, run.rec, run.out = dm, rec, out
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
        cog = (checks.cognition(rec.dialogues, tree, dm, CHECK_DIALOGUES, args.seed, device,
                                control=control) if cell.traffic.get("moments") else None)
    prog, ctl = perc if control else (perc, {})
    if cog is not None:
        prog.update(cog[0])
        ctl.update(cog[1])
    run.numbers = prog
    run.control = ctl if control else None
    ticks = [c["tick"] for c in judged if c["window"]]
    run.sound = [("no failed submit", out["frames_failed"] == 0),
                 ("a window tick judged", len(ticks) >= 1)]
    run.notes = {"window_ticks": rec.window_ticks, "ticks_judged": ticks,
                 "errors": out.get("errors", [])[:3]}
    if cog is not None:
        run.sound.append(("a served token judged", cog[2] > 0))
        run.notes["tokens_judged"] = cog[2]
    return run
