"""Batched session broker: concurrent client sessions share ONE
MultiStreamServer.

Callers enqueue their stream's newest frame and block; one tick thread
collects every pending frame (waiting up to ``max_wait_ms`` for stragglers
once the first frame of a tick arrives), runs ONE batched perception step
and, when several gates fire together, ONE batched cognition turn
(``streaming/multistream.py``), then wakes the callers with their results.

Threading contract: results are sequence-tagged, so a caller that timed out
never receives a stale result for a LATER frame; a tick that raises (a
malformed frame) fails only that tick's callers, each with an ``"error"``
entry, not the thread; remove() wakes an in-flight caller with a closed
sentinel; idle sessions past ``ttl_s`` are evicted when the pool is full.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..streaming.multistream import MultiStreamServer
from ..utils.profiling import tracer


class BatchedSessionBroker:
    def __init__(self, engine, capacity: int = 8, max_wait_ms: float = 15.0,
                 ttl_s: float = 1800.0, kv_mode: str = "dense",
                 num_pages=None, page_size: int = 64):
        self.server = MultiStreamServer(
            engine, capacity=capacity, kv_mode=kv_mode,
            num_pages=num_pages, page_size=page_size,
        )
        self.capacity = capacity
        self.max_wait = max_wait_ms / 1000.0
        self.ttl_s = ttl_s
        self._cv = threading.Condition()
        # Serializes server.step() against lifecycle mutation (add/remove)
        # WITHOUT holding the condition lock across the whole model step —
        # submits/active/status calls only ever need _cv, so they stay
        # responsive during a long tick (a first tick builds the kernels).
        # Lock order: _step_lock before _cv, always.
        self._step_lock = threading.Lock()
        self._pending: Dict[str, Tuple[int, object]] = {}  # sid -> (seq, frame)
        self._results: Dict[str, Tuple[Optional[int], dict]] = {}
        self._last_used: Dict[str, float] = {}
        self._seq = 0
        self._stop = False
        self.ticks = 0          # observability: batched step invocations
        self.frames_seen = 0
        self._thread = threading.Thread(target=self._tick_loop, daemon=True)
        self._thread.start()

    def _slot(self, stream_id: str):
        return next((s for s in self.server.slots
                     if s is not None and s.stream_id == stream_id), None)

    # -- lifecycle (serialized with ticks via the same condition lock) ------
    def add(self, stream_id: str, tokenizer, prompt_ids=None,
            max_new_tokens: int = 128, gate_threshold: Optional[float] = None,
            temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
            sample_type: str = "all", sample_per: float = 0.5):
        with self._step_lock, self._cv:
            if len(self.server.active) >= self.capacity:
                self._evict_locked()
            self.server.add_stream(
                stream_id, tokenizer, prompt_ids=prompt_ids,
                max_new_tokens=max_new_tokens, gate_threshold=gate_threshold,
                temperature=temperature, top_k=top_k, top_p=top_p,
                sample_type=sample_type, sample_per=sample_per,
            )
            # a previous session with this (client-chosen) id may have left
            # an unclaimed closed-sentinel in _results — without this, the
            # NEW session's first submit would instantly return closed
            self._results.pop(stream_id, None)
            self._last_used[stream_id] = time.time()

    def _evict_locked(self):
        """Pool full: drop expired sessions, then the oldest idle one."""
        now = time.time()
        idle = [s.stream_id for s in self.server.slots
                if s is not None and s.stream_id not in self._pending]
        expired = [sid for sid in idle
                   if now - self._last_used.get(sid, 0) > self.ttl_s]
        victims = expired or sorted(
            idle, key=lambda sid: self._last_used.get(sid, 0)
        )[:1]
        if not victims:
            raise RuntimeError("no free stream slots (all sessions mid-frame)")
        for sid in victims:
            self._remove_locked(sid)

    def _remove_locked(self, stream_id: str) -> dict:
        slot = self._slot(stream_id)
        if slot is None:
            raise KeyError(stream_id)
        out = {"turns": list(slot.turns), "intervals": list(slot.interval_ids)}
        self.server.remove_stream(stream_id)
        self._pending.pop(stream_id, None)
        self._last_used.pop(stream_id, None)
        # wake any in-flight submit with a closed sentinel (seq None
        # matches any waiter) instead of leaving it to time out — but only
        # when no unclaimed result is already posted: a tick may have
        # processed this session's frame (possibly a fired utterance) right
        # before eviction, and overwriting that would silently lose it
        self._results.setdefault(
            stream_id, (None, {"closed": True, "fire": False,
                               "text": None, "frame_idx": -1})
        )
        self._cv.notify_all()
        return out

    def remove(self, stream_id: str) -> dict:
        with self._step_lock, self._cv:
            return self._remove_locked(stream_id)

    def active(self) -> int:
        with self._cv:
            return len(self.server.active)

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # -- per-frame submission ------------------------------------------------
    def submit(self, stream_id: str, frame, timeout: float = 600.0) -> dict:
        """Enqueue this stream's newest frame; block until its tick lands.
        Returns {"fire": bool, "text": str|None, "frame_idx": int} (plus
        "closed": True if the session was removed mid-flight, or "error"
        if its tick raised).  The default timeout covers a first tick that
        builds the kernels: a timed-out caller leaves its frame queued, and
        its next submit waits for it."""
        deadline = time.time() + timeout
        with self._cv:
            if self._slot(stream_id) is None:
                raise KeyError(stream_id)
            while stream_id in self._pending:
                # one frame in flight per stream
                if not self._cv.wait(timeout=max(deadline - time.time(), 0.01)):
                    raise TimeoutError(f"stream {stream_id}: previous frame stuck")
            self._seq += 1
            my_seq = self._seq
            self._pending[stream_id] = (my_seq, frame)
            self._last_used[stream_id] = time.time()
            self._cv.notify_all()
            while True:
                entry = self._results.get(stream_id)
                if entry is not None:
                    seq, result = entry
                    if seq is None or seq == my_seq:
                        self._results.pop(stream_id)
                        return result
                    # stale result from a frame whose caller timed out —
                    # discard so it is never attributed to THIS frame
                    self._results.pop(stream_id)
                    continue
                if not self._cv.wait(timeout=max(deadline - time.time(), 0.01)):
                    raise TimeoutError(f"stream {stream_id}: tick timed out")

    # -- the tick loop ---------------------------------------------------------
    def _tick_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.25)
                if self._stop:
                    return
                # the step about to run takes the server's next tick number,
                # the event id of this tick's spans
                tick = self.server.ticks
                with tracer.span("broker.collect", event=tick,
                                 active=len(self.server.active)) as span:
                    # batching window: once the first frame of a tick arrives,
                    # wait briefly for the other live streams' frames
                    deadline = time.time() + self.max_wait
                    while (len(self._pending) < len(self.server.active)
                           and time.time() < deadline and not self._stop):
                        self._cv.wait(timeout=max(deadline - time.time(), 0.001))
                    staged = dict(self._pending)
                    self._pending.clear()
                    frames = {sid: f for sid, (_, f) in staged.items()}
                    span.set(frames=len(staged))
            # The model step runs OUTSIDE the condition lock (submits keep
            # queueing meanwhile).
            # _step_lock keeps add/remove from mutating slots mid-step.
            with self._step_lock:
                try:
                    out = self.server.step(frames)
                    err = None
                except Exception as e:  # noqa: BLE001 — a bad frame must
                    # fail its tick's callers, not kill the serving plane
                    out = {}
                    err = f"{type(e).__name__}: {e}"
            with self._cv, tracer.span("broker.publish", event=tick):
                self.ticks += 1
                self.frames_seen += len(staged)
                now = time.time()
                for sid, (seq, _) in staged.items():
                    slot = self._slot(sid)
                    if slot is None:
                        # evicted between staging and publish — its frame
                        # never reached the model, so report closed, not a
                        # normal-looking silence
                        result = {"closed": True, "fire": False,
                                  "text": None, "frame_idx": -1}
                    elif err is not None:
                        result = {"error": err, "fire": False, "text": None,
                                  "frame_idx": int(slot.frame_idx)}
                    else:
                        text = out.get(sid)
                        result = {
                            "fire": text is not None,
                            "text": text,
                            "frame_idx": int(slot.frame_idx),
                        }
                    self._results[sid] = (seq, result)
                    self._last_used[sid] = now
                self._cv.notify_all()
