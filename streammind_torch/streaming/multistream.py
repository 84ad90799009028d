"""Continuous-batched multi-stream serving: many live streams on one card.

Every tick runs ONE batched perception step over all stream slots (the ViT
at B = S, one Mamba step over S rows, the gate LM at S rows), so weight
reads are shared by the streams.  Cognition is batched too: all slots
whose gates fire on the same tick share ONE prefill (plans padded to one
bucket) and ONE lockstep decode loop, so K simultaneous fires cost
max(len_k) decode steps instead of sum(len_k).

Two KV modes: "dense" (a static ring per stream; batched turns stack the
rings and pad K to a power of two) and "paged" (all dialogues share one
page pool, ``streaming/paged.py``; no K padding, since a padding row would
alias a live dialogue's pages).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..mm_utils import trim_at_stop_strings
from ..models.meta import bucket_length
from .engine import (
    StreamMindEngine,
    _float_dtype,
    build_turn_plan,
    decode_tokens_to_text,
    ensure_turn_capacity,
    post_turn_pending,
    rebuild_history_pending,
    run_cognition_turn,
    split_kv_cache,
    stack_kv_caches,
    stack_stop_ids,
    stop_id_matrix,
    turn_bucket,
    turn_suffix_ids,
)
from .memory_subsample import subsample_span
from .paged import PagedDialogues, PagePoolExhausted


@dataclasses.dataclass
class _Slot:
    stream_id: str
    tokenizer: object
    pending_ids: list
    cache: object
    interval_ids: list
    turns: list
    max_new_tokens: int = 128
    gate_threshold: Optional[float] = None
    last_fire: int = 0
    frame_idx: int = 0
    stop_ids: Optional[object] = None  # (S, L) matrix (engine.stop_id_matrix)
    # per-stream request knobs: sampling, and memory-token subsampling
    # before the splice ('all' | 'log' | 'similarity')
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    sample_type: str = "all"
    sample_per: float = 0.5


class MultiStreamServer:
    """Fixed-capacity pool of live streams over one engine."""

    def __init__(self, engine: StreamMindEngine, capacity: int = 8,
                 batch_cognition: bool = True, kv_mode: str = "dense",
                 num_pages: Optional[int] = None, page_size: int = 64,
                 stop_strings: Optional[list] = None):
        """kv_mode="paged": all dialogues share ONE page pool; num_pages
        defaults to half the dense-equivalent page count, and on pool
        pressure the capacity guard resets dialogues with their recent
        turns re-carried as text."""
        self.engine = engine
        self.capacity = capacity
        self.batch_cognition = batch_cognition
        # server-wide stop strings: decode halts at the separator, and texts
        # are trimmed on the host
        self.stop_strings = list(stop_strings) if stop_strings else []
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode must be 'dense' or 'paged', got {kv_mode!r}")
        self.kv_mode = kv_mode
        self.paged = None
        if kv_mode == "paged":
            if num_pages is None:
                per_seq = -(-engine.kv_capacity // page_size)
                num_pages = max(capacity * per_seq // 2, per_seq)
            self.paged = PagedDialogues(engine, num_pages, page_size)
        # dense batched cognition pads the fired count to a power of two
        self._k_buckets = []
        k = 1
        while k < capacity:
            k *= 2
            self._k_buckets.append(min(k, capacity))
        self.state = engine.new_stream_state(capacity)
        self.slots: List[Optional[_Slot]] = [None] * capacity
        self.generator = torch.Generator(device=engine.device).manual_seed(0)
        size = engine.cfg.vision.image_size
        # the engine's weight dtype: an fp32 filler would promote the batch
        wt = _float_dtype(engine.params["vision"])
        self._pixel_dtype = wt if wt in (torch.bfloat16, torch.float32) else torch.float32
        self._zero_frame = torch.zeros((1, 3, size, size), dtype=self._pixel_dtype,
                                       device=engine.device)

    # -- lifecycle ---------------------------------------------------------
    def add_stream(self, stream_id: str, tokenizer, prompt_ids: Optional[list] = None,
                   max_new_tokens: int = 128, gate_threshold: Optional[float] = None,
                   temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                   sample_type: str = "all", sample_per: float = 0.5) -> int:
        """Attach a live stream; returns its slot.  Each batched row halts on
        its own stop matrix, so streams may use different tokenizers."""
        if any(s is not None and s.stream_id == stream_id for s in self.slots):
            raise ValueError(f"stream id {stream_id!r} is already attached")
        for i, s in enumerate(self.slots):
            if s is None:
                if self.paged is not None:
                    self.paged.open(stream_id)
                self.slots[i] = _Slot(
                    stream_id=stream_id, tokenizer=tokenizer,
                    pending_ids=list(prompt_ids) if prompt_ids else [],
                    cache=None if self.paged is not None else self.engine.new_kv_cache(),
                    interval_ids=[], turns=[], max_new_tokens=max_new_tokens,
                    gate_threshold=gate_threshold,
                    stop_ids=(stop_id_matrix(tokenizer, self.stop_strings)
                              if self.stop_strings else None),
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    sample_type=sample_type, sample_per=sample_per,
                )
                self._reset_slot_state(i)
                return i
        raise RuntimeError("no free stream slots")

    def remove_stream(self, stream_id: str) -> None:
        for i, s in enumerate(self.slots):
            if s is not None and s.stream_id == stream_id:
                if self.paged is not None:
                    self.paged.close(stream_id)  # reclaim its pages
                self.slots[i] = None
                self._reset_slot_state(i)
                return
        raise KeyError(stream_id)

    def _reset_slot_state(self, i: int) -> None:
        """Zero slot i's carried state (in place) without touching others."""
        st = self.state
        for t in (st.mamba.conv[:, i], st.mamba.ssm[:, i], st.memory[i], st.frame_idx[i],
                  st.last_fire[i]):
            t.zero_()

    @property
    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    # -- the serve tick ----------------------------------------------------
    def step(self, frames: Dict[str, object]) -> Dict[str, Optional[str]]:
        """One tick: feed each active stream's newest frame (streams without
        a frame this tick get a zero frame, keep their state frozen and are
        left out of the gate decision).  Returns {stream_id: utterance or
        None} for the fed streams."""
        if not self.active:
            return {}
        dev = self.engine.device
        batch, fed = [], []
        for i in range(self.capacity):
            slot = self.slots[i]
            if slot is not None and slot.stream_id in frames:
                batch.append(torch.as_tensor(frames[slot.stream_id]).to(
                    device=dev, dtype=self._pixel_dtype).reshape(self._zero_frame.shape))
                fed.append(i)
            else:
                batch.append(self._zero_frame)
        feed_mask = torch.zeros((self.capacity,), dtype=torch.bool)
        feed_mask[fed] = True
        gate_probs, self.state = self.engine.perceive_step_batch(
            torch.cat(batch, dim=0), self.state, feed_mask.to(dev))
        probs = gate_probs.cpu().numpy()

        out: Dict[str, Optional[str]] = {}
        fired: List[int] = []
        for i in fed:
            slot = self.slots[i]
            slot.frame_idx += 1
            p = probs[i]
            threshold = p[0] if slot.gate_threshold is None else slot.gate_threshold
            if p[1] > threshold:
                fired.append(i)
            else:
                out[slot.stream_id] = None
        for i, text in self._cognify_slots(fired).items():
            out[self.slots[i].stream_id] = text
        return out

    # -- cognition ----------------------------------------------------------
    def _trim(self, text: str) -> str:
        return trim_at_stop_strings(text, self.stop_strings) if self.stop_strings else text

    def _slot_span(self, i: int) -> list:
        slot = self.slots[i]
        cur = min(slot.frame_idx, self.engine.cfg.max_stream_frames)
        start = min(slot.last_fire, cur)
        span = list(range(start, cur)) or [max(cur - 1, 0)]
        if slot.sample_type not in (None, "all"):
            span = subsample_span(span, self.state.memory[i:i + 1], slot.sample_type,
                                  slot.sample_per)
        return span

    def _finish_turn(self, i: int, tokens: list) -> str:
        """Book a turn's tokens on slot i; returns the utterance."""
        slot = self.slots[i]
        text = self._trim(decode_tokens_to_text(slot.tokenizer, tokens))
        slot.turns.append(text)
        slot.pending_ids = post_turn_pending(slot.tokenizer)
        slot.last_fire = min(slot.frame_idx, self.engine.cfg.max_stream_frames)
        return text

    def _shared_bucket(self, fired: List[int], spans: dict) -> int:
        eng, shared = self.engine, 0
        for i in fired:
            slot = self.slots[i]
            n = len(turn_suffix_ids(slot.tokenizer, slot.pending_ids)) - 1 + len(spans[i])
            shared = max(shared, bucket_length(min(n, eng.buckets[-1]), eng.buckets))
        return shared

    def _fits_bucket(self, i: int, span: list, shared: int) -> bool:
        slot = self.slots[i]
        return len(turn_suffix_ids(slot.tokenizer, slot.pending_ids)) - 1 + len(span) <= shared

    # -- paged-pool capacity management -------------------------------------
    def _paged_slot_capacity(self) -> int:
        return min(self.engine.kv_capacity, self.paged.dialogue_capacity)

    def _reset_paged_slot(self, i: int, span_len: int, min_bucket: int = 0) -> None:
        """Reclaim slot i's pages and re-carry its recent turns as text."""
        slot = self.slots[i]
        self.paged.reset(slot.stream_id)
        slot.pending_ids = rebuild_history_pending(
            self.engine, slot.tokenizer, slot.turns, slot.pending_ids, span_len,
            slot.max_new_tokens, min_bucket=min_bucket, capacity=self._paged_slot_capacity())

    def _paged_capacity_guard(self, i: int, span_len: int, min_bucket: int = 0) -> bool:
        """Make room for one turn of slot i on the shared pool and RESERVE it
        (ensure_capacity allocates now, so the slots of one tick see each
        other's claims).  Two pressures, each answered with reset + text
        re-carry: the dialogue's own page budget (reset slot i), and a dry
        pool (reset the biggest other dialogues first, then slot i).
        Returns True if any dialogue was reset."""
        slot, pd = self.slots[i], self.paged
        did = slot.stream_id
        changed = False
        bucket = turn_bucket(self.engine, len(slot.pending_ids), span_len, min_bucket)
        if pd.lengths[did] + bucket + slot.max_new_tokens > self._paged_slot_capacity():
            self._reset_paged_slot(i, span_len, min_bucket)
            changed = True
            bucket = turn_bucket(self.engine, len(slot.pending_ids), span_len, min_bucket)

        def reserve():
            try:
                pd.ensure_capacity(did, bucket + slot.max_new_tokens)
                return True
            except PagePoolExhausted:
                return False

        if reserve():
            return changed
        victims = sorted((j for j, s in enumerate(self.slots)
                          if s is not None and j != i and pd.tables[s.stream_id]),
                         key=lambda j: -len(pd.tables[self.slots[j].stream_id]))
        for j in victims:
            if reserve():
                break
            # size the victim's rebuilt history for its real pending span
            vs = self.slots[j]
            v_span = max(1, min(vs.frame_idx, self.engine.cfg.max_stream_frames) - vs.last_fire)
            self._reset_paged_slot(j, v_span, 0)
            changed = True
        if not reserve() and pd.tables[did]:
            self._reset_paged_slot(i, span_len, min_bucket)
            changed = True
            bucket = turn_bucket(self.engine, len(slot.pending_ids), span_len, min_bucket)
        if not reserve():
            raise PagePoolExhausted(f"pool of {pd.pool.num_pages - 1} allocatable pages cannot "
                                    f"hold one turn (bucket {bucket} + {slot.max_new_tokens} "
                                    f"decode)")
        return changed

    def _cognify_slots(self, fired: List[int]) -> Dict[int, str]:
        """One cognition turn for every fired slot; two or more fires on a
        tick share one batched prefill and one lockstep decode."""
        if not fired:
            return {}
        if len(fired) == 1 or not self.batch_cognition:
            return {i: self._cognify_slot(i) for i in fired}
        if self.paged is not None:
            return self._cognify_slots_paged(fired)

        eng = self.engine
        spans = {i: self._slot_span(i) for i in fired}
        # capacity guard with a SHARED bucket, to a fixpoint (a history
        # re-carry can grow a slot's own bucket)
        shared = 0
        for _ in range(4):
            shared = max(shared, self._shared_bucket(fired, spans))
            changed = False
            for i in fired:
                slot = self.slots[i]
                new_pending, new_cache = ensure_turn_capacity(
                    eng, slot.tokenizer, slot.pending_ids, slot.turns, slot.cache,
                    len(spans[i]), slot.max_new_tokens, min_bucket=shared)
                changed |= new_cache is not slot.cache
                slot.pending_ids, slot.cache = new_pending, new_cache
            if not changed:
                break
        # a slot the shared bucket still cannot fit runs its own turn
        rows, odd = [], []
        for i in fired:
            slot = self.slots[i]
            budget = int(slot.cache.length[0]) + shared + slot.max_new_tokens
            ok = budget <= eng.kv_capacity and self._fits_bucket(i, spans[i], shared)
            (rows if ok else odd).append(i)
        texts: Dict[int, str] = {i: self._cognify_slot(i, spans[i]) for i in odd}
        if len(rows) == 1:
            texts[rows[0]] = self._cognify_slot(rows[0], spans[rows[0]])
        if len(rows) < 2:
            return texts

        K = len(rows)
        pad = next((b for b in self._k_buckets if b >= K), K) - K
        padded = rows + [rows[0]] * pad  # inactive padding rows reuse row 0's inputs
        plans = [build_turn_plan(eng, self.slots[i].tokenizer, spans[i],
                                 self.slots[i].pending_ids, pad_to=shared) for i in padded]
        memory = self.state.memory[torch.tensor(padded, device=eng.device)]
        cache = stack_kv_caches([self.slots[i].cache for i in padded])
        last, cache = eng.prefill_batch(plans, memory, cache)
        tok_lists, _, cache = eng.generate_from_prefill_batch(
            last, cache, [self.slots[i].max_new_tokens for i in rows] + [0] * pad,
            active=[True] * K + [False] * pad,
            temperature=[self.slots[i].temperature for i in rows] + [0.0] * pad,
            top_k=[self.slots[i].top_k for i in rows] + [0] * pad,
            top_p=[self.slots[i].top_p for i in rows] + [0.0] * pad,
            generator=self.generator,
            stop_ids=stack_stop_ids([self.slots[i].stop_ids for i in rows] + [None] * pad))
        parts = split_kv_cache(cache, K)
        for j, i in enumerate(rows):
            self.slots[i].cache = parts[j]
            self.slots[i].interval_ids.append(self.slots[i].frame_idx)
            texts[i] = self._finish_turn(i, tok_lists[j])
        return texts

    def _cognify_slots_paged(self, fired: List[int]) -> Dict[int, str]:
        """Batched paged cognition: the fired dialogues share one bucket, one
        prefill and one lockstep decode over the page pool."""
        eng, pd = self.engine, self.paged
        spans = {i: self._slot_span(i) for i in fired}
        # shared-bucket fixpoint (a reset's re-carry can change any slot's bucket)
        shared = 0
        for _ in range(4):
            shared = max(shared, self._shared_bucket(fired, spans))
            changed = False
            for i in fired:
                changed |= self._paged_capacity_guard(i, len(spans[i]), min_bucket=shared)
            if not changed:
                break
        # rows the shared bucket still cannot fit, or that another row's
        # pressure reset left unreserved, run their own turns
        cap = self._paged_slot_capacity()
        rows, odd = [], []
        for i in fired:
            slot = self.slots[i]
            did = slot.stream_id
            ok = (pd.lengths[did] + shared + slot.max_new_tokens <= cap
                  and self._fits_bucket(i, spans[i], shared)
                  and pd.pages_needed(did, shared + slot.max_new_tokens) == 0)
            (rows if ok else odd).append(i)
        # batched rows FIRST: an odd turn's guard may pressure-reset a batched
        # row, which would void the classification above
        texts: Dict[int, str] = {}
        if len(rows) == 1:
            texts[rows[0]] = self._cognify_slot(rows[0], spans[rows[0]])
        elif rows:
            plans = [build_turn_plan(eng, self.slots[i].tokenizer, spans[i],
                                     self.slots[i].pending_ids, pad_to=shared) for i in rows]
            tok_lists = pd.run_turns(
                [self.slots[i].stream_id for i in rows], plans,
                [self.state.memory[i:i + 1] for i in rows],
                max_new_tokens=[self.slots[i].max_new_tokens for i in rows],
                temperature=[self.slots[i].temperature for i in rows],
                top_k=[self.slots[i].top_k for i in rows],
                top_p=[self.slots[i].top_p for i in rows],
                generator=self.generator,
                stop_ids=stack_stop_ids([self.slots[i].stop_ids for i in rows]))
            for j, i in enumerate(rows):
                self.slots[i].interval_ids.append(self.slots[i].frame_idx)
                texts[i] = self._finish_turn(i, tok_lists[j])
        for i in odd:
            texts[i] = self._cognify_slot(i, spans[i])
        return texts

    def _cognify_slot(self, i: int, span: Optional[list] = None) -> str:
        slot = self.slots[i]
        cur = min(slot.frame_idx, self.engine.cfg.max_stream_frames)
        if span is None:
            span = self._slot_span(i)
        memory_row = self.state.memory[i:i + 1]
        slot.interval_ids.append(slot.frame_idx)
        if self.paged is not None:
            self._paged_capacity_guard(i, len(span))
            plan = build_turn_plan(self.engine, slot.tokenizer, span, slot.pending_ids)
            toks = self.paged.run_turn(
                slot.stream_id, plan, memory_row, max_new_tokens=slot.max_new_tokens,
                stop_ids=slot.stop_ids, temperature=slot.temperature, top_k=slot.top_k,
                top_p=slot.top_p, generator=self.generator)
            return self._finish_turn(i, toks)
        slot.pending_ids, slot.cache = ensure_turn_capacity(
            self.engine, slot.tokenizer, slot.pending_ids, slot.turns, slot.cache, len(span),
            slot.max_new_tokens)
        text, _, slot.pending_ids, slot.cache = run_cognition_turn(
            self.engine, slot.tokenizer, memory_row, span, slot.pending_ids, slot.cache,
            slot.max_new_tokens, stop_ids=slot.stop_ids, temperature=slot.temperature,
            top_k=slot.top_k, top_p=slot.top_p, generator=self.generator)
        text = self._trim(text)
        slot.turns.append(text)
        slot.last_fire = cur
        return text
