"""Paged KV cache: many dialogues share one page pool on the card.

In place of a static ring per dialogue (capacity 8192 ≈ 1.07 GB at 7B
bf16), one SHARED pool of fixed-size pages plus a page table per dialogue,
so resident memory tracks the sum of the dialogues' actual lengths.  The
decoder's layers run in ``models/mistral.py::decoder_forward`` over the
pool's store (``_PoolStore``).  The decode hot path runs one hand-written
kernel a layer (``ops/paged_attention.py``): the one-token pool write and
the one-token attention over page tables, in one launch.

Layout, per layer:
  pool.k/v: tuples of (Hkv, num_pages, page_size, D)
  table:    (B, max_pages_per_seq) int32 pool page ids
  length:   (B,) int32 valid tokens
Page 0 is the write sink: never given to a dialogue, it takes zero-padded
table entries and the writes of finished rows past their table.  Pool
writes happen in place.

A hybrid decoder (Jamba, ``models/jamba.py``) keeps pages for its
attention layers only, and beside them a recurrent-state pool: a slot a
dialogue holding every Mamba layer's conv window and fp32 SSM state
(``RecurrentState``).  A prefill continues each row from its slot and
writes back the state at the row's real length; a decode step routes the
rows that have finished to slot 0, the state sink, as page 0 takes their
keys, so no lockstep step past a row's end touches its state.

On a CUDA device the lockstep decode step of K rows is captured once as
CUDA graphs and replayed (``_StepGraph``), so the card, not the host's
launches, sets its pace.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import TextConfig
from ..models import jamba
from ..models import mistral as lm
from ..models.meta import SplicePlan, splice_embeds
from ..ops.attention import flash_attention
from ..ops import paged_attention as _paged_attention
from ..ops.paged_attention import gather_seq, paged_decode_attention
from ..parallel.mesh import ambient_mesh, is_trivial
from ..utils.profiling import tracer

_PAGE_MULTIPLE = 8  # the JAX package's pool takes page sizes in whole 8-row tiles


class PagedKV(NamedTuple):
    """Shared page pool: k/v are per-layer tuples of (Hkv, P, page_size, D)."""

    k: tuple
    v: tuple

    @property
    def page_size(self) -> int:
        return self.k[0].shape[2]

    @property
    def num_pages(self) -> int:
        return self.k[0].shape[1]


def init_page_pool(cfg: TextConfig, num_pages: int, page_size: int = 64, dtype=torch.bfloat16,
                   device="cuda") -> PagedKV:
    """Pages for each attention layer of the decoder (every layer, but a
    hybrid's Mamba layers)."""
    if page_size % _PAGE_MULTIPLE != 0:
        raise ValueError(f"page_size must be a multiple of {_PAGE_MULTIPLE}, got {page_size}")
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    layers = sum(cfg.is_attention(i) for i in range(cfg.num_layers))
    return PagedKV(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)),
    )


class RecurrentState(NamedTuple):
    """Mamba layers' states, a row a dialogue (or a slot of the pool):
    conv (Lm, rows, d_inner, d_conv) in the model's dtype, ssm (Lm, rows,
    d_inner, d_state) fp32."""

    conv: torch.Tensor
    ssm: torch.Tensor

    def gather(self, slots: torch.Tensor) -> "RecurrentState":
        """The rows of these slots (a (K,) long tensor), copied."""
        return RecurrentState(self.conv.index_select(1, slots), self.ssm.index_select(1, slots))

    def scatter(self, slots: torch.Tensor, rows: "RecurrentState") -> None:
        """Write K rows back into their slots, in place."""
        self.conv.index_copy_(1, slots, rows.conv)
        self.ssm.index_copy_(1, slots, rows.ssm)


def init_state_pool(cfg: TextConfig, slots: int, dtype=torch.bfloat16,
                    device="cuda") -> RecurrentState:
    """Zeroed states of every Mamba layer of a hybrid decoder, ``slots`` rows."""
    m = jamba.mamba_sizes(cfg)
    layers = jamba.layer_counts(cfg)["mamba"]
    return RecurrentState(
        conv=torch.zeros((layers, slots, m.d_inner, m.d_conv), dtype=dtype, device=device),
        ssm=torch.zeros((layers, slots, m.d_inner, m.d_state), dtype=torch.float32,
                        device=device))


def _write_block(pool_k, pool_v, k_new, v_new, table, length, page_size):
    """Write a (B, S, Hkv, D) prefill block (S > 1, once a turn) into the
    pool at positions length..length+S-1 of each row, in place, by a
    scatter.  A decode step's one token a row is written by
    ``paged_decode_attention`` in its own launch."""
    s = k_new.shape[1]
    maxp = table.shape[1]
    pos = length.long()[:, None] + torch.arange(s, device=length.device)[None, :]
    page_slot = torch.gather(table.long(), 1, torch.clamp(pos // page_size, max=maxp - 1))
    offset = pos % page_size
    pool_k[:, page_slot, offset] = k_new.permute(2, 0, 1, 3).to(pool_k.dtype)
    pool_v[:, page_slot, offset] = v_new.permute(2, 0, 1, 3).to(pool_v.dtype)


class _PoolStore(NamedTuple):
    """The pool as the decoder's store (``lm.decoder_forward``): the rows'
    page tables and the lengths their blocks start at."""

    pool: PagedKV
    table: torch.Tensor
    length: torch.Tensor

    def attend(self, j: int, q, k, v):
        """Attention layer j: the block's K/V written into the pool, then q
        over each row's valid prefix through its table."""
        pool_k, pool_v, table, length = self.pool.k[j], self.pool.v[j], self.table, self.length
        s = q.shape[1]
        if s == 1:  # write the token and attend, in one launch
            return paged_decode_attention(q, pool_k, pool_v, table, length,
                                          k_new=k[:, 0], v_new=v[:, 0])
        _write_block(pool_k, pool_v, k, v, table, length, self.pool.page_size)
        k_seq = gather_seq(pool_k, table).to(q.dtype)
        v_seq = gather_seq(pool_v, table).to(q.dtype)
        return flash_attention(q, k_seq, v_seq, causal=True, kv_len=length + s, q_offset=length)


def paged_text_forward(params, cfg: TextConfig, pool: PagedKV, table: torch.Tensor,
                       length: torch.Tensor, input_ids: Optional[torch.Tensor] = None,
                       inputs_embeds: Optional[torch.Tensor] = None,
                       state: Optional[RecurrentState] = None,
                       real_len: Optional[torch.Tensor] = None):
    """The decoder's cached forward over the paged pool: append the block at
    ``length`` (B,), attend to the whole valid prefix, return (fp32 logits,
    pool).  The pool is written in place; lengths are tracked by the caller.

    A hybrid decoder's Mamba layers continue ``state`` (the B rows' states)
    and write their new states into it in place: after one token a row,
    or, for a block, after each row's first ``real_len`` tokens."""
    logits = lm.decoder_forward(params, cfg, _PoolStore(pool, table, length), input_ids,
                                inputs_embeds, state=state, real_len=real_len)
    return logits, pool


# ---------------------------------------------------------------------------
# the decode step as CUDA graphs
# ---------------------------------------------------------------------------
def decode_graphed(device, params, cfg: TextConfig) -> bool:
    """Whether decode steps on ``device`` replay CUDA graphs (``_StepGraph``):
    on a CUDA device, with no sharded mesh around them (collectives stay
    eager), outside autograd, and for a MoE decoder only where its expert
    ids stay on the card (``lm.moe_ids_on_device``).  Elsewhere the step
    runs eagerly."""
    device = torch.device(device)
    return (device.type == "cuda" and is_trivial(ambient_mesh()) and not torch.is_grad_enabled()
            and (cfg.num_experts <= 1 or lm.moe_ids_on_device(params, cfg, device)))


class _StepGraph:
    """The lockstep decode step of K rows over static buffers (ids (K, 1),
    lengths (K,), the table (K, max_pages), a hybrid's state-slot ids (K,);
    the logits (K, V)), captured once as CUDA graphs and replayed.

    A dense decoder's step is one graph.  A MoE decoder's capture breaks at
    each layer's routing (``lm.routing_breaks``): a piece ends with the
    router's fp32 softmax, ``lm.router_top_k`` (looked up on the module at
    call time) runs eagerly on it, its weights and ids are copied into
    static buffers, and the next piece begins with their renormalisation
    and the experts' indexed launches: MoE layers + 1 graphs a step.  The
    capture records the pieces back to back and routes nothing, since
    captured kernels do not run; ``run`` executes the same pieces without a
    capture, routing between them as ``replay`` does."""

    def __init__(self, paged: "PagedDialogues", K: int):
        cfg, dev = paged.engine.cfg.text, paged.engine.device
        self.paged = paged
        self.ids = torch.zeros((K, 1), dtype=torch.long, device=dev)
        self.length = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.table = torch.zeros((K, paged.max_pages), dtype=torch.int32, device=dev)
        self.slots = (torch.zeros((K,), dtype=torch.long, device=dev)
                      if paged.states is not None else None)
        moe = sum(cfg.is_moe(i) for i in range(cfg.num_layers))
        self.k = cfg.num_experts_per_tok
        self.topw = [torch.zeros((K, self.k), dtype=torch.float32, device=dev)
                     for _ in range(moe)]
        self.topi = [torch.zeros((K, self.k), dtype=torch.long, device=dev) for _ in range(moe)]
        self.probs: list = []     # each MoE layer's router softmax, a piece's output
        self.graphs: list = []
        self.logits = None
        self.counted = None       # what the capture counted, counted again each replay
        self._keep = None

    def load(self, table, length, ids) -> None:
        """The step's inputs, and a hybrid's slot ids (``paged._step_slots``)."""
        self.table.copy_(table)
        self.length.copy_(length)
        self.ids.copy_(ids)
        if self.slots is not None:
            self.slots.copy_(self.paged._step_slots)

    def _route(self, i: int) -> None:
        topw, topi = lm.router_top_k(self.probs[i], self.k)
        self.topw[i].copy_(topw)
        self.topi[i].copy_(topi)

    def _pieces(self, between) -> torch.Tensor:
        """The step's forward over the static buffers, ``between(i)`` called
        where MoE layer i's routing breaks it (the layer then takes the
        static weights and ids): its (K, V) logits."""
        def broken(probs, k):
            self.probs.append(probs)
            i = len(self.probs) - 1
            between(i)
            return self.topw[i], self.topi[i]

        self.probs = []
        with lm.routing_breaks(broken):
            return self.paged._forward(self.table, self.length, self.ids, self.slots)

    def run(self) -> torch.Tensor:
        """The step piece by piece, without a capture: its (K, V) logits."""
        return self._pieces(self._route)

    def capture(self, side: torch.cuda.Stream, pool) -> None:
        """Record the pieces on the side stream into ``pool``; the paged
        attention's scratch is kept with them (a later, larger K grows a
        new one)."""
        def begin():
            self.graphs.append(torch.cuda.CUDAGraph())
            self.graphs[-1].capture_begin(pool=pool, capture_error_mode="thread_local")

        def between(i):
            self.graphs[-1].capture_end()
            begin()

        self._keep = _paged_attention._scratch.get(self.ids.device)
        side.wait_stream(torch.cuda.current_stream(self.ids.device))
        with torch.cuda.stream(side), tracer.recording() as self.counted:
            begin()
            try:
                self.logits = self._pieces(between)
            finally:
                self.graphs[-1].capture_end()
        torch.cuda.current_stream(self.ids.device).wait_stream(side)

    def replay(self) -> torch.Tensor:
        """One step over the loaded buffers: a fresh tensor of its logits."""
        self.graphs[0].replay()
        for i, graph in enumerate(self.graphs[1:]):
            self._route(i)
            graph.replay()
        self.counted.replay()
        return self.logits.clone()


# ---------------------------------------------------------------------------
# host-side page allocator + per-dialogue state
# ---------------------------------------------------------------------------
class PagePoolExhausted(RuntimeError):
    pass


class PagedDialogues:
    """Host allocator and turn programs for N dialogues on one shared pool.

    Each dialogue owns a page table (host list) and a token length, and
    under a hybrid decoder a slot of the recurrent-state pool.  When the
    pool runs dry, ensure_capacity raises PagePoolExhausted; the serving
    layer then resets dialogues (reclaims their pages, zeroes their state,
    re-carries their recent turns as text).  ``max_dialogues``: how many
    dialogues a hybrid's state pool holds open at once."""

    def __init__(self, engine, num_pages: int, page_size: int = 64,
                 max_pages_per_seq: Optional[int] = None, dtype=None,
                 max_dialogues: int = 8):
        from .engine import _float_dtype

        self.engine = engine
        self.page_size = page_size
        if dtype is None:
            dtype = _float_dtype(engine.params["text"])
        cfg = engine.cfg.text
        # num_pages allocatable pages plus the physical sink page 0
        self.pool = init_page_pool(cfg, num_pages + 1, page_size, dtype, device=engine.device)
        self.max_pages = max_pages_per_seq or min(num_pages, -(-engine.kv_capacity // page_size))
        self._free: List[int] = list(range(1, num_pages + 1))
        self.tables: dict = {}   # dialogue id -> list of page ids
        self.lengths: dict = {}  # dialogue id -> int
        self._graphs: dict = {}  # K -> _StepGraph
        self._side = self._graph_pool = None
        # a hybrid's states: max_dialogues slots plus the sink slot 0
        self.states = (init_state_pool(cfg, max_dialogues + 1, dtype, engine.device)
                       if cfg.hybrid else None)
        self._free_slots: List[int] = list(range(max_dialogues, 0, -1))
        self.slots: dict = {}       # dialogue id -> its state slot
        self._turn_slots = None     # the turn's rows' slots (host ints), set by run_turns
        self._turn_state = None     # the prefill's rows' states, between gather and write-back
        self._step_slots = None     # (K,) a decode step's slots on the card, 0 for finished rows

    # -- allocator ---------------------------------------------------------
    def open(self, did: str) -> None:
        if did in self.tables:
            raise ValueError(f"dialogue {did!r} already open")
        if self.states is not None:
            if not self._free_slots:
                raise ValueError(f"no free state slot for dialogue {did!r}: "
                                 f"{len(self.slots)} dialogues open")
            self.slots[did] = self._free_slots.pop()
            self._zero_state(did)
        self.tables[did] = []
        self.lengths[did] = 0

    def close(self, did: str) -> None:
        self._free.extend(self.tables.pop(did))
        del self.lengths[did]
        if self.states is not None:
            self._free_slots.append(self.slots.pop(did))

    def _zero_state(self, did: str) -> None:
        slot = self.slots[did]
        self.states.conv[:, slot].zero_()
        self.states.ssm[:, slot].zero_()
        tracer.count("paged.state_resets")

    def free_pages(self) -> int:
        return len(self._free)

    @property
    def dialogue_capacity(self) -> int:
        """Most tokens one dialogue can hold (its page budget)."""
        return self.max_pages * self.page_size

    def reset(self, did: str) -> None:
        """Reclaim a dialogue's pages and zero its state but keep it open
        (the caller re-carries recent turns as text)."""
        self._free.extend(self.tables[did])
        self.tables[did] = []
        self.lengths[did] = 0
        if self.states is not None:
            self._zero_state(did)

    def pages_needed(self, did: str, n_tokens: int) -> int:
        """How many NEW pages ensure_capacity(did, n_tokens) would allocate."""
        need_total = -(-(self.lengths[did] + n_tokens) // self.page_size)
        return max(need_total - len(self.tables[did]), 0)

    def ensure_capacity(self, did: str, n_tokens: int) -> None:
        """Allocate pages so dialogue ``did`` can hold n_tokens more tokens."""
        need_total = -(-(self.lengths[did] + n_tokens) // self.page_size)
        grow = need_total - len(self.tables[did])
        if need_total > self.max_pages:
            raise PagePoolExhausted(f"dialogue {did!r} needs {need_total} pages > per-seq max "
                                    f"{self.max_pages}")
        if grow > len(self._free):
            raise PagePoolExhausted(f"pool dry: need {grow} pages, {len(self._free)} free")
        for _ in range(max(grow, 0)):
            self.tables[did].append(self._free.pop())

    def _table(self, dids: List[str]) -> torch.Tensor:
        rows = [self.tables[d] + [0] * (self.max_pages - len(self.tables[d])) for d in dids]
        return torch.tensor(rows, dtype=torch.int32, device=self.engine.device)

    def _lengths(self, dids: List[str]) -> torch.Tensor:
        return torch.tensor([self.lengths[d] for d in dids], dtype=torch.int32,
                            device=self.engine.device)

    # -- turn programs -------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, table, length, plans: List[SplicePlan], memory) -> torch.Tensor:
        """Bucketed prefill of K spliced suffixes into the pool; returns the
        (K, V) logits at each row's last real position.  A hybrid's rows
        continue, and leave at their real lengths, ``self._turn_state``."""
        eng, dev = self.engine, self.engine.device

        def t(key):
            return torch.as_tensor(np.stack([getattr(p, key) for p in plans]), device=dev)

        embeds = splice_embeds(eng.params["text"], t("token_ids"), t("mem_index"),
                               t("use_mem"), memory)
        real = (torch.tensor([p.length for p in plans], dtype=torch.int32, device=dev)
                if self.states is not None else None)
        logits, _ = paged_text_forward(eng.params["text"], eng.cfg.text, self.pool, table,
                                       length, inputs_embeds=embeds, state=self._turn_state,
                                       real_len=real)
        last = torch.tensor([max(p.length - 1, 0) for p in plans], device=dev)
        return logits[torch.arange(len(plans), device=dev), last]

    def _forward(self, table, length, ids, slots=None) -> torch.Tensor:
        """The decode forward of K tokens (K, 1) at ``length`` → (K, V) logits.
        A hybrid's rows step the states of their slots (``slots``, else
        ``self._step_slots``), read from the state pool and written back."""
        state = None
        if self.states is not None:
            slots = self._step_slots if slots is None else slots
            state = self.states.gather(slots)
        logits, _ = paged_text_forward(self.engine.params["text"], self.engine.cfg.text,
                                       self.pool, table, length, input_ids=ids, state=state)
        if state is not None:
            self.states.scatter(slots, state)
        return logits[:, -1]

    @torch.no_grad()
    def _decode_step(self, table, length, toks: list) -> torch.Tensor:
        """One lockstep step: feed K tokens at ``length`` → (K, V) logits.
        Where ``decode_graphed``, the first step of each K runs eagerly and
        is then captured (its logits, and its routing, are the eager
        step's); every later step of that K replays the capture."""
        ids = torch.tensor(toks, dtype=torch.long, device=self.engine.device)[:, None]
        if not decode_graphed(ids.device, self.engine.params["text"], self.engine.cfg.text):
            tracer.count("paged.graph_replays", 0)
            return self._forward(table, length, ids)
        step = self._graphs.get(len(toks))
        if step is None:
            logits = self._forward(table, length, ids)
            if self._side is None:
                self._side = torch.cuda.Stream(ids.device)
                self._graph_pool = torch.cuda.graph_pool_handle()
            step = _StepGraph(self, len(toks))
            step.capture(self._side, self._graph_pool)
            self._graphs[len(toks)] = step
            tracer.count("paged.graph_captures")
            tracer.count("paged.graph_replays", 0)
            return logits
        step.load(table, length, ids)
        tracer.count("paged.graph_replays")
        return step.replay()

    def _decode(self, table, length: list, first: list, limits: list, knobs, generator,
                stop_ids):
        """The lockstep decode with per-row limits: rows that finish stop
        advancing their length (their writes at the frozen length land in
        their own slack or the sink) and, under a hybrid, step the sink
        slot's state, not their own.  Returns (buf (K, max_new), lengths)."""
        from .engine import lockstep_decode

        length = list(length)
        dev = self.engine.device

        def step(toks, advance):
            with tracer.span("paged.decode_step"):
                lens = torch.tensor(length, dtype=torch.int32, device=dev)
                if self.states is not None:
                    self._step_slots = torch.tensor(
                        [s if a else 0 for s, a in zip(self._turn_slots, advance)],
                        dtype=torch.long, device=dev)
                    tracer.count("paged.sink_rows", advance.count(0))
                logits = self._decode_step(table, lens, toks)
            for r, a in enumerate(advance):
                length[r] += a
            return logits

        with tracer.span("paged.decode", K=len(first)) as span:
            buf, steps = lockstep_decode(step, first, limits, self.engine.eos_token_id, knobs,
                                         generator, stop_ids)
            span.set(steps=steps)
        return buf, length

    def run_turns(self, dids: List[str], plans: List[SplicePlan], memories,
                  max_new_tokens=128, temperature=0.0, top_k=0, top_p=0.0,
                  generator: Optional[torch.Generator] = None, stop_ids=None) -> List[List[int]]:
        """One cognition turn for EACH dialogue, batched: one prefill and one
        lockstep decode over the shared pool.  All plans share one bucket;
        memories: K rows of (1, M, D); max_new_tokens: an int or K ints;
        stop_ids: (S, L) shared or (K, S, L) per row.  Returns K token lists."""
        from .engine import _knob_rows, tokens_until_eos
        from .logit_filters import sample_first_token_rows

        memories = list(memories)
        if not (len(dids) == len(plans) == len(memories)):
            raise ValueError(f"run_turns needs matching lists: {len(dids)} dialogues, "
                             f"{len(plans)} plans, {len(memories)} memories")
        K = len(dids)
        limits = [max_new_tokens] * K if isinstance(max_new_tokens, int) else list(max_new_tokens)
        if len(limits) != K:
            raise ValueError(f"{len(limits)} limits for {K} dialogues")
        buckets = {len(p.token_ids) for p in plans}
        if len(buckets) != 1:
            raise ValueError(f"plans must share one bucket, got {sorted(buckets)}")
        bucket = buckets.pop()
        for did, lim in zip(dids, limits):
            self.ensure_capacity(did, bucket + lim)
        table = self._table(dids)
        if self.states is not None:
            self._turn_slots = [self.slots[d] for d in dids]
            slots = torch.tensor(self._turn_slots, dtype=torch.long, device=self.engine.device)
            rows = K * self.states.ssm.shape[0]
            with tracer.span("paged.state", K=K, rows=rows):
                self._turn_state = self.states.gather(slots)
        with tracer.span("paged.prefill", K=K, bucket=bucket):
            last = self._prefill(table, self._lengths(dids), plans, torch.cat(memories, dim=0))
        if self.states is not None:
            with tracer.span("paged.state", K=K, rows=rows):
                self.states.scatter(slots, self._turn_state)
            self._turn_state = None
        for d, p in zip(dids, plans):
            self.lengths[d] += p.length
        knobs = (_knob_rows(temperature, K), _knob_rows(top_k, K), _knob_rows(top_p, K))
        first = sample_first_token_rows(generator, last, *knobs)
        buf, new_len = self._decode(table, [self.lengths[d] for d in dids], first, limits,
                                    knobs, generator, stop_ids)
        for d, n in zip(dids, new_len):
            self.lengths[d] = n
        eos = self.engine.eos_token_id
        return [tokens_until_eos(row, eos) for row in buf]

    def run_turn(self, did: str, plan: SplicePlan, memory, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 generator: Optional[torch.Generator] = None, stop_ids=None) -> List[int]:
        """One cognition turn for dialogue ``did``: run_turns with K = 1."""
        return self.run_turns([did], [plan], [memory], max_new_tokens=max_new_tokens,
                              temperature=temperature, top_k=top_k, top_p=top_p,
                              generator=generator, stop_ids=stop_ids)[0]
