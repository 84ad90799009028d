"""Paged KV cache: many dialogues share one page pool on the card.

In place of a static ring per dialogue (capacity 8192 ≈ 1.07 GB at 7B
bf16), one SHARED pool of fixed-size pages plus a page table per dialogue,
so resident memory tracks the sum of the dialogues' actual lengths.  The
decode hot path runs one hand-written kernel a layer
(``ops/paged_attention.py``): the one-token pool write and the one-token
attention over page tables, in one launch.

Layout, per layer:
  pool.k/v: tuples of (Hkv, num_pages, page_size, D)
  table:    (B, max_pages_per_seq) int32 pool page ids
  length:   (B,) int32 valid tokens
Page 0 is the write sink: never given to a dialogue, it takes zero-padded
table entries and the writes of finished rows past their table.  Pool
writes happen in place.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import TextConfig
from ..models import mistral as lm
from ..models.meta import SplicePlan, splice_embeds
from ..ops.attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import gather_seq, paged_decode_attention
from ..ops.rotary import apply_rope, rope_cos_sin
from ..utils.params import layer_slice, linear

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
    if page_size % _PAGE_MULTIPLE != 0:
        raise ValueError(f"page_size must be a multiple of {_PAGE_MULTIPLE}, got {page_size}")
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return PagedKV(
        k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
        v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)),
    )


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
    return pool_k, pool_v


def paged_text_forward(params, cfg: TextConfig, pool: PagedKV, table: torch.Tensor,
                       length: torch.Tensor, input_ids: Optional[torch.Tensor] = None,
                       inputs_embeds: Optional[torch.Tensor] = None):
    """The decoder's cached forward over the paged pool: append the block at
    ``length`` (B,), attend to the whole valid prefix, return (fp32 logits,
    pool).  The pool is written in place; lengths are tracked by the caller."""
    x = inputs_embeds if inputs_embeds is not None else lm.embed_tokens(params, input_ids)
    b, s, _ = x.shape
    page_size = pool.page_size
    positions = length[:, None] + torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        lp = layer_slice(params["layers"], i)
        y = rms_norm(x, lp["input_norm"]["weight"], cfg.rms_norm_eps)
        q, k, v = lm.qkv_proj(y, lp, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if s == 1:  # write the token and attend, in one launch
            o = paged_decode_attention(q, pool.k[i], pool.v[i], table, length, k_new=k[:, 0],
                                       v_new=v[:, 0])
        else:
            pk, pv = _write_block(pool.k[i], pool.v[i], k, v, table, length, page_size)
            k_seq = gather_seq(pk, table).to(q.dtype)
            v_seq = gather_seq(pv, table).to(q.dtype)
            o = flash_attention(q, k_seq, v_seq, causal=True, kv_len=length + s,
                                q_offset=length)
        x = x + linear(o.reshape(b, s, cfg.q_dim), lp["o"])
        y = rms_norm(x, lp["post_norm"]["weight"], cfg.rms_norm_eps)
        x = x + lm._mlp(y, lp, cfg)
    x = rms_norm(x, params["final_norm"]["weight"], cfg.rms_norm_eps)
    return lm.lm_head(params, cfg, x), pool


# ---------------------------------------------------------------------------
# host-side page allocator + per-dialogue state
# ---------------------------------------------------------------------------
class PagePoolExhausted(RuntimeError):
    pass


class PagedDialogues:
    """Host allocator and turn programs for N dialogues on one shared pool.

    Each dialogue owns a page table (host list) and a token length.  When
    the pool runs dry, ensure_capacity raises PagePoolExhausted; the serving
    layer then resets dialogues (reclaims their pages, re-carries their
    recent turns as text)."""

    def __init__(self, engine, num_pages: int, page_size: int = 64,
                 max_pages_per_seq: Optional[int] = None, dtype=None):
        from .engine import _float_dtype

        self.engine = engine
        self.page_size = page_size
        if dtype is None:
            dtype = _float_dtype(engine.params["text"])
        # num_pages allocatable pages plus the physical sink page 0
        self.pool = init_page_pool(engine.cfg.text, num_pages + 1, page_size, dtype,
                                   device=engine.device)
        self.max_pages = max_pages_per_seq or min(num_pages, -(-engine.kv_capacity // page_size))
        self._free: List[int] = list(range(1, num_pages + 1))
        self.tables: dict = {}   # dialogue id -> list of page ids
        self.lengths: dict = {}  # dialogue id -> int

    # -- allocator ---------------------------------------------------------
    def open(self, did: str) -> None:
        if did in self.tables:
            raise ValueError(f"dialogue {did!r} already open")
        self.tables[did] = []
        self.lengths[did] = 0

    def close(self, did: str) -> None:
        self._free.extend(self.tables.pop(did))
        del self.lengths[did]

    def free_pages(self) -> int:
        return len(self._free)

    @property
    def dialogue_capacity(self) -> int:
        """Most tokens one dialogue can hold (its page budget)."""
        return self.max_pages * self.page_size

    def reset(self, did: str) -> None:
        """Reclaim a dialogue's pages but keep it open (the caller re-carries
        recent turns as text)."""
        self._free.extend(self.tables[did])
        self.tables[did] = []
        self.lengths[did] = 0

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
        (K, V) logits at each row's last real position."""
        eng, dev = self.engine, self.engine.device

        def t(key):
            return torch.as_tensor(np.stack([getattr(p, key) for p in plans]), device=dev)

        embeds = splice_embeds(eng.params["text"], t("token_ids"), t("mem_index"),
                               t("use_mem"), memory)
        logits, _ = paged_text_forward(eng.params["text"], eng.cfg.text, self.pool, table,
                                       length, inputs_embeds=embeds)
        last = torch.tensor([max(p.length - 1, 0) for p in plans], device=dev)
        return logits[torch.arange(len(plans), device=dev), last]

    @torch.no_grad()
    def _decode_step(self, table, length, toks: list) -> torch.Tensor:
        """One lockstep step: feed K tokens at ``length`` → (K, V) logits."""
        ids = torch.tensor(toks, dtype=torch.long, device=self.engine.device)[:, None]
        logits, _ = paged_text_forward(self.engine.params["text"], self.engine.cfg.text,
                                       self.pool, table, length, input_ids=ids)
        return logits[:, -1]

    def _decode(self, table, length: list, first: list, limits: list, knobs, generator,
                stop_ids):
        """The lockstep decode with per-row limits: rows that finish stop
        advancing their length (their writes at the frozen length land in
        their own slack or the sink).  Returns (buf (K, max_new), lengths)."""
        from .engine import lockstep_decode

        length = list(length)

        def step(toks, advance):
            lens = torch.tensor(length, dtype=torch.int32, device=self.engine.device)
            logits = self._decode_step(table, lens, toks)
            for r, a in enumerate(advance):
                length[r] += a
            return logits

        buf, _ = lockstep_decode(step, first, limits, self.engine.eos_token_id, knobs,
                                 generator, stop_ids)
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
        last = self._prefill(table, self._lengths(dids), plans, torch.cat(memories, dim=0))
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
