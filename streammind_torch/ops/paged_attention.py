"""The paged KV pool's decode-time kernel and its plain version.

Pool layout, per layer (as the JAX package's page pool): ``(Hkv, P, page,
D)``; a row's logical position t lives at page ``table[row, t // page]``,
offset ``t % page``.  Page 0 is the write sink, never given to a dialogue.

``paged_decode_attention`` is one-token GQA attention over each row's page
table and length; kernel ``csrc/paged_attention.cu`` (split over the keys
in spans of ``_span`` positions, the splits merged in a fixed order), plain
version ``paged_decode_attention_ref`` (gather, then ``mha_reference`` with
a length mask).  Given the step's new K and V tokens it first writes them in
place at each row's ``length`` (the JAX package's token-write kernel,
folded into the same launch; plain versions ``token_slots`` and
``write_tokens_ref``) and attends over ``length + 1`` positions.

The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
``paged_decode_attention.launches`` counts the kernel's launches,
``paged_decode_attention.write_launches`` those that also wrote a token.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import _build
from .attention import mha_reference

_ATTN_HEAD_DIMS = (64, 128)
_ATTN_MAX_GROUP = 8         # query heads per kv head the kernel holds
# the spans of positions a block of the attention kernel may cover
# (multiples of 64, at most 512)
SPANS = (256, 512)
_MAX_BLOCKS = 2 ** 31 - 1
# per device: the kernel's (row, kv head) counters, zero between calls (the
# kernel's last block of each pair sets its counter back to zero), and the
# fp32 workspace of the splits' partials; kept between calls (the launches
# on a stream run in order), grown when a call needs more
_scratch = {}
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _span(rows: int, width: int, device: torch.device) -> int:
    """Positions a block covers: the shorter span where, were every split
    active, the (row x kv head, split) blocks would still be at most two an
    SM, else the longer.  From shapes alone (``rows`` = K x Hkv, ``width`` =
    the table's positions), never from the lengths on the device.  On an
    H100 at Mistral-7B's shapes: 256 at K 1 over 8192 positions, 512 from
    K 2 (PERF.md)."""
    short, long_ = SPANS
    return short if rows * -(-width // short) <= 2 * _build.sm_count(device) else long_


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_pool(name: str, pool_k: torch.Tensor, pool_v: torch.Tensor) -> None:
    if not (pool_k.is_cuda and pool_v.device == pool_k.device):
        raise ValueError(f"{name}: pool_k and pool_v must lie on one CUDA device")
    if pool_k.dim() != 4 or pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError(f"{name}: pools must be (Hkv, P, page, D) of one shape and dtype, got "
                         f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    if pool_k.dtype not in _DTYPES:
        raise ValueError(f"{name}: pool dtype {pool_k.dtype} not supported (fp32, bf16)")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError(f"{name}: pools must be contiguous")


def _rows_i32(name: str, t: torch.Tensor, device, shape) -> torch.Tensor:
    if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected int32 {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


# ---------------------------------------------------------------------------
# the one-token pool write (plain versions; the kernel folds it into the
# attention's launch)
# ---------------------------------------------------------------------------
def token_slots(table: torch.Tensor, length: torch.Tensor, page_size: int):
    """Pool slot (page, offset), int32, of each row's next token at position
    ``length``: page ``table[row, length // page]``, or sink page 0 where
    that is past the table (a finished row of the lockstep loop keeps
    writing at its frozen length, which at a page boundary points one page
    past its table)."""
    maxp = table.shape[1]
    pos_page = length.long() // page_size
    idx = torch.clamp(pos_page, max=maxp - 1)
    page_idx = torch.gather(table, 1, idx[:, None])[:, 0]
    page_idx = torch.where(pos_page < maxp, page_idx, 0).to(torch.int32)
    return page_idx, (length % page_size).to(torch.int32)


def write_tokens_ref(pool_k: torch.Tensor, pool_v: torch.Tensor, k_tok: torch.Tensor,
                     v_tok: torch.Tensor, page_idx: torch.Tensor, offset: torch.Tensor):
    """``pool[:, page_idx[i], offset[i]] = tok[i]`` for k and v, in the
    pool's dtype, in place; k_tok/v_tok (K, Hkv, D).  Where two rows share a
    slot (finished rows on the sink page) the last one wins here, and the
    kernel mixes their words: nothing reads the sink."""
    for pool, tok in ((pool_k, k_tok), (pool_v, v_tok)):
        pool[:, page_idx.long(), offset.long()] = tok.transpose(0, 1).to(pool.dtype)
    return pool_k, pool_v


# ---------------------------------------------------------------------------
# one-token attention over the page tables
# ---------------------------------------------------------------------------
def gather_seq(pool_side: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(Hkv, P, page, D) + (B, maxp) → (B, maxp*page, Hkv, D): each row's
    logical cache, contiguous (a copy; bytes ∝ the table's width)."""
    g = pool_side[:, table.long()]                  # (Hkv, B, maxp, page, D)
    hkv, b, mp, pg, d = g.shape
    return g.permute(1, 2, 3, 0, 4).reshape(b, mp * pg, hkv, d)


def paged_decode_attention_ref(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                               table: torch.Tensor, length: torch.Tensor,
                               k_new: Optional[torch.Tensor] = None,
                               v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``paged_decode_attention``: with k_new/v_new, write
    them at ``token_slots`` (``write_tokens_ref``) and count them in the
    length; then gather each row's pages and take ``mha_reference`` (fp32
    logits, the scale applied after the dot in fp32, fp32 softmax) with keys
    at positions < length.  A length past the table counts as the table's
    width."""
    if k_new is not None:
        write_tokens_ref(pool_k, pool_v, k_new, v_new,
                         *token_slots(table, length, pool_k.shape[2]))
        length = length + 1
    k_seq = gather_seq(pool_k, table).to(q.dtype)
    v_seq = gather_seq(pool_v, table).to(q.dtype)
    kv_mask = torch.arange(k_seq.shape[1], device=q.device)[None, :] < length[:, None]
    return mha_reference(q, k_seq, v_seq, kv_mask=kv_mask)


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           table: torch.Tensor, length: torch.Tensor,
                           k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (K, 1, H, D); pools (Hkv, P, page, D) in q's dtype; table (K,
    maxp) int32 page ids; length (K,) int32 valid tokens per row.  With
    k_new/v_new (K, Hkv, D), each row's new token is first written in place
    at position length (``token_slots``; cast to the pool's dtype) and the
    length counts it.  Softmax over each row's first length positions,
    clamped to maxp * page, with the scale 1/sqrt(D); a row of length 0
    gives 0 on the card.  Returns (K, 1, H, D) in q's dtype.  The kernel's
    blocks count their splits in a per-device buffer, so two calls on one
    device must not run at once on different streams."""
    if (k_new is None) != (v_new is None):
        raise ValueError("paged_decode_attention: k_new and v_new come together")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, table, length, k_new, v_new)
    if not q.is_cuda:
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    _check_pool("paged_decode_attention", pool_k, pool_v)
    hkv, n_pages, page, d = pool_k.shape
    K, sq, h, dq = q.shape
    if pool_k.device != q.device or pool_k.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and the pools must share device and dtype")
    if sq != 1 or dq != d:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} is not (K, 1, H, {d})")
    if d not in _ATTN_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {d} not supported {_ATTN_HEAD_DIMS}")
    if h % hkv or not 1 <= h // hkv <= _ATTN_MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {h} heads over {hkv} kv heads (group of at "
                         f"most {_ATTN_MAX_GROUP})")
    maxp = table.shape[1] if table.dim() == 2 else 0
    span = _span(K * hkv, maxp * page, q.device)
    n_split = -(-maxp * page // span)
    if table.dim() != 2 or table.shape[0] != K or K * hkv * n_split > _MAX_BLOCKS:
        raise ValueError(f"paged_decode_attention: table {tuple(table.shape)} for {K} rows")
    table = _rows_i32("paged_decode_attention", table, q.device, tuple(table.shape))
    length = _rows_i32("paged_decode_attention", length, q.device, (K,))
    if k_new is not None:
        if k_new.shape != (K, hkv, d) or v_new.shape != k_new.shape:
            raise ValueError(f"paged_decode_attention: new tokens {tuple(k_new.shape)}/"
                             f"{tuple(v_new.shape)} are not ({K}, {hkv}, {d})")
        if k_new.device != q.device or v_new.device != q.device:
            raise ValueError("paged_decode_attention: the new tokens must lie on q's device")
        k_new = k_new.to(pool_k.dtype).contiguous()
        v_new = v_new.to(pool_k.dtype).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    # each split's partial, for the merge: acc, then (m, l)
    n_acc = K * hkv * n_split * _ATTN_MAX_GROUP * d
    n_ws = n_acc + K * hkv * n_split * 2 * _ATTN_MAX_GROUP
    counters, ws = _scratch.get(q.device, (None, None))
    if counters is None or counters.numel() < K * hkv or ws.numel() < n_ws:
        counters, ws = _scratch[q.device] = (
            torch.zeros(max(K * hkv, 256), dtype=torch.int32, device=q.device),
            torch.empty(max(n_ws, 1 << 20), device=q.device))
    err = _build.kernel("paged_attention")(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(), length.data_ptr(),
        None if k_new is None else k_new.data_ptr(), None if v_new is None else v_new.data_ptr(),
        out.data_ptr(), ws.data_ptr(), ws.data_ptr() + ws.element_size() * n_acc,
        counters.data_ptr(), K, h, hkv, d, n_pages, page, maxp, span,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), _stream(q),
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.write_launches += k_new is not None
    return out


paged_decode_attention.launches = 0
paged_decode_attention.write_launches = 0
