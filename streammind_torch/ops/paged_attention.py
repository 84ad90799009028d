"""The paged KV pool's two decode-time kernels and their plain versions.

Pool layout, per layer (as the JAX package's page pool): ``(Hkv, P, page,
D)``; a row's logical position t lives at page ``table[row, t // page]``,
offset ``t % page``.  Page 0 is the write sink, never given to a dialogue.

  * ``write_tokens``           — one new K and V token per row written in
                                 place into its pool page and offset; kernel
                                 ``csrc/paged_write.cu``, plain version
                                 ``write_tokens_ref``.
  * ``paged_decode_attention`` — one-token GQA attention over each row's
                                 page table and length; kernel
                                 ``csrc/paged_attention.cu`` (split over the
                                 keys in spans of ``_span`` positions, the
                                 splits merged in a fixed order), plain
                                 version ``paged_decode_attention_ref``
                                 (gather, then ``mha_reference`` with a
                                 length mask).

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import functools
import math

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
# the one-token pool write
# ---------------------------------------------------------------------------
def write_tokens_ref(pool_k: torch.Tensor, pool_v: torch.Tensor, k_tok: torch.Tensor,
                     v_tok: torch.Tensor, page_idx: torch.Tensor, offset: torch.Tensor):
    """Plain version of ``write_tokens``: ``pool[:, page_idx[i], offset[i]] =
    tok[i]`` for k and v, in the pool's dtype, in place.  Where two rows
    share a slot (finished rows on the sink page) the last one wins here,
    and the kernel mixes their words: nothing reads the sink."""
    for pool, tok in ((pool_k, k_tok), (pool_v, v_tok)):
        pool[:, page_idx.long(), offset.long()] = tok.transpose(0, 1).to(pool.dtype)
    return pool_k, pool_v


def write_tokens(pool_k: torch.Tensor, pool_v: torch.Tensor, k_tok: torch.Tensor,
                 v_tok: torch.Tensor, page_idx: torch.Tensor, offset: torch.Tensor):
    """Write row i's (Hkv, D) k and v token into its pool slot, in place.
    pool_k/pool_v (Hkv, P, page, D); k_tok/v_tok (K, Hkv, D), cast to the
    pool's dtype; page_idx/offset (K,) int32, read on the device (no host
    sync).  Returns (pool_k, pool_v)."""
    if pool_k.device.type == "cpu":
        return write_tokens_ref(pool_k, pool_v, k_tok, v_tok, page_idx, offset)
    _check_pool("write_tokens", pool_k, pool_v)
    hkv, n_pages, page, d = pool_k.shape
    K = k_tok.shape[0]
    if k_tok.shape != (K, hkv, d) or v_tok.shape != k_tok.shape:
        raise ValueError(f"write_tokens: tokens {tuple(k_tok.shape)}/{tuple(v_tok.shape)} do "
                         f"not match the pool's (Hkv, D) = ({hkv}, {d})")
    if (d * pool_k.element_size()) % 16:
        raise ValueError(f"write_tokens: a head row of {d} x {pool_k.element_size()} bytes is "
                         f"not a whole number of 16-byte words")
    if K < 1:
        raise ValueError("write_tokens: no rows")
    k_tok = k_tok.to(device=pool_k.device, dtype=pool_k.dtype).contiguous()
    v_tok = v_tok.to(device=pool_k.device, dtype=pool_k.dtype).contiguous()
    page_idx = _rows_i32("write_tokens", page_idx, pool_k.device, (K,))
    offset = _rows_i32("write_tokens", offset, pool_k.device, (K,))
    err = _build.kernel("paged_write")(
        pool_k.data_ptr(), pool_v.data_ptr(), k_tok.data_ptr(), v_tok.data_ptr(),
        page_idx.data_ptr(), offset.data_ptr(), K, hkv, n_pages, page,
        d * pool_k.element_size(), _stream(pool_k),
    )
    _build.check(err, "write_tokens")
    write_tokens.launches += 1
    return pool_k, pool_v


write_tokens.launches = 0


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
                               table: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paged_decode_attention``: gather each row's
    pages, then ``mha_reference`` (fp32 logits, the scale applied after
    the dot in fp32, fp32 softmax) with keys at positions < length.  A
    length past the table counts as the table's width."""
    k_seq = gather_seq(pool_k, table).to(q.dtype)
    v_seq = gather_seq(pool_v, table).to(q.dtype)
    kv_mask = torch.arange(k_seq.shape[1], device=q.device)[None, :] < length[:, None]
    return mha_reference(q, k_seq, v_seq, kv_mask=kv_mask)


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                           table: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """q (K, 1, H, D); pools (Hkv, P, page, D) in q's dtype; table (K,
    maxp) int32 page ids; length (K,) int32 valid tokens per row, clamped
    to maxp * page.  Softmax over each row's first ``length`` positions
    with the scale 1/sqrt(D); a row of length 0 gives 0 on the card.
    Returns (K, 1, H, D) in q's dtype.  The kernel's blocks count their
    splits in a per-device buffer, so two calls on one device must not
    run at once on different streams."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, table, length)
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
        out.data_ptr(), ws.data_ptr(), ws.data_ptr() + ws.element_size() * n_acc,
        counters.data_ptr(), K, h, hkv, d, n_pages, page, maxp, span,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), _stream(q),
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
