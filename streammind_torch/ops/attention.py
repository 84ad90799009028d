"""Attention ops: the plain softmax attention, and hand-written CUDA kernels.

  * ``mha_reference``    — fp32 logits, the scale applied after the dot,
                           probs cast to v's dtype (GQA-aware).
  * ``flash_attention``  — blockwise online-softmax forward with per-row
                           ``kv_len``/``q_offset`` (cached prefill); kernel
                           ``csrc/flash_attention.cu``, plain version
                           ``flash_attention_ref``.  With ``return_lse`` it
                           goes through ``flash_attention_lse``, the same
                           kernel writing each row's log-sum-exp too.
  * ``flash_mha``        — differentiable flash attention (training): the
                           lse forward, then the FlashAttention-2 backward as
                           two kernels, ``flash_bwd_dq`` (``csrc/
                           flash_bwd_dq.cu``) and ``flash_bwd_dkv``
                           (``csrc/flash_bwd_dkv.cu``, GQA group sum inside),
                           plain versions ``flash_bwd_dq_ref`` and
                           ``flash_bwd_dkv_ref``.
  * ``exact_attention``  — non-causal whole-row fp32-softmax attention (the
                           ViT under ``attn_impl="exact"``); kernel
                           ``csrc/exact_attention.cu``, plain version
                           ``exact_attention_ref``.
  * ``decode_attention`` — one query token against a fixed-capacity cache,
                           a plain torch op (left to XLA in JAX too).
  * ``flash_mha_sharded``— ``flash_mha`` on a rank's rows and heads under a
                           mesh (the dispatcher's mesh policy).

Each kernel wrapper takes its plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  ``<wrapper>.launches``
counts the kernel's launches.  The flash forward, its backward (dQ and
dK/dV) and exact attention have two instantiations, chosen by dtype: bf16
runs the tensor-core (wgmma) kernel, counted again in
``<wrapper>.tc_launches``; fp32 (the CPU-vs-card parity runs) the
CUDA-core one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
_EXACT_MAX_KEYS = 4096     # the fp32 kernel keeps a query tile's logits rows in shared memory
_EXACT_MAX_QUERIES = 4096  # as the TPU kernel, which holds all query rows resident
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_TC_ROWS = 128  # (query, head) rows of a bf16 flash or dQ block: a GQA group must fit


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) by head repetition."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def mha_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk) bool, True == valid
    q_offset=0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with fp32 logits and softmax.  GQA groups the query
    heads of each kv head (head h reads kv head h // (H / Hkv), as
    ``_repeat_kv`` maps them), so k and v are never repeated across heads:
    decode reads the whole cache through here every step."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, C, Hkv, D)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) valid entries
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode against a fixed-capacity KV cache."""
    cap = k_cache.shape[1]
    kv_mask = torch.arange(cap, device=q.device)[None, :] < cache_len[:, None]
    return mha_reference(q, k_cache, v_cache, kv_mask=kv_mask, softmax_scale=softmax_scale)


def _rows(val, b: int, default: int, device) -> torch.Tensor:
    """Scalar-or-(B,) length/offset → (B,) int32 tensor on ``device``."""
    if val is None:
        val = default
    if isinstance(val, torch.Tensor):
        return val.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(val), dtype=torch.int32, device=device)


def _check_cuda_qkv(name: str, q, k, v, max_keys: Optional[int] = None):
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {n} must lie on q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v must share one dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} must be 4-D with a contiguous head dim")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (fp32, bf16)")
    b, sq, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported {_KERNEL_HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} heads are not a multiple of {hkv} kv heads")
    if b * h > 65535 or sq < 1 or sk < 1:
        raise ValueError(f"{name}: B*H={b * h}, Sq={sq}, Sk={sk} out of range")


def _strides(t: torch.Tensor):
    """Element strides of the (batch, seq, head) dims; 0 for a dim of size 1,
    which is only ever read at index 0."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def _check_tc(name: str, q, k, v, group: int = 1, do=None):
    """What the bf16 tensor-core kernels take beyond ``_check_cuda_qkv``:
    they load rows 16 bytes at a time, so q, k, v (and the backward's dO)
    must be 16-byte aligned with (batch, seq, head) strides that are
    multiples of 8 elements (the ViT's slices of its fused qkv are); the
    flash and dQ kernels pack the ``group`` query heads of a kv head into
    their 128-row block, floor(128 / group) whole groups of them."""
    named = ((q, "q"), (k, "k"), (v, "v")) + (() if do is None else ((do, "dO"),))
    for t, n in named:
        if t.data_ptr() % 16 or any(st % 8 for st in _strides(t)):
            raise ValueError(f"{name}: bf16 {n} must be 16-byte aligned with strides that "
                             f"are multiples of 8 elements, got strides {tuple(t.stride())}; "
                             f"pass a contiguous copy")
    if group > _TC_ROWS:
        raise ValueError(f"{name}: {group} query heads a kv head do not fit the bf16 "
                         f"kernel's {_TC_ROWS} rows")


# ---------------------------------------------------------------------------
# flash attention (cached prefill)
# ---------------------------------------------------------------------------
def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = False, kv_len=None, q_offset=0,
    softmax_scale: Optional[float] = None,
    block_q: int = 256, block_k: int = 256, return_lse: bool = False,
):
    """Plain version of ``flash_attention``, in the TPU kernel's arithmetic
    and block order: q pre-scaled in fp32, online (m, l, acc) over key
    blocks, masked logits -1e30, denominator clamped at 1e-30.  With
    ``return_lse`` also the (B, Sq, H) fp32 lse = max(m, -1e30) +
    log(max(l, 1e-30)), finite for a row with no visible key."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    n_kb = -(-sk // block_k)
    lens = _rows(kv_len, b, sk, "cpu").clamp(max=sk).tolist()
    offs = _rows(q_offset, b, 0, "cpu").tolist()
    qf = (q.float() * scale).transpose(1, 2)               # (B, H, Sq, D)
    kf = _repeat_kv(k, h // hkv).float().transpose(1, 2)   # (B, H, Sk, D)
    vf = _repeat_kv(v, h // hkv).float().transpose(1, 2)
    out = torch.zeros(b, h, sq, d, device=q.device)
    lse = torch.zeros(b, h, sq, device=q.device)
    for bi in range(b):
        L, off = lens[bi], offs[bi]
        for q0 in range(0, sq, block_q):
            qb = qf[bi, :, q0:q0 + block_q]                       # (H, nq, D)
            nq = qb.shape[1]
            qpos = torch.arange(q0, q0 + nq, device=q.device)[:, None] + off
            lim = min(q0 + block_q + off, L) if causal else L
            max_kb = min(n_kb, -(-lim // block_k)) if lim > 0 else 0
            m = torch.full((h, nq, 1), NEG_INF, device=q.device)
            l = torch.zeros(h, nq, 1, device=q.device)
            acc = torch.zeros(h, nq, d, device=q.device)
            for kb in range(max_kb):
                k0 = kb * block_k
                s = qb @ kf[bi, :, k0:k0 + block_k].transpose(1, 2)  # (H, nq, nk)
                kpos = torch.arange(k0, k0 + s.shape[-1], device=q.device)[None, :]
                mask = kpos < L
                if causal:
                    mask = mask & (kpos <= qpos)
                s = torch.where(mask, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p @ vf[bi, :, k0:k0 + block_k]
                m = m_new
            denom = torch.clamp(l, min=1e-30)
            out[bi, :, q0:q0 + nq] = acc / denom
            lse[bi, :, q0:q0 + nq] = (torch.clamp(m, min=NEG_INF) + torch.log(denom))[..., 0]
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse.transpose(1, 2).contiguous()) if return_lse else out


def _flash_forward(name, q, k, v, causal, kv_len, q_offset, softmax_scale, with_lse):
    """Launch ``csrc/flash_attention.cu``, its tensor-core instantiation for
    bf16 and its CUDA-core one for fp32: (out, lse or None)."""
    _check_cuda_qkv(name, q, k, v)
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        _check_tc(name, q, k, v, group=h // hkv)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    lens = _rows(kv_len, b, sk, q.device)
    offs = _rows(q_offset, b, 0, q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device) if with_lse else None
    err = _build.kernel("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        lens.data_ptr(), offs.data_ptr(), b, sq, sk, h, hkv, d, int(causal),
        int(is_bf16), *_strides(q), *_strides(k), *_strides(v),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, name)
    return out, lse


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    causal: bool = False,
    kv_len=None,      # None, int or (B,) int tensor — valid keys per row
    q_offset=0,       # int or (B,) int tensor — position of query row 0
    softmax_scale: Optional[float] = None,
    block_q: int = 256,
    block_k: int = 256,
    return_lse: bool = False,
):
    """Flash attention forward with per-row ``kv_len`` and ``q_offset``
    (clamped: ``kv_len`` past Sk counts as Sk).  k/v may be strided views
    of a KV cache; nothing is copied.  ``block_q``/``block_k`` are the plain
    version's blocks (the kernel tiles its own way; the result is the same
    function).  ``return_lse``: (out, lse (B, Sq, H) fp32), the residual of
    the backward, through ``flash_attention_lse``."""
    if return_lse:
        return flash_attention_lse(q, k, v, causal, kv_len, q_offset, softmax_scale,
                                   block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, kv_len, q_offset, softmax_scale,
                                   block_q, block_k)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out, _ = _flash_forward("flash_attention", q, k, v, causal, kv_len, q_offset,
                            softmax_scale, with_lse=False)
    flash_attention.launches += 1
    flash_attention.tc_launches += q.dtype == torch.bfloat16
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0


def flash_attention_lse(q, k, v, causal: bool = False, kv_len=None, q_offset=0,
                        softmax_scale: Optional[float] = None,
                        block_q: int = 256, block_k: int = 256):
    """The training forward: ``flash_attention`` that also returns each row's
    fp32 log-sum-exp (B, Sq, H) — the same kernel with its lse output."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, kv_len, q_offset, softmax_scale,
                                   block_q, block_k, return_lse=True)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_lse: no kernel for device {q.device}")
    out_lse = _flash_forward("flash_attention_lse", q, k, v, causal, kv_len, q_offset,
                             softmax_scale, with_lse=True)
    flash_attention_lse.launches += 1
    flash_attention_lse.tc_launches += q.dtype == torch.bfloat16
    return out_lse


flash_attention_lse.launches = 0
flash_attention_lse.tc_launches = 0


# ---------------------------------------------------------------------------
# flash attention backward (training)
# ---------------------------------------------------------------------------
def _bwd_inputs_f32(q, k, v, do, lse, delta, scale):
    """(B, H, S, D) fp32 views with k/v repeated over each GQA group, q
    pre-scaled; lse and delta (B, H, Sq)."""
    h, hkv = q.shape[2], k.shape[2]
    return ((q.float() * scale).transpose(1, 2), do.float().transpose(1, 2),
            _repeat_kv(k, h // hkv).float().transpose(1, 2),
            _repeat_kv(v, h // hkv).float().transpose(1, 2),
            lse.float().transpose(1, 2), delta.float().transpose(1, 2))


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = True, kv_len=None,
                     block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq`` in the TPU kernel's arithmetic and
    block order: per query block, over the key blocks it can see,
    p = exp(s - lse) where visible else 0, ds = p (dO Vᵀ - delta),
    acc += ds K; dQ = acc · scale in q's dtype."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    bq, bk = min(block_q, sq), min(block_k, sk)
    n_kb = -(-sk // bk)
    lens = _rows(kv_len, b, sk, "cpu").clamp(max=sk).tolist()
    qf, dof, kf, vf, lsef, dltf = _bwd_inputs_f32(q, k, v, do, lse, delta, scale)
    dq = torch.zeros(b, h, sq, d, device=q.device)
    for bi in range(b):
        L = lens[bi]
        for q0 in range(0, sq, bq):
            qb, dob = qf[bi, :, q0:q0 + bq], dof[bi, :, q0:q0 + bq]
            nq = qb.shape[1]
            lse_b = lsef[bi, :, q0:q0 + nq, None]
            dlt_b = dltf[bi, :, q0:q0 + nq, None]
            qpos = torch.arange(q0, q0 + nq, device=q.device)[:, None]
            lim = min(q0 + bq, L) if causal else L
            max_kb = min(n_kb, -(-lim // bk)) if lim > 0 else 0
            acc = torch.zeros(h, nq, d, device=q.device)
            for kb in range(max_kb):
                k0 = kb * bk
                kt, vt = kf[bi, :, k0:k0 + bk], vf[bi, :, k0:k0 + bk]
                s = qb @ kt.transpose(1, 2)
                kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
                mask = kpos < L
                if causal:
                    mask = mask & (kpos <= qpos)
                p = torch.where(mask, torch.exp(s - lse_b), 0.0)
                ds = p * (dob @ vt.transpose(1, 2) - dlt_b)
                acc = acc + ds @ kt
            dq[bi, :, q0:q0 + nq] = acc * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = True, kv_len=None,
                      block_q: int = 256, block_k: int = 256):
    """Plain version of ``flash_bwd_dkv`` in the TPU kernel's arithmetic:
    per key block and query head, over the query rows from the causal start
    block on, dV = Σ pᵀ dO and dK = Σ dsᵀ (scale·q) in fp32; then the GQA
    group sum and one cast to k's dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    bq, bk = min(block_q, sq), min(block_k, sk)
    lens = _rows(kv_len, b, sk, "cpu").clamp(max=sk).tolist()
    qf, dof, kf, vf, lsef, dltf = _bwd_inputs_f32(q, k, v, do, lse, delta, scale)
    dk = torch.zeros(b, hkv, sk, d, device=q.device)
    dv = torch.zeros(b, hkv, sk, d, device=q.device)
    for bi in range(b):
        L = lens[bi]
        for k0 in range(0, sk, bk):
            kt, vt = kf[bi, :, k0:k0 + bk], vf[bi, :, k0:k0 + bk]
            nk = kt.shape[1]
            start = (k0 // bq) * bq if causal else 0
            qb, dob = qf[bi, :, start:], dof[bi, :, start:]
            s = qb @ kt.transpose(1, 2)                              # (H, nq, nk)
            qpos = torch.arange(start, sq, device=q.device)[:, None]
            kpos = torch.arange(k0, k0 + nk, device=q.device)[None, :]
            mask = kpos < L
            if causal:
                mask = mask & (kpos <= qpos)
            p = torch.where(mask, torch.exp(s - lsef[bi, :, start:, None]), 0.0)
            ds = p * (dob @ vt.transpose(1, 2) - dltf[bi, :, start:, None])
            dv_h = p.transpose(1, 2) @ dob                           # (H, nk, D)
            dk_h = ds.transpose(1, 2) @ qb
            dk[bi, :, k0:k0 + nk] = dk_h.reshape(hkv, h // hkv, nk, d).sum(1)
            dv[bi, :, k0:k0 + nk] = dv_h.reshape(hkv, h // hkv, nk, d).sum(1)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _check_cuda_bwd(name, q, k, v, do, lse, delta):
    _check_cuda_qkv(name, q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"{name}: dO must match q (shape, dtype, device, contiguous head dim)")
    for t, n in ((lse, "lse"), (delta, "delta")):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {n} must be (B, Sq, H) contiguous fp32 on q's device")


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True, kv_len=None,
                 block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """dQ of flash attention (queries at positions 0..Sq-1, scale 1/sqrt(D))
    from the forward's lse and delta = rowsum(dO·O); (B, Sq, H, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, kv_len, block_q, block_k)
    if not q.is_cuda:
        raise ValueError(f"flash_bwd_dq: no kernel for device {q.device}")
    _check_cuda_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        _check_tc("flash_bwd_dq", q, k, v, group=h // hkv, do=do)
    scale = 1.0 / math.sqrt(d)
    lens = _rows(kv_len, b, sk, q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _build.kernel("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), lens.data_ptr(), b, sq, sk, h, hkv, d, int(causal),
        int(is_bf16), *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += is_bf16
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.tc_launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True, kv_len=None,
                  block_q: int = 256, block_k: int = 256):
    """(dK, dV) of flash attention (scale 1/sqrt(D)), summed over each GQA
    group, in k's dtype (B, Sk, Hkv, D)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, kv_len, block_q, block_k)
    if not q.is_cuda:
        raise ValueError(f"flash_bwd_dkv: no kernel for device {q.device}")
    _check_cuda_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        _check_tc("flash_bwd_dkv", q, k, v, do=do)
    scale = 1.0 / math.sqrt(d)
    lens = _rows(kv_len, b, sk, q.device)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, hkv, d), dtype=v.dtype, device=q.device)
    err = _build.kernel("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), lens.data_ptr(), b, sq, sk, h, hkv, d,
        int(causal), int(is_bf16), *_strides(q), *_strides(k),
        *_strides(v), *_strides(do), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tc_launches += is_bf16
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0


class _FlashMHA(torch.autograd.Function):
    """Forward: the lse kernel; backward: delta = rowsum(dO·O) (a plain op,
    as XLA computes it in JAX), then the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal, block_q, block_k):
        out, lse = flash_attention_lse(q, k, v, causal, lens, 0, None, block_q, block_k)
        ctx.save_for_backward(q, k, v, lens, out, lse)
        ctx.causal, ctx.blocks = causal, (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lens, out, lse = ctx.saved_tensors
        g = g if g.stride(-1) == 1 else g.contiguous()
        delta = (g.float() * out.float()).sum(-1)
        args = (q, k, v, g, lse, delta, ctx.causal, lens, *ctx.blocks)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_mha(q, k, v, kv_len=None, causal: bool = True,
              block_q: int = 256, block_k: int = 256, q_offset=0):
    """Differentiable flash attention (the training kernels): q (B, Sq, H, D),
    k/v (B, Sk, Hkv, D), kv_len None or (B,) valid keys (right padding).
    When a gradient is wanted the forward saves (q, k, v, kv_len, out, lse)
    and the backward runs the FlashAttention-2 recomputation from lse; with
    no gradient wanted it is the inference kernel (no lse written), as the
    JAX primal is.  The backward takes queries at positions 0..Sq-1 only:
    any other ``q_offset`` raises."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise NotImplementedError("flash_mha: the backward takes q_offset == 0 only")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention(q, k, v, causal=causal, kv_len=kv_len, block_q=block_q,
                               block_k=block_k)
    lens = _rows(kv_len, q.shape[0], k.shape[1], q.device)
    return _FlashMHA.apply(q, k, v, lens, causal, block_q, block_k)


# ---------------------------------------------------------------------------
# exact attention (the ViT)
# ---------------------------------------------------------------------------
def exact_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``exact_attention``: dot in fp32, THEN the scale;
    whole-row max/exp/sum/div in fp32; probs cast to v's dtype; PV in fp32
    with one final rounding to q's dtype."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    kr = _repeat_kv(k, h // hkv)
    vr = _repeat_kv(v, h // hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vr.float())
    return out.to(q.dtype)


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal, unmasked attention with a whole-row fp32 softmax.  q, k
    and v may be strided views (the ViT passes slices of its fused qkv
    projection); the kernel reads them through their strides."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk > _EXACT_MAX_KEYS or sq > _EXACT_MAX_QUERIES:
        raise ValueError(
            f"exact_attention: Sq={sq}, Sk={sk} exceed the kernel's bounds "
            f"({_EXACT_MAX_QUERIES}, {_EXACT_MAX_KEYS}); use flash or mha_reference"
        )
    if q.device.type == "cpu":
        return exact_attention_ref(q, k, v, softmax_scale)
    if not q.is_cuda:
        raise ValueError(f"exact_attention: no kernel for device {q.device}")
    _check_cuda_qkv("exact_attention", q, k, v)
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        _check_tc("exact_attention", q, k, v)
    hkv = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _build.kernel("exact_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, hkv, d, int(is_bf16),
        *_strides(q), *_strides(k), *_strides(v),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "exact_attention")
    exact_attention.launches += 1
    exact_attention.tc_launches += is_bf16
    return out


exact_attention.launches = 0
exact_attention.tc_launches = 0


def flash_mha_sharded(mesh, q, k, v, kv_len=None, causal: bool = True):
    """``flash_mha`` on this rank's slice of a dp × tp mesh: q, k, v are the
    rank's batch rows (dp) and heads (tp), as the column-parallel q/k/v
    projections leave them (past the kv heads, the one kv head its q heads
    read), and attention is independent per (row, head), so the flash
    forward and its dQ and dK/dV kernels run on the local tensors with no
    collective inside (the JAX package shard_maps the same kernels over the
    global arrays).  Local heads that no GQA group pairs raise.
    ``flash_mha_sharded.calls`` counts the calls."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_mha_sharded: this rank's {q.shape[2]} q heads do not "
                         f"group over its {k.shape[2]} kv heads")
    flash_mha_sharded.calls += 1
    return flash_mha(q, k, v, kv_len, causal)


flash_mha_sharded.calls = 0


def attention(
    q, k, v,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    kv_len=None,
    q_offset=0,
    impl: str = "auto",
):
    """Dispatcher: 'auto' → mha_reference; 'bf16' → softmax in the input
    dtype; 'exact' → exact_attention where it applies (non-causal, no mask,
    within its bounds), else the 'auto' path with the same numerics;
    'flash' → flash_mha (differentiable; kv_mask becomes kv_len, padding is
    always on the right), or the flash forward under a nonzero q_offset;
    'flash!' (training's) is the same call.

    Under an ambient mesh (``parallel/mesh.py::set_mesh``) q, k and v are
    this rank's rows and heads, and 'flash' runs ``flash_mha_sharded`` on
    them: under a mesh as without one, 'flash' never gives way to the plain
    path."""
    if impl == "flash!":
        impl = "flash"
    if impl == "flash":
        if kv_len is None and kv_mask is not None:
            kv_len = kv_mask.sum(dim=-1).to(torch.int32)
        if not (isinstance(q_offset, int) and q_offset == 0):
            return flash_attention(q, k, v, causal=causal, kv_len=kv_len, q_offset=q_offset)
        from ..parallel.mesh import ambient_mesh

        mesh = ambient_mesh()
        if mesh is None:
            return flash_mha(q, k, v, kv_len, causal)
        return flash_mha_sharded(mesh, q, k, v, kv_len, causal)
    if impl == "exact":
        if (not causal and kv_mask is None and kv_len is None
                and isinstance(q_offset, int) and q_offset == 0
                and k.shape[1] <= _EXACT_MAX_KEYS and q.shape[1] <= _EXACT_MAX_QUERIES):
            return exact_attention(q, k, v)
        impl = "auto"
    if impl not in ("auto", "bf16"):
        raise ValueError(f"attention: impl {impl!r} is not ported (auto, bf16, exact, flash)")
    if kv_mask is None and kv_len is not None:
        sk = k.shape[1]
        kv_mask = torch.arange(sk, device=q.device)[None, :] < _rows(kv_len, k.shape[0], sk, q.device)[:, None]
    if impl == "bf16":
        h, hkv = q.shape[2], k.shape[2]
        k = _repeat_kv(k, h // hkv)
        v = _repeat_kv(v, h // hkv)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
        if causal:
            sq, sk = q.shape[1], k.shape[1]
            qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
            s = torch.where(torch.arange(sk, device=q.device)[None, :] <= qpos, s,
                            torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, :], s,
                            torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return mha_reference(q, k, v, causal=causal, kv_mask=kv_mask, q_offset=q_offset)
