"""The arithmetic of the split paged decode attention and of the tensor-core
int8 matvec, on the CPU.

``csrc/paged_attention.cu`` splits each row's keys into spans of 256 or
512 positions (``paged_attention._span``), takes an exact softmax inside each
split and merges the splits' (m, l, acc) in split order, and given a decode
step's new token writes it into the pool and reads it from the token;
``csrc/int8_matvec.cu`` sums bf16 x against int8 rows through m16n8k16
tensor-core products whose k index is permuted within each 64-column step,
with the input columns split over the warps of a block.  The CUDA kernels
cannot run here, so this file holds a test-local emulation of each
kernel's order of work against the port's plain versions
(``paged_decode_attention_ref``, ``int8_matvec_ref``) and the JAX package
(``streaming.paged._paged_decode_attention``, its CPU branch;
``ops.int8_matvec.int8_matvec``, its Pallas kernel interpreted), on inputs
made by numpy from a seed.  The card holds the kernels against the plain
versions (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerances:
  * paged attention, fp32: |err| <= 2e-6 + 1e-5 |ref|.  The emulation
    changes only the order of the sums (each split's exact max, then the
    merge's rescale by exp(m_s - M)), a few fp32 ulps of the outputs
    (|ref| <= ~3 here);
  * int8, bf16 x: every product is exact in fp32 (asserted), so the
    emulation, the plain version and the JAX kernel differ only in the
    order of fp32 sums and so in the one final bf16 rounding: one bf16
    step, 2**-8 |ref|, beside 1e-6.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_torch.ops import paged_attention as PA
from streammind_torch.ops.int8_matvec import int8_matvec, int8_matvec_ref
from streammind_torch.utils import quantize as tquant

jpaged = importlib.import_module("streammind_tpu.streaming.paged")
jint8 = importlib.import_module("streammind_tpu.ops.int8_matvec")
jquant = importlib.import_module("streammind_tpu.utils.quantize")

PAGED_TOL = (2e-6, 1e-5)
TILE = 64            # positions a tile of the paged kernel
TC_CHUNK = 32768     # bytes of x a staged chunk of the int8 kernel holds (bf16)


def _excess(out, ref, tol):
    out = torch.from_numpy(np.array(out, np.float32))
    ref = torch.from_numpy(np.array(ref, np.float32))
    return float(((out - ref).abs() - (tol[0] + tol[1] * ref.abs())).max())


# ---------------------------------------------------------------------------
# paged decode attention, split over the keys
# ---------------------------------------------------------------------------
def paged_split_emulation(q, pool_k, pool_v, table, length, span, k_new=None, v_new=None):
    """The kernel's order of work in fp32: for each (row, kv head) the
    splits of ``span`` positions that start before the row's clamped
    length; in each, scores q.k times the scale (fp32 dot), masked at
    -1e30 past the length within the split's last 64-position tile, the
    split's exact max m and sum l and acc = p V; a row in one split is
    acc / max(l, 1e-30), otherwise the splits merge in split order; a row
    of length 0 gives 0.  With k_new/v_new (K, Hkv, D), length is the count
    before the new token: split 0 writes it into the pools at the row's
    slot (sink page 0 past the table), the row attends over length + 1
    positions, and the split whose span holds position length takes that
    position's K and V from k_new/v_new, not from the pools."""
    kk, _, h, d = q.shape
    hkv, _, page, _ = pool_k.shape
    g = h // hkv
    maxp = table.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(kk, 1, h, d)
    for b in range(kk):
        new_pos = int(length[b]) if k_new is not None else -1
        L = max(0, min(new_pos + 1 if k_new is not None else int(length[b]), maxp * page))
        pos = torch.arange(L)
        pages = table[b, pos // page].long()
        for hk in range(hkv):
            k_row = pool_k[hk, pages, pos % page].float()      # (L, D), read before the write
            v_row = pool_v[hk, pages, pos % page].float()
            if k_new is not None:
                pg = int(table[b, new_pos // page]) if new_pos // page < maxp else 0
                pool_k[hk, pg, new_pos % page] = k_new[b, hk].to(pool_k.dtype)  # split 0's write
                pool_v[hk, pg, new_pos % page] = v_new[b, hk].to(pool_v.dtype)
                if new_pos < L:  # the span holding new_pos reads the token, not the pool
                    k_row[new_pos] = k_new[b, hk].to(pool_k.dtype).float()
                    v_row[new_pos] = v_new[b, hk].to(pool_v.dtype).float()
            qh = q[b, 0, hk * g:(hk + 1) * g].float()         # (G, D)
            parts = []
            for s0 in range(0, L, span):
                n = min(span, L - s0)
                tiles = -(-n // TILE) * TILE
                s = torch.full((g, tiles), -1e30)
                s[:, :n] = (qh @ k_row[s0:s0 + n].T) * scale
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                l = p.sum(dim=1)
                acc = p[:, :n] @ v_row[s0:s0 + n]
                parts.append((m, l, acc))
            if len(parts) == 1:
                m, l, acc = parts[0]
                out[b, 0, hk * g:(hk + 1) * g] = acc / torch.clamp(l, min=1e-30)[:, None]
            elif parts:
                big = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                l_sum, a_sum = torch.zeros(g), torch.zeros(g, d)
                for m, l, acc in parts:  # split order
                    w = torch.exp(m - big)
                    l_sum = l_sum + w * l
                    a_sum = a_sum + w[:, None] * acc
                out[b, 0, hk * g:(hk + 1) * g] = a_sum / torch.clamp(l_sum, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("span", [128, 256, 512])  # the kernel's spans and a shorter one
@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
def test_paged_split_merge_matches_plain_and_jax(rng, span, page, group):
    """Rows of length 1, span - 1, span, span + 1, the full table and one
    past the table (a finished row of the lockstep loop) in one call."""
    hkv, d = 2, 64
    maxp = (2 * span) // page + 1
    full = maxp * page
    lengths = [1, span - 1, span, span + 1, full, full + 1]
    kk, h = len(lengths), hkv * group
    n_pages = kk * maxp + 1
    q = torch.from_numpy(rng.standard_normal((kk, 1, h, d)).astype(np.float32))
    pool_k, pool_v = (torch.from_numpy(rng.standard_normal((hkv, n_pages, page, d))
                                       .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(kk, maxp)
                             .astype(np.int32))
    length = torch.tensor(lengths, dtype=torch.int32)
    out = paged_split_emulation(q, pool_k, pool_v, table, length, span)
    ref = PA.paged_decode_attention_ref(q, pool_k, pool_v, table, length)
    assert torch.equal(PA.paged_decode_attention(q, pool_k, pool_v, table, length), ref)
    jref = jpaged._paged_decode_attention(*(jnp.asarray(t.numpy()) for t in
                                            (q, pool_k, pool_v, table, length)))
    assert _excess(out, ref, PAGED_TOL) <= 0, _excess(out, ref, PAGED_TOL)
    assert _excess(out, jref, PAGED_TOL) <= 0, _excess(out, jref, PAGED_TOL)
    assert _excess(ref, jref, PAGED_TOL) <= 0, _excess(ref, jref, PAGED_TOL)


@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("page", [8, 64])
def test_paged_split_with_the_write_is_write_then_attend(rng, span, page):
    """The new token at position 0, at the last position of split 0, at the
    first of split 1, at the table's last position and one past it (routed
    to the sink): pools and outputs bitwise what ``write_tokens_ref`` then
    the write-free emulation at length + 1 give, and within PAGED_TOL of the
    plain version."""
    hkv, d, group = 2, 64, 4
    maxp = (2 * span) // page + 1
    full = maxp * page
    lengths = [0, span - 1, span, full - 1, full]
    kk, h = len(lengths), hkv * group
    n_pages = kk * maxp + 1
    q = torch.from_numpy(rng.standard_normal((kk, 1, h, d)).astype(np.float32))
    pool_k, pool_v = (torch.from_numpy(rng.standard_normal((hkv, n_pages, page, d))
                                       .astype(np.float32)) for _ in range(2))
    k_new, v_new = (torch.from_numpy(rng.standard_normal((kk, hkv, d)).astype(np.float32))
                    for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(kk, maxp)
                             .astype(np.int32))
    length = torch.tensor(lengths, dtype=torch.int32)
    fk, fv = pool_k.clone(), pool_v.clone()
    out = paged_split_emulation(q, fk, fv, table, length, span, k_new, v_new)
    wk, wv = pool_k.clone(), pool_v.clone()
    PA.write_tokens_ref(wk, wv, k_new, v_new, *PA.token_slots(table, length, page))
    assert torch.equal(fk, wk) and torch.equal(fv, wv)
    assert not torch.equal(fk[:, 0], pool_k[:, 0])   # the edge row wrote the sink
    assert torch.equal(out, paged_split_emulation(q, wk, wv, table, length + 1, span))
    pk, pv = pool_k.clone(), pool_v.clone()
    ref = PA.paged_decode_attention(q, pk, pv, table, length, k_new=k_new, v_new=v_new)
    assert torch.equal(pk, wk) and torch.equal(pv, wv)
    assert _excess(out, ref, PAGED_TOL) <= 0, _excess(out, ref, PAGED_TOL)


def test_paged_split_of_an_empty_row_is_zero(rng):
    """A row of length 0 gives 0 in the emulation, as in the kernel; the
    plain version gives the mean of the table's values there (every logit
    masked alike), which no caller reads."""
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((1, 5, 16, 64)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    out = paged_split_emulation(q, pool, pool, table, torch.tensor([0, 20]), 256)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = PA.paged_decode_attention_ref(q, pool, pool, table, torch.tensor([0, 20]))
    assert _excess(out[1], ref[1], PAGED_TOL) <= 0


# ---------------------------------------------------------------------------
# the int8 matvec on the tensor cores
# ---------------------------------------------------------------------------
def int8_tc_emulation(x, w_int8, scale, wk):
    """The bf16 kernel's order of work: for each row, the warp slices
    kk = 0..wk-1 of the input columns (64-column steps kk, kk + wk, ... of
    each staged chunk of 16384 / B columns, B rounded up to 1, 2, 4 or 8),
    in each step four k16 products
    whose 16 columns are 16t + 4s + {0, 1, 2, 3} for t = 0..3 (product s),
    each added to the warp's fp32 sum; the slices summed in order, times
    the scale, rounded once to bf16.  Returns the result and the fp32
    products, for the exactness check."""
    xf = x.float().numpy()
    wf = w_int8.numpy().astype(np.float32)
    prods = xf[:, None, :] * wf[None, :, :]                  # (B, out, in), fp32
    b, dout, din = prods.shape
    nb = 1 << (b - 1).bit_length()         # B as the kernel instantiates it: 1, 2, 4 or 8
    cols = TC_CHUNK // (2 * nb)            # columns a staged chunk
    total = np.zeros((b, dout), np.float32)
    seen = np.zeros(din, np.int64)
    for kk in range(wk):
        acc = np.zeros((b, dout), np.float32)
        for c0 in range(0, din, cols):
            cw = min(cols, din - c0)
            for st in range(kk, -(-cw // 64), wk):
                for s in range(4):
                    ks = [c0 + st * 64 + 16 * t + 4 * s + e for t in range(4) for e in range(4)]
                    ks = [k for k in ks if k < c0 + cw]
                    if ks:
                        seen[ks] += 1
                        acc = acc + prods[:, :, ks].sum(axis=2, dtype=np.float32)
        total = total + acc
    assert (seen == 1).all()  # the permutation takes every column once
    y = torch.from_numpy(total * scale.numpy()[None, :]).bfloat16()
    return y, prods


@pytest.mark.parametrize("wk", [1, 8])
@pytest.mark.parametrize("b,din,dout", [(1, 256, 64), (3, 4160, 40), (8, 4096, 24),
                                        (5, 2064, 17), (8, 14336, 16)])
def test_int8_tc_permuted_sum_matches_plain_and_jax(rng, wk, b, din, dout):
    w = (rng.standard_normal((dout, din)) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((b, din)).astype(np.float32)).bfloat16()
    tq = tquant.quantize_linear_weight(torch.from_numpy(w))
    out, prods = int8_tc_emulation(x, tq["w_int8"], tq["scale"], wk)
    # every product of a bf16 x and an int8 weight is exact in fp32
    exact = x.double().numpy()[:, None, :] * tq["w_int8"].numpy().astype(np.float64)[None]
    assert np.array_equal(prods.astype(np.float64), exact)
    ref = int8_matvec_ref(x, tq["w_int8"], tq["scale"])
    assert torch.equal(int8_matvec(x, tq["w_int8"], tq["scale"]), ref)
    tol = (1e-6, 2 ** -8)
    assert _excess(out.float(), ref.float(), tol) <= 0
    if din <= 4160:  # the interpreted Pallas kernel is slow at 14336 columns
        jq = jquant.quantize_linear_weight(jnp.asarray(w))
        jref = jint8.int8_matvec(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                 jq["w_int8"], jq["scale"])
        assert _excess(out.float(), np.asarray(jref, np.float32), tol) <= 0
