"""The arithmetic of the tensor-core int4 matvec, on the CPU.

``csrc/int4_matvec.cu`` sums bf16 x against packed int4 rows (the low
nibble of byte c is input column c, the high nibble column in/2 + c)
through m16n8k16 tensor-core products: x is staged in chunks of 8192 / B
packed columns that hold the matching columns of both halves of x; in each
step of 64 packed columns a lane's four 32-bit words q give product 2q (the
low nibbles of packed columns 16t + 4q + {0..3}, t = 0..3) and product
2q + 1 (the high nibbles, the same columns of the upper half), both into
the warp's accumulator q, the four added in order at the end; a tile's
steps are split over 1 to 8 warps of a block (``int4_matvec._grid``),
their sums added in order; the nibbles are widened to bf16 exactly.  The CUDA kernel cannot run here,
so this file holds a test-local emulation of its order of work against the
port's plain version (``int4_matvec_ref``) and the JAX package
(``ops.int4_matvec.int4_matvec``, its Pallas kernel interpreted), on inputs
made by numpy from a seed.  The card holds the kernel against the plain
version (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerance: every product of a bf16 x and a nibble (|w| <= 8) is exact in
fp32 (asserted), so the emulation, the plain version and the JAX kernel
differ only in the order of the fp32 sums and so in the one final bf16
rounding: one bf16 step, 2**-8 |ref|, beside 1e-6.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_torch.ops.int4_matvec import _grid, int4_matvec, int4_matvec_ref
from streammind_torch.utils import quantize as tquant

jint4 = importlib.import_module("streammind_tpu.ops.int4_matvec")

TC_CHUNK = 32768     # bytes of x a staged chunk of the kernel holds (bf16, both halves)
TOL = (1e-6, 2 ** -8)


def _excess(out, ref):
    out = torch.from_numpy(np.array(out, np.float32))
    ref = torch.from_numpy(np.array(ref, np.float32))
    return float(((out - ref).abs() - (TOL[0] + TOL[1] * ref.abs())).max())


def unpack(packed: np.ndarray) -> np.ndarray:
    """(out, in/2) packed bytes → (out, in) sign-extended nibbles: the low
    nibbles are columns [0, in/2), the high ones [in/2, in)."""
    p = packed.astype(np.int8)
    lo = (p << 4).astype(np.int8) >> 4
    return np.concatenate([lo, p >> 4], axis=1).astype(np.int8)


def widen_bf16(nibbles: np.ndarray) -> np.ndarray:
    """The kernel's nibble → bf16: (n ^ 8) under 0x43 is the bf16 128 + (n ^ 8),
    less 136; returns the bf16 values as fp32."""
    raw = nibbles.astype(np.int32) & 0xF
    bits = (0x4300 | (raw ^ 8)).astype(np.uint32) << 16    # bf16 bits, in an fp32 word
    return bits.view(np.float32) - np.float32(136.0)


def int4_tc_emulation(x, packed, scale, wk):
    """The bf16 kernel's order of work: for each row, the warp slices
    kk = 0..wk-1 of its tile (steps kk, kk + wk, ... of 64 packed columns of
    each staged chunk of 8192 / B packed columns, B rounded up to 1, 2, 4 or
    8), in each step eight k16 products: product 2q over the low-half
    columns c0 + 64 step + 16t + 4q + {0..3} (t = 0..3), product 2q + 1 over
    the same columns of the upper half, both added to the warp's fp32
    accumulator q; the warp's sum ((acc0 + acc1) + acc2) + acc3; the slices
    summed in order, times the scale, rounded once to bf16.  Returns the
    result and the fp32 products, for the exactness check."""
    b, din = x.shape
    half = din // 2
    w = widen_bf16(unpack(packed.numpy()))
    assert np.array_equal(w, unpack(packed.numpy()).astype(np.float32))  # the widening is exact
    prods = x.float().numpy()[:, None, :] * w[None, :, :]      # (B, out, in), fp32
    nb = 1 << (b - 1).bit_length()        # B as the kernel instantiates it: 1, 2, 4 or 8
    cols = TC_CHUNK // (4 * nb)           # packed columns a staged chunk
    seen = np.zeros(din, np.int64)
    total = None
    for kk in range(wk):
        acc = [np.zeros(prods.shape[:2], np.float32) for _ in range(4)]
        for c0 in range(0, half, cols):
            cw = min(cols, half - c0)
            for st in range(kk, -(-cw // 64), wk):
                for q in range(4):
                    lo = [c0 + st * 64 + 16 * t + 4 * q + e for t in range(4) for e in range(4)]
                    lo = [k for k in lo if k < c0 + cw]
                    for ks in (lo, [half + k for k in lo]):  # products 2q and 2q + 1
                        if ks:
                            seen[ks] += 1
                            acc[q] = acc[q] + prods[:, :, ks].sum(axis=2, dtype=np.float32)
        warp = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        total = warp if total is None else total + warp
    assert (seen == 1).all()  # the permutation takes every column once
    y = torch.from_numpy(total * scale.numpy()[None, :]).bfloat16()
    return y, prods


@pytest.mark.parametrize("wk", [1, 2, 8])
@pytest.mark.parametrize("b,din,dout", [
    (1, 4096, 24),      # one chunk (the gate's v, o, gate/up input at B 1)
    (4, 4096, 17),      # one chunk at B 4
    (8, 4096, 16),      # two chunks at B 8
    (4, 14336, 16),     # the down projection: four chunks at B 4
    (8, 14336, 9),      # seven chunks at B 8
    (3, 2080, 40),      # a partial last 64-column step, B rounded up to 4
])
def test_int4_tc_permuted_sum_matches_plain_and_jax(rng, wk, b, din, dout):
    """``wk``, the warps that split a tile's columns: on an H100 the host
    picks 8 for the gate's v, o and down at every B (o and down with two
    tiles a warp from B 3) and 2 for gate/up
    (``test_int4_grid_splits_tiles_over_whole_warps``); 1 is a block of
    8 or 16 tiles."""
    w = (rng.standard_normal((dout, din)) * 0.05).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((b, din)).astype(np.float32)).bfloat16()
    tq = tquant.quantize_linear_weight_int4_pc(torch.from_numpy(w))
    out, prods = int4_tc_emulation(x, tq["w_int4pc"], tq["scale"], wk)
    # every product of a bf16 x and a nibble is exact in fp32
    exact = x.double().numpy()[:, None, :] * unpack(tq["w_int4pc"].numpy()).astype(np.float64)[None]
    assert np.array_equal(prods.astype(np.float64), exact)
    ref = int4_matvec_ref(x, tq["w_int4pc"], tq["scale"])
    assert torch.equal(int4_matvec(x, tq["w_int4pc"], tq["scale"]), ref)
    assert _excess(out.float(), ref.float()) <= 0, _excess(out.float(), ref.float())
    if wk == 8:  # the interpreted Pallas kernel once a shape
        jref = jint4.int4_matvec(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                 jnp.asarray(tq["w_int4pc"].numpy()),
                                 jnp.asarray(tq["scale"].numpy()))
        assert _excess(out.float(), np.asarray(jref, np.float32)) <= 0


@pytest.mark.parametrize("b", range(1, 9))
def test_int4_grid_splits_tiles_over_whole_warps(b):
    """The host's grid for the gate's four linears on a 132-SM card (an
    H100): one or (from B 3) two tiles a warp, a power of two of warps
    splitting each tile's columns, a block for nearly every SM."""
    for dout in (1024, 4096, 14336):
        tw, rt = _grid(b, dout, 132)
        wk = 8 * tw // rt
        assert tw in ((1, 2) if b > 2 else (1,)) and wk in (1, 2, 4, 8) and wk * rt == 8 * tw
        assert -(-dout // (16 * rt)) >= min(64, 4 * 132 // 5)
    assert _grid(b, 14336, 132) == ((2, 8) if b > 2 else (1, 4))
