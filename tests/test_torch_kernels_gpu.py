"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Every test is marked ``gpu`` and skips without a CUDA device (the kernels
have no CPU mode; on the CPU the wrappers take the plain versions, which
tests/test_torch_ops.py and tests/test_torch_paged.py hold against the JAX
package).  Tolerances: fp32 outputs 1e-4 (sums in another order); bf16
outputs 4e-3 + 1e-2·|ref| (one bf16 rounding step either way, plus about
twice the largest error measured on an H100 at the main path's shapes, as
in chip_smoke.py); paged attention splits each row's keys over blocks and
merges them in a fixed order, so a second call must give the same bits, and
with a decode step's new token (written in the same launch) pools and
output must be bitwise what the plain write then the write-free kernel
give.  The
training kernels get the same output limits (kernel and plain version read
the same inputs and both accumulate in fp32), but for the bf16 dQ, dK and
dV: the tensor-core kernels round each dS and P term to bf16 before its
product, which their CPU emulation (tests/test_torch_attention_tc.py) puts
at up to 1.54e-2 beside rtol 1e-2 at the training shapes, so they take
3e-2 + 1e-2·|ref|, as in chip_smoke.py; the fp32 lse 1e-4.  The int8 and
int4 matvecs and the selective scan take the same limits: each sums in
fp32 in another order than its plain version, and rounds once to the
output dtype.
The flash forward, its backward (dQ and dK/dV) and exact attention run
bf16 on their tensor-core instantiation and fp32 on the CUDA-core one;
``.tc_launches`` counts the former.  GQA groups that do not divide 128
(Qwen2-7B's 7) run on the bf16 flash forward and dQ kernels, which pack
floor(128 / group) whole groups into a block.
"""
import numpy as np
import pytest
import torch

from streammind_torch.ops import attention as A
from streammind_torch.ops import paged_attention as PA
from streammind_torch.ops import scan as S
from streammind_torch.ops.int4_matvec import int4_matvec, int4_matvec_ref
from streammind_torch.ops.int8_matvec import int8_matvec, int8_matvec_ref
from streammind_torch.utils.quantize import quantize_linear_weight, quantize_linear_weight_int4_pc

pytestmark = pytest.mark.gpu
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (4e-3, 1e-2)}
BWD_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: (3e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


def _r(rng, shape, dtype, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")


def _close(out, ref, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,d,kv_len,q_off",
    [
        (1, 70, 300, 8, 2, 128, [250], [180]),
        (2, 33, 128, 4, 4, 64, [100, 0], [67, 0]),   # kv_len 0 gives zeros
        (1, 64, 8192, 32, 8, 128, [164], [100]),      # the 7B prefill over its cache
        (1, 1, 577, 8, 1, 128, [577], [576]),         # one query, GQA 8 (16 queries a block)
        (3, 37, 64, 8, 2, 128, [64, 37, 1], [27, 0, 63]),  # a q_offset per row
        (2, 130, 8192, 16, 16, 64, [130, 97], [0, 0]),     # GQA 1, diagonal tiles
        (1, 64, 8192, 28, 4, 128, [164], [100]),      # GQA 7 (Qwen2-7B's heads), bucket 64
        (2, 37, 300, 7, 1, 64, [250, 37], [213, 0]),  # GQA 7, 18 queries a block
    ],
)
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, h, hkv, d, kv_len, q_off):
    rng = np.random.default_rng(0)
    q = _r(rng, (b, sq, h, d), dtype)
    k, v = _r(rng, (b, sk, hkv, d), dtype), _r(rng, (b, sk, hkv, d), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    offs = torch.tensor(q_off, dtype=torch.int32, device=dev)
    n0, tc0 = A.flash_attention.launches, A.flash_attention.tc_launches
    out = A.flash_attention(q, k, v, causal=True, kv_len=lens, q_offset=offs)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == n0 + 1
    assert A.flash_attention.tc_launches == tc0 + (dtype == torch.bfloat16)
    _close(out, A.flash_attention_ref(q, k, v, causal=True, kv_len=lens, q_offset=offs), dtype)
    if 0 in kv_len:
        assert float(out[kv_len.index(0)].abs().max()) == 0.0


TRAIN_CASES = [
    # b, s, h, hkv, d, kv_len, causal
    (1, 130, 8, 2, 128, [130], True),        # GQA 4, ragged last tiles
    (2, 97, 4, 4, 64, [70, 0], True),        # kv_len 0: output 0, finite lse, zero grads
    (2, 64, 8, 2, 64, [64, 33], False),      # non-causal, right-padded
    (1, 300, 32, 8, 128, [300], True),       # Mistral's heads
    (1, 130, 28, 4, 128, [130], True),       # GQA 7 (Qwen2-7B's heads)
    (2, 97, 7, 1, 64, [97, 0], True),        # GQA 7, kv_len 0
    (2, 70, 14, 2, 128, [70, 41], False),    # GQA 7, non-causal, right-padded
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d,kv_len,causal", TRAIN_CASES)
def test_flash_lse_and_backward_kernels_match_plain(dev, dtype, b, s, h, hkv, d, kv_len,
                                                    causal):
    rng = np.random.default_rng(6)
    q, do = _r(rng, (b, s, h, d), dtype), _r(rng, (b, s, h, d), dtype)
    k, v = _r(rng, (b, s, hkv, d), dtype), _r(rng, (b, s, hkv, d), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    fns = (A.flash_attention_lse, A.flash_bwd_dq, A.flash_bwd_dkv)
    n0, tc0 = tuple(f.launches for f in fns), tuple(f.tc_launches for f in fns)
    out, lse = A.flash_attention(q, k, v, causal=causal, kv_len=lens, return_lse=True)
    ref_out, ref_lse = A.flash_attention_ref(q, k, v, causal=causal, kv_len=lens,
                                             return_lse=True)
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = A.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, lens)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, lens)
    torch.cuda.synchronize()
    assert tuple(f.launches for f in fns) == tuple(n + 1 for n in n0)
    assert tuple(f.tc_launches for f in fns) == tuple(n + (dtype == torch.bfloat16) for n in tc0)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    assert torch.isfinite(lse).all()
    # dQ and dK/dV fed the kernel's own lse stay within the same limits
    dq_k = A.flash_bwd_dq(q, k, v, do, lse, delta, causal, lens)
    dk_k, dv_k = A.flash_bwd_dkv(q, k, v, do, lse, delta, causal, lens)
    for got, ref in ((dq_k, dq), (dk_k, dk), (dv_k, dv)):
        _close(got, ref, dtype, BWD_TOL)
    ref_dq = A.flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal, lens)
    ref_dk, ref_dv = A.flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal, lens)
    assert dq.dtype == q.dtype and dk.shape == k.shape and dv.dtype == v.dtype
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        _close(got, ref, dtype, BWD_TOL)
    for got, ref in ((dq_k, ref_dq), (dk_k, ref_dk), (dv_k, ref_dv)):
        _close(got, ref, dtype, BWD_TOL)
    if 0 in kv_len:
        i = kv_len.index(0)
        assert float(out[i].abs().max()) == 0.0
        assert float(dq[i].abs().max()) == float(dk[i].abs().max()) == float(dv[i].abs().max()) == 0


def test_flash_mha_gradients_on_the_card_match_autograd_of_the_reference(dev):
    """The autograd Function end to end (lse forward, delta, both backward
    kernels) against autograd through mha_reference, fp32, GQA, ragged."""
    rng = np.random.default_rng(7)
    b, s, h, hkv, d = 2, 150, 8, 2, 64
    lens = torch.tensor([150, 91], dtype=torch.int32, device=dev)
    mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
    w = _r(rng, (b, s, h, d), torch.float32)
    grads = []
    for fn in (lambda q, k, v: A.flash_mha(q, k, v, lens, True),
               lambda q, k, v: A.mha_reference(q, k, v, causal=True, kv_mask=mask)):
        rs = np.random.default_rng(8)
        q, k, v = (_r(rs, shape, torch.float32).requires_grad_()
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
        (fn(q, k, v) * w).sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 577, 16, 16, 64), (1, 37, 4, 2, 128),
                                         (1, 3000, 2, 2, 64),   # > 2048 keys: 8-row fp32 tiles
                                         (1, 4096, 2, 2, 128), (4, 577, 16, 16, 64),
                                         (1, 1, 8, 1, 64)])
def test_exact_kernel_matches_plain(dev, dtype, b, s, h, hkv, d):
    rng = np.random.default_rng(1)
    if h == hkv:  # the ViT's layout: strided views of one fused qkv
        qkv = _r(rng, (b, s, 3, h, d), dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (_r(rng, (b, s, n, d), dtype) for n in (h, hkv, hkv))
    n0, tc0 = A.exact_attention.launches, A.exact_attention.tc_launches
    out = A.exact_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.exact_attention.launches == n0 + 1
    assert A.exact_attention.tc_launches == tc0 + (dtype == torch.bfloat16)
    _close(out, A.exact_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_grid_limit(dev, dtype):
    """B*H near the 65535 the wrappers allow: the first and last batch rows
    (the largest block indices) against the plain versions."""
    rng = np.random.default_rng(14)
    b, h, hkv, d = 2047, 32, 8, 64                          # B*H = 65504
    q = _r(rng, (b, 3, h, d), dtype)
    k, v = _r(rng, (b, 70, hkv, d), dtype), _r(rng, (b, 70, hkv, d), dtype)
    lens = torch.tensor(rng.integers(3, 71, b), dtype=torch.int32, device=dev)
    offs = lens - 3
    out = A.flash_attention(q, k, v, causal=True, kv_len=lens, q_offset=offs)
    qkv = _r(rng, (4095, 5, 3, 16, 64), dtype)              # B*H = 65520
    ex = A.exact_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    torch.cuda.synchronize()
    for rows in (slice(0, 3), slice(b - 3, b)):
        _close(out[rows], A.flash_attention_ref(q[rows], k[rows], v[rows], causal=True,
                                                kv_len=lens[rows], q_offset=offs[rows]), dtype)
    for rows in (slice(0, 3), slice(4092, 4095)):
        x = qkv[rows]
        _close(ex[rows], A.exact_attention_ref(x[:, :, 0], x[:, :, 1], x[:, :, 2]), dtype)


def test_bf16_wrappers_refuse_what_the_tensor_core_kernels_do_not_take(dev):
    """bf16 rows are loaded 16 bytes at a time: a view whose head stride is
    not a multiple of 8 elements is refused (no silent copy) by the flash
    forward, exact attention, dQ and dK/dV; fp32 takes it on the CUDA-core
    instantiation.  A GQA group of 3, which does not divide the flash
    kernel's 128 rows, runs on both."""
    base = torch.zeros(1, 9, 4, 66, device=dev)
    fns = (A.flash_attention, A.exact_attention, A.flash_bwd_dq, A.flash_bwd_dkv)
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype)[..., :64]                        # head stride 66
        lse = torch.zeros(1, 9, 4, device=dev)
        n0 = tuple(f.tc_launches for f in fns)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte"):
                A.flash_attention(x, x, x, causal=True)
            with pytest.raises(ValueError, match="16-byte"):
                A.exact_attention(x, x, x)
            c = x.contiguous()
            for bad in ((x, c, c, c), (c, c, c, x)):        # a misaligned q, then dO
                with pytest.raises(ValueError, match="16-byte"):
                    A.flash_bwd_dq(*bad, lse, lse)
                with pytest.raises(ValueError, match="16-byte"):
                    A.flash_bwd_dkv(*bad, lse, lse)
            assert tuple(f.tc_launches for f in fns) == n0
        else:
            A.flash_attention(x, x, x, causal=True)
            A.exact_attention(x, x, x)
            A.flash_bwd_dq(x, x, x, x, lse, lse)
            A.flash_bwd_dkv(x, x, x, x, lse, lse)
        q3 = torch.zeros(1, 9, 3, 64, device=dev, dtype=dtype)
        A.flash_attention(q3, x[:, :, :1].contiguous(), x[:, :, :1].contiguous(), causal=True)
        torch.cuda.synchronize()
        assert tuple(f.tc_launches for f in fns) == tuple(
            n + (dtype == torch.bfloat16 and f is A.flash_attention) for n, f in zip(n0, fns))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,din,dout", [
    *[(b, 4096, 1024) for b in (1, 4, 8)],                 # the gate's v at B 1, 4, 8
    (1, 4096, 4096), (4, 4096, 14336), (8, 14336, 4096),   # o, gate/up, down (7 chunks at B 8)
    (8, 14336, 64), (4, 14336, 40),                        # x staged in chunks at B 8 and 4
    (3, 30, 17), (5, 200, 40),                             # packed rows not a multiple of 16 bytes
    (5, 2080, 40), (6, 4160, 23),                          # a partial last step, odd rows
    *[(b, 4096, 1024) for b in (2, 3, 5, 6, 7)],           # every other B the kernel takes
])
def test_int4_kernel_matches_plain(dev, dtype, b, din, dout):
    rng = np.random.default_rng(2)
    pk = quantize_linear_weight_int4_pc(_r(rng, (dout, din), torch.float32, 0.02))
    x = _r(rng, (b, din), dtype)
    n0 = int4_matvec.launches
    out = int4_matvec(x, pk["w_int4pc"], pk["scale"])
    torch.cuda.synchronize()
    assert int4_matvec.launches == n0 + 1 and out.dtype == dtype and out.shape == (b, dout)
    _close(out, int4_matvec_ref(x, pk["w_int4pc"], pk["scale"]), dtype)


def test_int4_quantize_bytes_do_not_depend_on_the_device(dev):
    """The card packs the same bytes and scales as the CPU (which the CPU
    tests hold equal to the JAX package's)."""
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((4, 512, 1024)) * 0.02, dtype=torch.float32)
    on_cpu = quantize_linear_weight_int4_pc(w)
    on_card = quantize_linear_weight_int4_pc(w.to(dev))
    assert torch.equal(on_card["w_int4pc"].cpu(), on_cpu["w_int4pc"])
    assert torch.equal(on_card["scale"].cpu(), on_cpu["scale"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,din,dout", [
    (1, 4096, 1024), (8, 4096, 6144), (4, 14336, 4096),   # the gate's v, fused qkv, down
    (2, 4096, 28672),                                      # the fused gate/up
    (3, 30, 17), (5, 200, 40), (7, 1000, 9),               # rows not a multiple of 16 bytes
    (8, 14336, 4096),                                      # x staged in chunks at B 8
    (5, 2064, 40), (6, 4160, 23),                          # a partial last 64-column step, odd rows
    *[(b, 4096, 1024) for b in (2, 3, 5, 6, 7, 8)],        # every B the kernel takes
])
def test_int8_kernel_matches_plain(dev, dtype, b, din, dout):
    rng = np.random.default_rng(9)
    q = quantize_linear_weight(_r(rng, (dout, din), torch.float32, 0.02))
    x = _r(rng, (b, din), dtype)
    n0 = int8_matvec.launches
    out = int8_matvec(x, q["w_int8"], q["scale"])
    torch.cuda.synchronize()
    assert int8_matvec.launches == n0 + 1 and out.dtype == dtype and out.shape == (b, dout)
    _close(out, int8_matvec_ref(x, q["w_int8"], q["scale"]), dtype)


def test_int8_quantize_bytes_do_not_depend_on_the_device(dev):
    rng = np.random.default_rng(10)
    w = torch.tensor(rng.standard_normal((4, 512, 1024)) * 0.02, dtype=torch.float32)
    on_cpu, on_card = quantize_linear_weight(w), quantize_linear_weight(w.to(dev))
    assert torch.equal(on_card["w_int8"].cpu(), on_cpu["w_int8"])
    assert torch.equal(on_card["scale"].cpu(), on_cpu["scale"])


def _scan_case(rng, dtype, b, d, length, n, with_h0):
    """u, dt, z as the Mamba mixer hands them over: (B, D, L) views of the
    projections' (B, L, D) products, channels contiguous; B and C (B, N, L)
    views of the (B, L, R + 2N) product; A, D, dt_bias fp32, as the tree
    keeps them."""
    xz = _r(rng, (b, length, 2 * d), dtype)
    x_dbl = _r(rng, (b, length, 8 + 2 * n), dtype)
    dt = _r(rng, (b, length, d), dtype, 0.5)
    u, z = xz[..., :d].transpose(1, 2), xz[..., d:].transpose(1, 2)
    Bm, Cm = x_dbl[..., 8:8 + n].transpose(1, 2), x_dbl[..., 8 + n:].transpose(1, 2)
    A = -torch.exp(_r(rng, (d, n), torch.float32, 0.5))
    h0 = _r(rng, (b, d, n), torch.float32) if with_h0 else None
    return (u, dt.transpose(1, 2), A, Bm, Cm), dict(
        D=_r(rng, (d,), torch.float32), z=z, delta_bias=_r(rng, (d,), torch.float32),
        delta_softplus=True, return_last_state=True, h0=h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,length,n", [
    (1, 8192, 32, 16), (2, 384, 1, 16), (1, 200, 8, 16), (3, 64, 64, 16),
    (1, 96, 150, 16),                         # 150 steps: five chunks of 32
    (2, 100, 20, 1), (2, 100, 20, 3), (1, 256, 40, 8),  # N that leaves lanes of a group empty
    (1, 100, 31, 16), (1, 100, 32, 16), (1, 100, 33, 16),  # a chunk - 1, a chunk, a chunk + 1
    (2, 200, 100, 16),                        # over three chunks; D 100, 200: rows not 16 bytes
    (4, 8192, 32, 16),                        # B 4
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_kernel_matches_plain(dev, dtype, b, d, length, n, with_h0):
    rng = np.random.default_rng(11)
    args, kw = _scan_case(rng, dtype, b, d, length, n, with_h0)
    n0 = S.selective_scan_kernel.launches
    y, h = S.selective_scan(*args, **kw, impl="pallas")
    torch.cuda.synchronize()
    assert S.selective_scan_kernel.launches == n0 + 1
    ref_y, ref_h = S.selective_scan_ref(*args, **kw)
    assert y.dtype == dtype and y.shape == (b, d, length) and h.dtype == torch.float32
    _close(y, ref_y, dtype)
    torch.testing.assert_close(h, ref_h, atol=1e-4, rtol=1e-4)


def test_selective_scan_kernel_without_z_d_or_bias(dev):
    rng = np.random.default_rng(12)
    args, _ = _scan_case(rng, torch.float32, 2, 100, 20, 4, False)
    y = S.selective_scan(*args, impl="pallas")
    torch.cuda.synchronize()
    _close(y, S.selective_scan_ref(*args), torch.float32)


def _relayout(t, how):
    """The same (B, D, L) values in another memory layout."""
    if how == "time-contiguous":   # the burst's u: the conv output past its 3-step window
        buf = torch.zeros(t.shape[0], t.shape[1], t.shape[2] + 3, dtype=t.dtype, device=t.device)
        buf[..., 3:] = t
        return buf[..., 3:]
    if how == "strided channels":  # neither stride 1
        buf = torch.zeros(t.shape[0], t.shape[2], 2 * t.shape[1], dtype=t.dtype, device=t.device)
        buf[..., ::2] = t.transpose(1, 2)
        return buf[..., ::2].transpose(1, 2)
    return t.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["time-contiguous", "strided channels", "contiguous"])
@pytest.mark.parametrize("n", [16, 3])
def test_selective_scan_kernel_takes_any_layout(dev, dtype, how, n):
    """u, dt and z in layouts that take the element path (the burst's own u is
    contiguous in time); y and the last state as the plain version gives
    them, and the same bits from a second call (a channel's lanes sum in a
    fixed order, no atomics)."""
    rng = np.random.default_rng(14)
    args, kw = _scan_case(rng, dtype, 2, 200, 40, n, True)
    u, dt = _relayout(args[0], how), _relayout(args[1], how)
    kw["z"] = _relayout(kw["z"], how)
    args = (u, dt) + args[2:]
    y, h = S.selective_scan(*args, **kw, impl="pallas")
    y2, h2 = S.selective_scan(*args, **kw, impl="pallas")
    torch.cuda.synchronize()
    ref_y, ref_h = S.selective_scan_ref(*args, **kw)
    _close(y, ref_y, dtype)
    torch.testing.assert_close(h, ref_h, atol=1e-4, rtol=1e-4)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_selective_scan_kernel_has_no_backward(dev):
    rng = np.random.default_rng(13)
    args, kw = _scan_case(rng, torch.float32, 1, 64, 4, 16, True)
    u = args[0].detach().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        S.selective_scan(u, *args[1:], **kw, impl="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "h,hkv,d,page,maxp,lengths",
    [
        (32, 8, 128, 64, 128, [36, 36, 36]),       # the serving turn's K = 3 step
        (32, 8, 128, 64, 128, [8191]),              # one row filling its 8192-token table
        # K 8: the write at 0, inside and at the end of a table, and one row
        # at its table's edge (its token goes to the sink page)
        (32, 8, 128, 64, 128, [8191, 36, 8192, 2999, 63, 64, 4999, 0]),
        (28, 4, 128, 16, 40, [255, 256, 511, 639, 640]),  # Qwen2-7B's group of 7, pages of 16
        (4, 4, 64, 8, 5, [39, 17]),                 # MHA, page 8, D 64
    ],
)
def test_paged_attention_with_the_write_is_bitwise_write_then_attend(dev, dtype, h, hkv, d,
                                                                     page, maxp, lengths):
    """paged_decode_attention with k_new/v_new writes each row's token at
    its slot and attends over length + 1 positions in one launch: pools and
    output bitwise what ``write_tokens_ref`` then the write-free kernel
    give, and the same bits on a second call."""
    rng = np.random.default_rng(4)
    k = len(lengths)
    pages = k * maxp + 1
    pool_k, pool_v = (_r(rng, (hkv, pages, page, d), dtype) for _ in range(2))
    q = _r(rng, (k, 1, h, d), dtype)
    k_new, v_new = _r(rng, (k, hkv, d), torch.float32), _r(rng, (k, hkv, d), torch.float32)
    table = torch.tensor(rng.permutation(np.arange(1, pages)).reshape(k, maxp),
                         dtype=torch.int32, device=dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ref_k, ref_v = pool_k.clone(), pool_v.clone()
    PA.write_tokens_ref(ref_k, ref_v, k_new, v_new, *PA.token_slots(table, length, page))
    ref = PA.paged_decode_attention(q, ref_k, ref_v, table, length + 1)
    runs = []
    for _ in range(2):
        pk, pv = pool_k.clone(), pool_v.clone()
        n0 = PA.paged_decode_attention.write_launches
        runs.append((PA.paged_decode_attention(q, pk, pv, table, length, k_new=k_new,
                                               v_new=v_new), pk, pv))
        assert PA.paged_decode_attention.write_launches == n0 + 1
    torch.cuda.synchronize()
    for out, pk, pv in runs:
        assert torch.equal(pk, ref_k) and torch.equal(pv, ref_v)
        assert torch.equal(out, ref)
    _close(ref, PA.paged_decode_attention_ref(q, pool_k.clone(), pool_v.clone(), table, length,
                                              k_new, v_new), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "h,hkv,d,page,maxp,lengths",
    [
        (32, 8, 128, 64, 8, [1, 512, 513, 100]),   # Mistral's heads: short, full, past the table
        (4, 4, 64, 8, 5, [40, 17]),                # MHA, page 8, full row
        (16, 2, 128, 16, 6, [95, 33, 64]),         # group of 8 (the kernel's most)
        # 128-page tables: one 8192-token row beside short, ragged and
        # finished rows, and a row of length 0
        (32, 8, 128, 64, 128, [8192, 37, 8193, 3000, 0, 65, 5000, 129]),
        # lengths about a split boundary (spans of 256 and 512), pages of 8
        (28, 4, 128, 8, 160, [255, 256, 257, 511, 512, 513, 1023, 1280]),
        (28, 4, 128, 16, 40, [1, 300, 640, 641]),  # Qwen2-7B's group of 7, pages of 16
    ],
)
def test_paged_attention_kernel_matches_plain(dev, dtype, h, hkv, d, page, maxp, lengths):
    """Against the plain version; a row of length 0 gives 0; a second call
    gives the same bits (the splits merge in a fixed order)."""
    rng = np.random.default_rng(5)
    k = len(lengths)
    pages = k * maxp + 1
    pool_k, pool_v = (_r(rng, (hkv, pages, page, d), dtype) for _ in range(2))
    q = _r(rng, (k, 1, h, d), dtype)
    table = torch.tensor(rng.permutation(np.arange(1, pages)).reshape(k, maxp),
                         dtype=torch.int32, device=dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n0 = PA.paged_decode_attention.launches
    out = PA.paged_decode_attention(q, pool_k, pool_v, table, length)
    again = PA.paged_decode_attention(q, pool_k, pool_v, table, length)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == n0 + 2 and out.shape == q.shape
    assert torch.equal(out, again)
    live = [i for i, n in enumerate(lengths) if n > 0]
    ref = PA.paged_decode_attention_ref(q, pool_k, pool_v, table, length)
    _close(out[live], ref[live], dtype)
    assert not out[[i for i, n in enumerate(lengths) if n == 0]].any()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="rows"):
        pk = quantize_linear_weight_int4_pc(torch.zeros(8, 16, device=dev))
        int4_matvec(torch.zeros(9, 16, device=dev), pk["w_int4pc"], pk["scale"])
    q8 = quantize_linear_weight(torch.zeros(8, 16, device=dev))
    with pytest.raises(ValueError, match="rows"):
        int8_matvec(torch.zeros(9, 16, device=dev), q8["w_int8"], q8["scale"])
    with pytest.raises(ValueError, match="do not agree"):
        int8_matvec(torch.zeros(1, 32, device=dev), q8["w_int8"], q8["scale"])
    with pytest.raises(ValueError, match="share one dtype"):
        S.selective_scan(q, q.bfloat16(), torch.zeros(8, 4, device=dev), q, q, impl="pallas")
    pool = torch.zeros(2, 3, 8, 32, device=dev)
    table = torch.ones(1, 2, dtype=torch.int32, device=dev)
    length = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        PA.paged_decode_attention(torch.zeros(1, 1, 4, 32, device=dev), pool, pool, table, length)
    pool = torch.zeros(1, 3, 8, 64, device=dev)
    with pytest.raises(ValueError, match="group"):
        PA.paged_decode_attention(torch.zeros(1, 1, 16, 64, device=dev), pool, pool, table, length)
    with pytest.raises(ValueError, match="new tokens"):
        PA.paged_decode_attention(torch.zeros(1, 1, 4, 64, device=dev), pool, pool, table,
                                  length, k_new=torch.zeros(1, 2, 64, device=dev),
                                  v_new=torch.zeros(1, 2, 64, device=dev))
    with pytest.raises(ValueError, match="together"):
        PA.paged_decode_attention(torch.zeros(1, 1, 4, 64, device=dev), pool, pool, table,
                                  length, k_new=torch.zeros(1, 1, 64, device=dev))
    q = torch.zeros(1, 8, 4, 64, device=dev)
    lse = torch.zeros(1, 8, 4, device=dev)
    with pytest.raises(ValueError, match="lse"):
        A.flash_bwd_dq(q, q, q, q, lse.double(), lse)
    with pytest.raises(ValueError, match="dO"):
        A.flash_bwd_dkv(q, q, q, q[:, :4], lse, lse)
