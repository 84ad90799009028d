"""The arithmetic of the bf16 tensor-core attention kernels, on the CPU.

``csrc/flash_attention.cu``, ``csrc/exact_attention.cu``,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` run bf16 inputs on
Hopper's tensor cores, with other rounding points than their plain
versions (which keep the TPU kernels' arithmetic).  The CUDA kernels cannot
run here, so this file holds a test-local emulation of those rounding
points against the port's plain versions (``flash_attention_ref``,
``exact_attention_ref``, ``flash_bwd_dq_ref``, ``flash_bwd_dkv_ref``), the
JAX package's Pallas kernels in interpret mode (the backward through
``jax.vjp`` of ``flash_mha``) and its ``mha_reference`` (on the same values
in fp32), on bf16 inputs made by numpy from a seed.
The card holds the kernels against the plain versions
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Rounding points emulated:
  * flash: S = q k^T of the bf16 inputs (exact products, fp32 sums), the
    scale applied to the fp32 S after the product (the plain version scales
    q in fp32 first); online (m, l) over 64-key tiles; P rounded to bf16
    before an fp32 P V; out = acc / max(l, 1e-30) rounded once;
    lse = m + log(l).
  * exact: the same S; pass 1 the row max and an fp32 sum with an online
    rescale over 64-key tiles; pass 2 p = exp(s - m) / l, rounded to bf16
    AFTER the division, then an fp32 P V rounded once.
  * backward (dQ and dK/dV): the same S, the scale after the product;
    P = 2^(s·scale·log2e − lse·log2e), 0 where unseen; dP = dO Vᵀ in fp32;
    dS = P (dP − delta) in fp32, rounded to bf16 before dQ = dS K and
    dK = dSᵀ q; P rounded to bf16 before dV = Pᵀ dO; fp32 sums (dK and dV
    over the GQA group too); dQ and dK times the scale at the end, then
    each rounded once.

Tolerances, with the margin each leaves under the card's limits
(``chip_smoke.py``: bf16 outputs |err| <= 4e-3 + 1e-2 |ref|):
  * outputs against the plain versions and the JAX package:
    |err| <= 2e-3 + 8e-3 |ref|: one step of the final bf16 rounding (2**-7
    of |ref| at the bottom of a binade; measured here: 7.8e-3 at |ref| ~1)
    plus the bf16 rounding of P; it leaves 2e-3 + 2e-3 |ref| of the card's
    limit to the device's summation order and its exp;
  * lse against the plain version: |err| <= 2e-6 + 2e-7 |ref| (the scale
    after the dot moves s by a few fp32 ulps of |s|; measured here: at most
    1.4e-6 at |lse| ~4); the card's limit is set in chip_smoke.py;
  * exact against its plain version: the same max and, up to the sum's
    order, the same l, so a prob can only flip by one bf16 step:
    |err| <= 1e-3 + 2e-3 |ref|;
  * dQ, dK and dV against the plain versions and the JAX package (which
    agree exactly here): |err| <= 1.5e-2 + 8e-3 |ref|.  The final bf16
    rounding takes up to 7.8e-3 |ref|; the bf16 rounding of each dS and P
    term (2**-9 relative, random in sign) moves a sum of n terms by about
    2**-9 of their root-mean-square, not of the sum, so an output near 0
    beside large terms takes an absolute error: measured here, 9.1e-3 at
    most beside 8e-3 |ref| (dV, GQA 7); the limit is half the card's
    3e-2 + 1e-2 |ref|.  Run as a script (``PYTHONPATH=. python
    tests/test_torch_attention_tc.py``), this file measures the emulation
    against the plain versions at the card's timed training shapes, which
    is where chip_smoke.py's limit for the two kernels comes from.
"""
import importlib
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_torch.ops import _build
from streammind_torch.ops import attention as tattn

jattn = importlib.import_module("streammind_tpu.ops.attention")

OUT_TOL = (2e-3, 8e-3)
BWD_TOL = (1.5e-2, 8e-3)
LSE_TOL = (2e-6, 2e-7)
EXACT_TOL = (1e-3, 2e-3)
TILE = 64


def _bf16(rng, shape):
    """bf16 values as a torch bf16 tensor and the same values as a jnp array."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32_jnp(*xs):
    """The same values in fp32: mha_reference then keeps probs and P V in fp32
    (in bf16, XLA on the CPU rounds the product's sums as well)."""
    return [x.astype(jnp.float32) for x in xs]


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))


def _excess(out, ref, tol):
    """max of |out - ref| - (atol + rtol |ref|): <= 0 when within tol."""
    out, ref = _f32(out), _f32(ref)
    return float(((out - ref).abs() - (tol[0] + tol[1] * ref.abs())).max())


def _assert_within(out, ref, tol):
    assert _excess(out, ref, tol) <= 0, _excess(out, ref, tol)


def _grouped(x, h):
    """(B, S, Hkv, D) -> (B, H, S, D) fp32, kv heads repeated over their group."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2).transpose(1, 2)


def flash_tc_emulation(q, k, v, causal, kv_len, q_offset):
    """The bf16 tensor-core flash kernel's rounding points: (out bf16, lse fp32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float().transpose(1, 2), _grouped(k, h), _grouped(v, h)
    out = torch.zeros(b, h, sq, d)
    lse = torch.full((b, h, sq), tattn.NEG_INF)
    for bi in range(b):
        L, off = min(int(kv_len[bi]), sk), int(q_offset[bi])
        if L == 0:  # no tile is read: out 0, lse -1e30 + log(1e-30)
            continue
        s_all = (qf[bi] @ kf[bi].transpose(1, 2)) * scale          # fp32 sums, then the scale
        kpos = torch.arange(sk)[None, :]
        qpos = torch.arange(sq)[:, None] + off
        vis = (kpos < L) & ((kpos <= qpos) if causal else True)
        s_all = torch.where(vis, s_all, tattn.NEG_INF)
        m = torch.full((h, sq, 1), tattn.NEG_INF)
        l = torch.zeros(h, sq, 1)
        acc = torch.zeros(h, sq, d)
        for k0 in range(0, L, TILE):
            s = s_all[..., k0:k0 + TILE]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[bi, :, k0:k0 + TILE]
            m = m_new
        den = l.clamp(min=1e-30)
        out[bi] = acc / den
        lse[bi] = (m + torch.log(den))[..., 0]
    return out.transpose(1, 2).bfloat16(), lse.transpose(1, 2)


def exact_tc_emulation(q, k, v):
    """The bf16 tensor-core exact kernel's two passes: out bf16."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = (q.float().transpose(1, 2) @ _grouped(k, h).transpose(2, 3)) * (1.0 / math.sqrt(d))
    m = torch.full((b, h, sq, 1), tattn.NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    for k0 in range(0, sk, TILE):                                   # pass 1, online
        m_new = torch.maximum(m, s[..., k0:k0 + TILE].amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s[..., k0:k0 + TILE] - m_new).sum(-1, keepdim=True)
        m = m_new
    probs = (torch.exp(s - m) / l).bfloat16()                      # pass 2: divide, then round
    return (probs.float() @ _grouped(v, h)).transpose(1, 2).bfloat16()


FLASH_CASES = [
    # b, sq, sk, h, hkv, d, kv_len, q_offset, causal
    (2, 37, 200, 8, 2, 64, [150, 0], [113, 0], True),      # GQA 4, ragged kv_len incl. 0
    (1, 1, 577, 8, 1, 128, [577], [576], True),            # Sq 1 over Sk 577, GQA 8
    (2, 130, 130, 4, 4, 128, [130, 97], [0, 0], True),     # GQA 1, diagonal tiles, 130 keys
    (3, 37, 64, 8, 2, 128, [64, 37, 1], [27, 0, 63], True),  # a q_offset per row
    (1, 64, 300, 16, 2, 64, [250], [186], True),           # GQA 8, the prefill over a cache
    (1, 577, 577, 4, 1, 64, [577], [0], True),             # training-like, 577 tokens
    (2, 64, 100, 8, 2, 64, [100, 33], [0, 0], False),      # non-causal, right-padded
    (1, 70, 150, 7, 1, 64, [150], [80], True),             # GQA 7 (H 7 / Hkv 1)
    (2, 37, 100, 14, 2, 128, [100, 37], [63, 0], True),    # GQA 7 (H 14 / Hkv 2)
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,kv_len,q_off,causal", FLASH_CASES)
def test_flash_tc_arithmetic_matches_plain_and_jax(rng, b, sq, sk, h, hkv, d, kv_len, q_off,
                                                    causal):
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, s) for s in ((b, sq, h, d), (b, sk, hkv, d),
                                                         (b, sk, hkv, d)))
    lens, offs = torch.tensor(kv_len, dtype=torch.int32), torch.tensor(q_off, dtype=torch.int32)
    out, lse = flash_tc_emulation(q, k, v, causal, lens, offs)
    ref, ref_lse = tattn.flash_attention_ref(q, k, v, causal, lens, offs, return_lse=True)
    _assert_within(out, ref, OUT_TOL)
    _assert_within(lse, ref_lse, LSE_TOL)
    jl, jo = jnp.asarray(kv_len, jnp.int32), jnp.asarray(q_off, jnp.int32)
    j_out, j_lse = jattn.flash_attention(jq, jk, jv, causal=causal, kv_len=jl, q_offset=jo,
                                         return_lse=True)
    _assert_within(out, j_out.astype(jnp.float32), OUT_TOL)
    _assert_within(lse, j_lse, LSE_TOL)
    mask = jnp.arange(sk)[None, :] < jl[:, None]
    if 0 not in kv_len:  # mha_reference averages V over a fully masked row
        j_ref = jattn.mha_reference(*_f32_jnp(jq, jk, jv), causal=causal, kv_mask=mask,
                                    q_offset=jo[:, None, None, None])
        _assert_within(out, j_ref.astype(jnp.float32), OUT_TOL)
    else:
        assert float(out[kv_len.index(0)].abs().max()) == 0.0


EXACT_CASES = [
    # b, s, h, hkv, d, fused: q/k/v strided views of one (B, S, 3, H, D) product
    (1, 577, 4, 4, 64, True),     # the ViT's layout and length
    (2, 37, 8, 2, 128, False),    # GQA 4
    (1, 1, 8, 1, 64, False),      # one query and one key, GQA 8
    (1, 130, 2, 2, 128, True),    # a partial last key tile
]


@pytest.mark.parametrize("b,s,h,hkv,d,fused", EXACT_CASES)
def test_exact_tc_arithmetic_matches_plain_and_jax(rng, b, s, h, hkv, d, fused):
    if fused:
        qkv, jqkv = _bf16(rng, (b, s, 3, h, d))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        jq, jk, jv = jqkv[:, :, 0], jqkv[:, :, 1], jqkv[:, :, 2]
    else:
        (q, jq), (k, jk), (v, jv) = (_bf16(rng, (b, s, n, d)) for n in (h, hkv, hkv))
    out = exact_tc_emulation(q, k, v)
    _assert_within(out, tattn.exact_attention_ref(q, k, v), EXACT_TOL)
    _assert_within(out, jattn.exact_attention(jq, jk, jv).astype(jnp.float32), OUT_TOL)
    _assert_within(out, jattn.mha_reference(*_f32_jnp(jq, jk, jv)), OUT_TOL)


def bwd_tc_emulation(q, k, v, do, lse, delta, causal, kv_len):
    """The bf16 tensor-core dQ and dK/dV kernels' rounding points:
    (dq, dk, dv) bf16, dk and dv summed over each GQA group.  Head by head,
    so the timed shapes fit in a few hundred MB."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    log2e = 1.0 / math.log(2.0)
    dq = torch.zeros(b, h, sq, d)
    dk = torch.zeros(b, hkv, sk, d)
    dv = torch.zeros(b, hkv, sk, d)
    kpos, qpos = torch.arange(sk)[None, :], torch.arange(sq)[:, None]
    for bi in range(b):
        L = min(int(kv_len[bi]), sk)
        vis = (kpos < L) & ((kpos <= qpos) if causal else True)
        for hh in range(h):
            qf, dof = q[bi, :, hh].float(), do[bi, :, hh].float()
            kf, vf = k[bi, :, hh // g].float(), v[bi, :, hh // g].float()
            s = qf @ kf.T                                              # fp32 sums, then the scale
            p = torch.exp2(s * (scale * log2e) - lse[bi, :, hh, None].float() * log2e)
            p = torch.where(vis, p, 0.0)
            ds = (p * (dof @ vf.T - delta[bi, :, hh, None].float())).bfloat16().float()
            dq[bi, hh] = (ds @ kf) * scale
            dk[bi, hh // g] += ds.T @ qf
            dv[bi, hh // g] += p.bfloat16().float().T @ dof
    return (dq.transpose(1, 2).bfloat16(), (dk * scale).transpose(1, 2).bfloat16(),
            dv.transpose(1, 2).bfloat16())


def _bwd_case(rng, b, sq, h, hkv, d, kv_len, causal):
    """bf16 q, k, v, dO (torch and jnp), and the plain forward's lse and
    delta = rowsum(dO · O), as the training backward receives them."""
    (q, jq), (k, jk), (v, jv), (do, jdo) = (_bf16(rng, s) for s in (
        (b, sq, h, d), (b, sq, hkv, d), (b, sq, hkv, d), (b, sq, h, d)))
    lens = torch.tensor(kv_len, dtype=torch.int32)
    out, lse = tattn.flash_attention_ref(q, k, v, causal, lens, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, do, lse, delta, lens), (jq, jk, jv, jdo)


BWD_CASES = [
    # b, s, h, hkv, d, kv_len, causal
    (2, 130, 8, 2, 128, [130, 0], True),     # GQA 4, Sq not a multiple of 64, a kv_len-0 row
    (1, 97, 7, 1, 64, [97], True),           # GQA 7 (H 7 / Hkv 1)
    (2, 70, 14, 2, 128, [70, 41], True),     # GQA 7 (H 14 / Hkv 2), ragged
    (2, 64, 4, 4, 64, [64, 33], False),      # GQA 1, non-causal, right-padded
    (1, 150, 14, 2, 64, [150], False),       # GQA 7, non-causal
]


@pytest.mark.parametrize("b,s,h,hkv,d,kv_len,causal", BWD_CASES)
def test_flash_bwd_tc_arithmetic_matches_plain_and_jax(rng, b, s, h, hkv, d, kv_len, causal):
    args, (jq, jk, jv, jdo) = _bwd_case(rng, b, s, h, hkv, d, kv_len, causal)
    got = bwd_tc_emulation(*args[:6], causal, args[-1])
    ref_dq = tattn.flash_bwd_dq_ref(*args[:6], causal, args[-1])
    ref_dk, ref_dv = tattn.flash_bwd_dkv_ref(*args[:6], causal, args[-1])
    for out, ref in zip(got, (ref_dq, ref_dk, ref_dv)):
        _assert_within(out, ref, BWD_TOL)
    jl = jnp.asarray(kv_len, jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_mha(q, k, v, jl, causal), jq, jk, jv)
    for out, ref in zip(got, vjp(jdo)):
        _assert_within(out, ref.astype(jnp.float32), BWD_TOL)
    if 0 in kv_len:  # no visible key: zero gradients
        i = kv_len.index(0)
        assert all(float(t[i].abs().max()) == 0.0 for t in got)


def test_bf16_wrapper_checks_what_the_tensor_core_kernels_take():
    """The 16-byte rule and the GQA group, checked before a bf16 launch: the
    ViT's fused-qkv slices pass; a view whose seq stride is not a multiple of
    8 elements, a misaligned start (of q or of the backward's dO), or more
    than 128 heads a kv head are refused; any group up to 128 (3, 7, 128)
    passes."""
    qkv = torch.zeros(2, 577, 3, 16, 64, dtype=torch.bfloat16)
    tattn._check_tc("exact_attention", qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    odd = torch.zeros(1, 9, 4, 72, dtype=torch.bfloat16)[..., :64]  # head stride 72: fine
    tattn._check_tc("flash_attention", odd, odd, odd)
    bad = torch.zeros(1, 9, 4, 66, dtype=torch.bfloat16)[..., :64]  # head stride 66
    with pytest.raises(ValueError, match="16-byte"):
        tattn._check_tc("flash_attention", bad, bad, bad)
    shifted = torch.zeros(1, 9, 4, 72, dtype=torch.bfloat16)[..., 1:65]  # starts 2 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        tattn._check_tc("flash_attention", shifted, odd, odd)
    one = torch.zeros(1, 1, 1, 70, dtype=torch.bfloat16)[..., :64]  # strides 70, sizes 1
    tattn._check_tc("flash_attention", one, one, one)  # strides of size-1 dims are never used
    with pytest.raises(ValueError, match="16-byte"):
        tattn._check_tc("flash_bwd_dq", odd, odd, odd, do=shifted)
    tattn._check_tc("flash_bwd_dkv", odd, odd, odd, do=odd)
    for group in (3, 7, 128):
        tattn._check_tc("flash_attention", odd, odd, odd, group=group)
    with pytest.raises(ValueError, match="fit"):
        tattn._check_tc("flash_attention", odd, odd, odd, group=129)


def test_lib_path_hashes_the_included_headers(tmp_path):
    """A kernel's library name changes with any csrc header its source
    includes, so a changed header never reuses a stale library; a header it
    does not include leaves the name alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = {p.name for p in _build._sources("flash_attention", csrc)}
    assert names == {"flash_attention.cu", "hopper_attention.cuh"}
    before = {n: _build._lib_path(n, csrc) for n in ("flash_attention", "exact_attention",
                                                     "int4_matvec")}
    assert before["flash_attention"] == _build._lib_path("flash_attention")
    with open(csrc / "hopper_attention.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: _build._lib_path(n, csrc) for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["exact_attention"] != before["exact_attention"]
    assert after["int4_matvec"] == before["int4_matvec"]


# the card's timed training shapes (chip_smoke.py::check_train_kernels):
# b, s, h, hkv, d, kv_len, all causal
TIMED_TRAIN_SHAPES = [
    (1, 2048, 32, 8, 128, [2048]),
    (2, 2048, 32, 8, 128, [2048, 1531]),
    (1, 2048, 32, 8, 64, [2048]),
    (1, 2048, 28, 4, 128, [2048]),
]


def main():
    """The emulated dQ, dK and dV against the plain versions at the card's
    timed shapes, with random bf16 inputs of unit scale as chip_smoke.py
    draws them: per output the largest error, and the smallest (atol, rtol)
    pair of the form (a, 1e-2) that holds it."""
    torch.set_num_threads(4)
    rng = np.random.default_rng(0)
    for b, s, h, hkv, d, kv_len in TIMED_TRAIN_SHAPES:
        args, _ = _bwd_case(rng, b, s, h, hkv, d, kv_len, True)
        got = bwd_tc_emulation(*args[:6], True, args[-1])
        refs = (tattn.flash_bwd_dq_ref(*args[:6], True, args[-1]),
                *tattn.flash_bwd_dkv_ref(*args[:6], True, args[-1]))
        for name, out, ref in zip(("dq", "dk", "dv"), got, refs):
            err = (out.float() - ref.float()).abs()
            need = float((err - 1e-2 * ref.float().abs()).max())
            print(f"q({b},{s},{h},{d}) kv({b},{s},{hkv},{d}) kv_len={kv_len} {name}: "
                  f"max |ref| {float(ref.float().abs().max()):.4g}, max |err| "
                  f"{float(err.max()):.4g}, atol needed beside rtol 1e-2: {need:.4g}",
                  flush=True)


if __name__ == "__main__":
    main()
