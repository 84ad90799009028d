"""streammind_torch ops against the JAX package's, on the CPU.

Every case feeds the same numpy inputs (made from a seed) to the JAX
function — Pallas kernels in interpret mode, as the JAX tests run them —
and to its counterpart in the port, which on CPU tensors takes its plain
PyTorch version.  Inputs are fp32; tolerances are stated per case (fp32
sums taken in another order differ by a few ulps).  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.ops import norms as jnorms
from streammind_tpu.ops import rotary as jrot
from streammind_tpu.ops import scan as jscan
from streammind_tpu.ops.int4_matvec import int4_matvec as j_int4_matvec
from streammind_tpu.streaming import logit_filters as jfilt
from streammind_tpu.utils import quantize as jquant
from streammind_torch.ops import attention as tattn
from streammind_torch.ops import norms as tnorms
from streammind_torch.ops import rotary as trot
from streammind_torch.ops import scan as tscan
from streammind_torch.ops.int4_matvec import int4_matvec
from streammind_torch.streaming import logit_filters as tfilt
from streammind_torch.utils import quantize as tquant

# the JAX package's ops/__init__ re-exports a function named `attention`
jattn = importlib.import_module("streammind_tpu.ops.attention")

FP32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# flash attention (cached prefill)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,d,kv_len,q_off",
    [
        (2, 37, 64, 4, 2, 16, [50, 0], [13, 0]),      # ragged kv_len incl. 0, odd Sq
        (1, 33, 300, 8, 2, 32, [290], [257]),         # q_offset past one 256-key block
        (2, 5, 20, 4, 4, 8, [20, 7], [15, 2]),        # MHA, tiny odd sizes
        (1, 64, 64, 4, 1, 16, None, 0),               # no kv_len, plain causal
    ],
)
def test_flash_attention_matches_jax(rng, b, sq, sk, h, hkv, d, kv_len, q_off):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    jo = jnp.asarray(q_off, jnp.int32)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                kv_len=jl, q_offset=jo)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    to = torch.as_tensor(q_off, dtype=torch.int32)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_len=tl, q_offset=to)
    np.testing.assert_allclose(out.numpy(), _np(ref), **FP32)
    if kv_len is not None and 0 in kv_len:
        # a row with no visible key gives exactly 0
        assert float(out[kv_len.index(0)].abs().max()) == 0.0


def test_flash_ref_blocking_matches_mha_reference(rng):
    """The blocked online softmax equals the plain softmax whatever the block
    sizes (here far smaller than the default 256)."""
    q = _t(rng.standard_normal((1, 19, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((1, 40, 2, 16)).astype(np.float32))
    lens = torch.tensor([35], dtype=torch.int32)
    out = tattn.flash_attention_ref(q, k, v, causal=True, kv_len=lens, q_offset=9,
                                    block_q=8, block_k=8)
    mask = torch.arange(40)[None, :] < lens[:, None]
    ref = tattn.mha_reference(q, k, v, causal=True, kv_mask=mask, q_offset=9)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FP32)


# ---------------------------------------------------------------------------
# exact attention (the ViT)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 577, 4, 4, 16), (2, 7, 4, 2, 8), (1, 13, 2, 2, 64)])
def test_exact_attention_matches_jax(rng, b, s, h, hkv, d):
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    ref = jattn.exact_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.exact_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), _np(ref), **FP32)


def test_exact_dispatch_strided_views_and_bounds(rng):
    """attention(impl='exact') on strided q/k/v views of a fused qkv (the
    ViT's layout) equals mha_reference; both Sq and Sk are checked."""
    qkv = _t(rng.standard_normal((1, 9, 3, 4, 8)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = tattn.attention(q, k, v, impl="exact")
    np.testing.assert_allclose(out.numpy(), tattn.mha_reference(q, k, v).numpy(), **FP32)
    big = torch.zeros(1, 4097, 1, 8)
    small = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="exceed"):
        tattn.exact_attention(big, small, small)
    with pytest.raises(ValueError, match="exceed"):
        tattn.exact_attention(small, big, big)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False), (True, True)])
def test_mha_reference_and_bf16_dispatch_match_jax(rng, causal, masked):
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    mask = np.array([[True] * 6, [True] * 4 + [False] * 2]) if masked else None
    for impl in ("auto", "bf16"):
        ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              kv_mask=None if mask is None else jnp.asarray(mask), impl=impl)
        out = tattn.attention(_t(q), _t(k), _t(v), causal=causal,
                              kv_mask=None if mask is None else _t(mask), impl=impl)
        np.testing.assert_allclose(out.numpy(), _np(ref), **FP32)


def test_decode_attention_matches_jax(rng):
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    ln = np.array([5, 32], np.int32)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ln))
    out = tattn.decode_attention(_t(q), _t(kc), _t(vc), _t(ln))
    np.testing.assert_allclose(out.numpy(), _np(ref), **FP32)


# ---------------------------------------------------------------------------
# int4 gate matvec and its quantizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,din,dout", [(1, 256, 64), (8, 64, 24), (3, 30, 10)])
def test_int4_quantize_bytes_and_matvec_match_jax(rng, b, din, dout):
    w = (rng.standard_normal((dout, din)) * 0.05).astype(np.float32)
    x = rng.standard_normal((b, din)).astype(np.float32)
    jq = jquant.quantize_linear_weight_int4_pc(jnp.asarray(w))
    tq = tquant.quantize_linear_weight_int4_pc(_t(w))
    np.testing.assert_array_equal(tq["w_int4pc"].numpy(), _np(jq["w_int4pc"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), _np(jq["scale"]))
    np.testing.assert_array_equal(
        tquant.dequantize_linear_weight_int4_pc(tq).numpy(),
        _np(jquant.dequantize_linear_weight_int4_pc(jq)))
    ref = j_int4_matvec(jnp.asarray(x), jq["w_int4pc"], jq["scale"])
    out = int4_matvec(_t(x), tq["w_int4pc"], tq["scale"])
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-4)


def test_quantize_gate_params_stacked_bytes_match_jax(rng):
    from streammind_tpu.config import tiny_text_config
    from streammind_tpu.models.mistral import init_text_params
    from streammind_torch.utils.from_jax import params_from_numpy

    tree = init_text_params(jax.random.PRNGKey(3), tiny_text_config(vocab_size=2))
    jq = jquant.quantize_gate_params(tree, bits=4)
    tq = tquant.quantize_gate_params(params_from_numpy(jax.tree.map(np.asarray, tree), "cpu"),
                                     bits=4)
    for name in ("q", "k", "v", "o"):
        np.testing.assert_array_equal(tq["layers"][name]["w_int4pc"].numpy(),
                                      _np(jq["layers"][name]["w_int4pc"]))
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(tq["layers"]["mlp"][name]["w_int4pc"].numpy(),
                                      _np(jq["layers"]["mlp"][name]["w_int4pc"]))


# ---------------------------------------------------------------------------
# norms, rotary, scan steps, sampling filters
# ---------------------------------------------------------------------------
def test_norms_and_rope_match_jax(rng):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    bias = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(tnorms.rms_norm(_t(x), _t(w)).numpy(),
                               _np(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w))), **FP32)
    np.testing.assert_allclose(
        tnorms.layer_norm(_t(x), _t(w), _t(bias)).numpy(),
        _np(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))), **FP32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    qh = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    jc, js = jrot.rope_cos_sin(jnp.asarray(pos), 16)
    tc, ts = trot.rope_cos_sin(_t(pos), 16)
    np.testing.assert_allclose(
        trot.apply_rope(_t(qh), tc, ts).numpy(),
        _np(jrot.apply_rope(jnp.asarray(qh), jc, js)), **FP32)


def test_scan_ops_match_jax(rng):
    bsz, d, n, L, w = 2, 12, 4, 7, 4
    u = rng.standard_normal((bsz, d, L)).astype(np.float32)
    dt = rng.standard_normal((bsz, d, L)).astype(np.float32)
    A = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    B = rng.standard_normal((bsz, n, L)).astype(np.float32)
    C = rng.standard_normal((bsz, n, L)).astype(np.float32)
    D = rng.standard_normal((d,)).astype(np.float32)
    z = rng.standard_normal((bsz, d, L)).astype(np.float32)
    db = rng.standard_normal((d,)).astype(np.float32)
    h0 = rng.standard_normal((bsz, d, n)).astype(np.float32)
    jy, jh = jscan.selective_scan_ref(*(jnp.asarray(a) for a in (u, dt, A, B, C)),
                                      D=jnp.asarray(D), z=jnp.asarray(z),
                                      delta_bias=jnp.asarray(db), delta_softplus=True,
                                      return_last_state=True, h0=jnp.asarray(h0))
    ty, th = tscan.selective_scan_ref(*(_t(a) for a in (u, dt, A, B, C)), D=_t(D), z=_t(z),
                                      delta_bias=_t(db), delta_softplus=True,
                                      return_last_state=True, h0=_t(h0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=1e-5, atol=1e-5)

    jy1, jh1 = jscan.selective_state_update(
        jnp.asarray(h0), jnp.asarray(u[:, :, 0]), jnp.asarray(dt[:, :, 0]), jnp.asarray(A),
        jnp.asarray(B[:, :, 0]), jnp.asarray(C[:, :, 0]), D=jnp.asarray(D),
        z=jnp.asarray(z[:, :, 0]), dt_bias=jnp.asarray(db), dt_softplus=True)
    ty1, th1 = tscan.selective_state_update(
        _t(h0), _t(u[:, :, 0]), _t(dt[:, :, 0]), _t(A), _t(B[:, :, 0]), _t(C[:, :, 0]),
        D=_t(D), z=_t(z[:, :, 0]), dt_bias=_t(db), dt_softplus=True)
    np.testing.assert_allclose(ty1.numpy(), _np(jy1), **FP32)
    np.testing.assert_allclose(th1.numpy(), _np(jh1), **FP32)

    cw = rng.standard_normal((d, w)).astype(np.float32)
    cb = rng.standard_normal((d,)).astype(np.float32)
    cs = rng.standard_normal((bsz, d, w)).astype(np.float32)
    np.testing.assert_allclose(
        tscan.causal_conv1d(_t(u), _t(cw), _t(cb)).numpy(),
        _np(jscan.causal_conv1d(jnp.asarray(u), jnp.asarray(cw), jnp.asarray(cb))), **FP32)
    jyc, jsc = jscan.causal_conv1d_update(jnp.asarray(u[:, :, 0]), jnp.asarray(cs),
                                          jnp.asarray(cw), jnp.asarray(cb))
    tyc, tsc = tscan.causal_conv1d_update(_t(u[:, :, 0]), _t(cs), _t(cw), _t(cb))
    np.testing.assert_allclose(tyc.numpy(), _np(jyc), **FP32)
    np.testing.assert_array_equal(tsc.numpy(), _np(jsc))


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.7, 5, 0.0), (1.3, 0, 0.8),
                                                     (0.5, 3, 0.6), (1.0, 0, 0.0)])
def test_filtered_logits_match_jax(rng, temperature, top_k, top_p):
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    ref = jfilt.filtered_logits(jnp.asarray(logits), temperature, top_k, top_p)
    out = tfilt.filtered_logits(_t(logits), temperature, top_k, top_p)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    assert tfilt.sample_token(None, _t(logits[0]), 0.0, top_k, top_p) == int(np.argmax(logits[0]))
