"""The port's training attention against the JAX package's, on the CPU.

``flash_mha`` — the lse forward and the dQ and dK/dV backward — and the
paths that reach it (``attention(impl="flash"/"flash!")``, a rematerialized
``text_forward``) get the same numpy inputs as their JAX counterparts,
whose Pallas kernels run in interpret mode with blocks of 8 as
``tests/test_attention.py`` runs them; the port's plain versions take the
same blocks.  fp32 throughout.  Tolerances: 1e-5 for attention outputs,
lse and their gradients (the same sums in another order, measured ~1e-6);
1e-4 for gradients through a two-layer decoder (a few more ops compounded).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_text_config
from streammind_tpu.models import mistral as jlm
from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.ops import attention as tattn
from streammind_torch.utils.from_jax import params_from_numpy

jattn = importlib.import_module("streammind_tpu.ops.attention")

ATTN = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _qkv(rng, b, sq, h, hkv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sq, h, d)).astype(np.float32))


@pytest.mark.parametrize(
    "b,sq,h,hkv,d,kv_len,causal",
    [
        (2, 21, 4, 2, 16, [17, 0], True),    # ragged incl. 0, odd Sq, GQA 2
        (2, 24, 4, 2, 16, [17, 24], False),  # non-causal, right-padded
        (1, 19, 8, 2, 16, [19], True),       # GQA 4
        (1, 13, 4, 4, 8, None, True),        # MHA, no kv_len, odd Sq
    ],
)
def test_flash_mha_out_lse_and_grads_match_jax(rng, b, sq, h, hkv, d, kv_len, causal):
    q, k, v, w = _qkv(rng, b, sq, h, hkv, d)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)

    jout, jlse = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, kv_len=jl, block_q=8, block_k=8,
                                       return_lse=True)
    tout, tlse = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=tl,
                                       block_q=8, block_k=8, return_lse=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **ATTN)
    assert np.isfinite(tlse.numpy()).all()

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_mha(q, k, v, jl, causal, 8, 8) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.flash_mha(tq, tk, tv, tl, causal, 8, 8)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **ATTN)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN)
    if kv_len is not None and 0 in kv_len:  # no visible key: zero output and gradients
        i = kv_len.index(0)
        assert float(out.detach()[i].abs().max()) == 0.0 and float(tq.grad[i].abs().max()) == 0.0


def test_flash_mha_inference_path_and_q_offset(rng):
    """Without a gradient wanted, flash_mha is the inference forward (no lse),
    as the JAX primal is; the backward takes q_offset == 0 only."""
    q, k, v, _ = _qkv(rng, 1, 9, 4, 2, 8)
    with torch.no_grad():
        out = tattn.flash_mha(_t(q, True), _t(k), _t(v), None, True, 8, 8)
    np.testing.assert_array_equal(
        out.numpy(), tattn.flash_attention(_t(q), _t(k), _t(v), causal=True, block_q=8,
                                           block_k=8).numpy())
    with pytest.raises(NotImplementedError, match="q_offset"):
        tattn.flash_mha(_t(q, True), _t(k), _t(v), None, True, q_offset=3)


@pytest.mark.parametrize("impl", ["flash", "flash!"])
def test_attention_flash_dispatch_gradients_match_jax(rng, impl):
    """attention(impl=...) with a kv_mask: the mask becomes kv_len and the call
    is differentiable, as in the JAX dispatcher."""
    q, k, v, w = _qkv(rng, 2, 16, 4, 2, 8)
    mask = np.arange(16)[None, :] < np.array([16, 11])[:, None]

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, causal=True, kv_mask=jnp.asarray(mask),
                                       impl="flash") * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tattn.attention(tq, tk, tv, causal=True, kv_mask=_t(mask), impl=impl) * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN)


@pytest.mark.parametrize("remat", [True, False])
def test_text_forward_flash_grads_wrt_embeds_match_jax(rng, monkeypatch, remat):
    """The decoder's no-cache branch reaches flash_mha in every layer (again in
    the recompute under remat), and the gradient with respect to
    inputs_embeds equals the JAX package's remat + flash gradient."""
    jcfg = tiny_text_config()
    tcfg = tconfig.tiny_text_config()
    jp = jlm.init_text_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    s = 12
    emb = rng.standard_normal((2, s, jcfg.hidden_size)).astype(np.float32)
    mask = np.arange(s)[None, :] < np.array([s, 9])[:, None]
    w = rng.standard_normal((2, s, jcfg.vocab_size)).astype(np.float32)

    def jloss(e):
        logits, _ = jlm.text_forward(jp, jcfg, inputs_embeds=e, attn_mask=jnp.asarray(mask),
                                     attn_impl="flash", remat=True)
        return jnp.sum(logits * w)

    jval, jg = jax.value_and_grad(jloss)(jnp.asarray(emb))

    calls = []
    real = tattn.flash_mha

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_mha", counting)
    te = _t(emb, True)
    logits, _ = tlm.text_forward(tp, tcfg, inputs_embeds=te, attn_mask=_t(mask),
                                 attn_impl="flash", remat=remat)
    loss = (logits * _t(w)).sum()
    loss.backward()
    assert len(calls) == tcfg.num_layers * (2 if remat else 1)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)
