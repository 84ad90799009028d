"""The port's SSD scan and Mamba-2 block against the JAX package's, on the CPU.

The five cases of ``tests/test_ssd.py`` (the chunked scan against the step
by step recurrence at chunks 8, 16 and 32; a scan continued from a carried
state; the one-token update streamed over the sequence; ``mamba2_step``
against ``mamba2_forward``; a forward continued from its returned state),
each also against the JAX package's function on the same numpy inputs and,
for the block, on one carried-over tree.  A bf16 carry of a Mamba-2 tree
keeps dt_bias, A_log and D in fp32.

fp32.  Tolerances: the port against JAX 1e-5 + 1e-5·|ref| (the same sums
in another order; measured ~1e-6); the port against itself as
``tests/test_ssd.py`` holds JAX (2e-4 for the scan, 5e-4 for the block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_torch.models import mamba2 as tm2
from streammind_torch.ops import ssd as tssd
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu.models import mamba2 as jm2
from streammind_tpu.ops import ssd as jssd

B, L, H, P, G, N = 2, 32, 4, 8, 2, 16
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=5e-4, atol=5e-4)


def make_inputs(rng):
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, L, H))) * 0.5 + 0.01).astype(np.float32)
    A = -(np.abs(rng.standard_normal((H,))) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    C = rng.standard_normal((B, L, G, N)).astype(np.float32)
    D = rng.standard_normal((H,)).astype(np.float32)
    return x, dt, A, Bm, C, D


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(t, j, tol=JAX_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference_and_jax(rng, chunk):
    arrs = make_inputs(rng)
    x, dt, A, Bm, C, D = _t(arrs)
    y_ref, s_ref = tssd.ssd_reference(x, dt, A, Bm, C, D=D, return_last_state=True)
    jx, jdt, jA, jB, jC, jD = _j(arrs)
    jy_ref, js_ref = jssd.ssd_reference(jx, jdt, jA, jB, jC, D=jD, return_last_state=True)
    _close(y_ref, jy_ref)
    _close(s_ref, js_ref)
    y, s = tssd.ssd_chunked(x, dt, A, Bm, C, chunk=chunk, D=D, return_last_state=True)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), s_ref.numpy(), **SCAN_TOL)
    jy, js = jssd.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk, D=jD, return_last_state=True)
    _close(y, jy)
    _close(s, js)


def test_ssd_initial_state_continuation(rng):
    arrs = make_inputs(rng)
    x, dt, A, Bm, C, D = _t(arrs)
    jx, jdt, jA, jB, jC, jD = _j(arrs)
    y_full, s_full = tssd.ssd_reference(x, dt, A, Bm, C, D=D, return_last_state=True)
    k = 16
    y1, s1 = tssd.ssd_chunked(x[:, :k], dt[:, :k], A, Bm[:, :k], C[:, :k], chunk=8, D=D,
                              return_last_state=True)
    y2, s2 = tssd.ssd_chunked(x[:, k:], dt[:, k:], A, Bm[:, k:], C[:, k:], chunk=8, D=D,
                              h0=s1, return_last_state=True)
    np.testing.assert_allclose(y2.numpy(), y_full[:, k:].numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **SCAN_TOL)
    _, js1 = jssd.ssd_chunked(jx[:, :k], jdt[:, :k], jA, jB[:, :k], jC[:, :k], chunk=8, D=jD,
                              return_last_state=True)
    jy2, js2 = jssd.ssd_chunked(jx[:, k:], jdt[:, k:], jA, jB[:, k:], jC[:, k:], chunk=8, D=jD,
                                h0=js1, return_last_state=True)
    _close(y2, jy2)
    _close(s2, js2)


def test_ssd_step_streams_the_scan(rng):
    arrs = make_inputs(rng)
    x, dt, A, Bm, C, D = _t(arrs)
    jx, jdt, jA, jB, jC, jD = _j(arrs)
    y_ref = tssd.ssd_reference(x, dt, A, Bm, C, D=D)
    s, js = torch.zeros((B, H, P, N)), jnp.zeros((B, H, P, N), jnp.float32)
    ys = []
    for t in range(L):
        y_t, s = tssd.ssd_state_update(s, x[:, t], dt[:, t], A, Bm[:, t], C[:, t], D=D)
        jy_t, js = jssd.ssd_state_update(js, jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], D=jD)
        _close(y_t, jy_t)
        ys.append(y_t)
    _close(s, js)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_ref.numpy(), **SCAN_TOL)


def _block(seed, **kw):
    jcfg = jm2.Mamba2Config(**kw)
    jp = jm2.init_mamba2_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tm2.Mamba2Config(**kw), jp, tp


def test_mamba2_step_equals_forward_and_jax(rng):
    jcfg, tcfg, jp, tp = _block(0, d_model=64, d_state=16, headdim=16, ngroups=2, chunk_size=8)
    u = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    y_full, final = tm2.mamba2_forward(tp, tcfg, torch.from_numpy(u), return_state=True)
    jy_full, jfinal = jm2.mamba2_forward(jp, jcfg, jnp.asarray(u), return_state=True)
    _close(y_full, jy_full)
    _close(final.ssm, jfinal.ssm)
    _close(final.conv, jfinal.conv)
    state, jstate = tm2.init_mamba2_state(tcfg, 2, "cpu"), jm2.init_mamba2_state(jcfg, 2)
    ys = []
    for t in range(12):
        y_t, state = tm2.mamba2_step(tp, tcfg, torch.from_numpy(u[:, t]), state)
        jy_t, jstate = jm2.mamba2_step(jp, jcfg, jnp.asarray(u[:, t]), jstate)
        _close(y_t, jy_t)
        ys.append(y_t)
    _close(state.ssm, jstate.ssm)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_full.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(state.ssm.numpy(), final.ssm.numpy(), **BLOCK_TOL)


def test_mamba2_chunked_continuation(rng):
    jcfg, tcfg, jp, tp = _block(1, d_model=64, d_state=16, headdim=16, chunk_size=8)
    u = rng.standard_normal((1, 24, tcfg.d_model)).astype(np.float32)
    tu = torch.from_numpy(u)
    y_full, _ = tm2.mamba2_forward(tp, tcfg, tu, return_state=True)
    y1, st = tm2.mamba2_forward(tp, tcfg, tu[:, :8], return_state=True)
    y2, _ = tm2.mamba2_forward(tp, tcfg, tu[:, 8:], state=st, return_state=True)
    np.testing.assert_allclose(y1.numpy(), y_full[:, :8].numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 8:].numpy(), **BLOCK_TOL)
    _, jst = jm2.mamba2_forward(jp, jcfg, jnp.asarray(u[:, :8]), return_state=True)
    jy2, _ = jm2.mamba2_forward(jp, jcfg, jnp.asarray(u[:, 8:]), state=jst, return_state=True)
    _close(y2, jy2)


def test_bf16_carry_keeps_mamba2_fp32_leaves():
    """params_from_numpy(dtype=bf16) casts the linears and the conv, and
    keeps dt_bias, A_log and D fp32, as the JAX package's init stores them."""
    jcfg = jm2.Mamba2Config(d_model=64, d_state=16, headdim=16)
    jp = jm2.init_mamba2_params(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", dtype=torch.bfloat16)
    for name in ("dt_bias", "A_log", "D"):
        assert jp[name].dtype == jnp.float32 and tp[name].dtype == torch.float32, name
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    assert tp["in_proj"]["weight"].dtype == tp["conv1d"]["weight"].dtype == torch.bfloat16
    # the drawn tree keeps them fp32 as well
    drawn = tm2.init_mamba2_params(torch.Generator().manual_seed(0), tm2.Mamba2Config(
        d_model=64, d_state=16, headdim=16), device="cpu", dtype=torch.bfloat16)
    assert all(drawn[n].dtype == torch.float32 for n in ("dt_bias", "A_log", "D"))
