"""The selective scan, the chunked projection and the burst catch-up against
the JAX package's, on the CPU.

The port's ``selective_scan`` (``impl="ref"``, and ``impl="pallas"``, whose
wrapper takes the plain version for CPU tensors) is held to the JAX
package's Pallas scan run interpreted and to its lax.scan reference, with
and without a carried state, fp32 within 1e-5 (sums in another order).
The CUDA kernel sums y over a channel's states in its own order (a group
of lanes, each with a run of states, then a butterfly of the lanes'
sums); a plain emulation of that order is held to both references, at the
burst's shape and at small ones, within the card's limit (chip_smoke.py's
``SCAN_TOL``), which fixes that limit before any card run.
Then ``mamba_project_chunk`` continuing a carried state, and
``StreamMindEngine.perceive_burst``: against the JAX package's burst, and
against the port's own T single steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models import mamba as jmamba
from streammind_tpu.models import projector as jproj
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.ops import scan as jscan
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import init_stream_state as j_init_state
from streammind_tpu.utils import quantize as jquant
from streammind_torch import config as tconfig
from streammind_torch.models import mamba as tmamba
from streammind_torch.models import projector as tproj
from streammind_torch.ops import scan as tscan
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.utils.from_jax import params_from_numpy

FP32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(rng, b, d, length, n):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(u=r(b, d, length), delta=r(b, d, length), A=-np.exp(r(d, n)), B=r(b, n, length),
                C=r(b, n, length), D=r(d), z=r(b, d, length), delta_bias=r(d), h0=r(b, d, n))


@pytest.mark.parametrize("length", [1, 12, 70])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_z", [False, True])
def test_selective_scan_matches_jax(rng, length, with_h0, with_z):
    x = _scan_inputs(rng, 2, 24, length, 16)
    if not with_h0:
        x["h0"] = None
    if not with_z:
        x["z"] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in x.items()}
    t = {k: None if v is None else _t(v) for k, v in x.items()}
    pos = ("u", "delta", "A", "B", "C")
    kw = dict(delta_softplus=True, return_last_state=True)
    jkw = {k: j[k] for k in ("D", "z", "delta_bias", "h0")}
    tkw = {k: t[k] for k in ("D", "z", "delta_bias", "h0")}
    y_pl, h_pl = jscan.selective_scan_pallas(*(j[k] for k in pos), block_d=8, **jkw, **kw)
    y_ref, h_ref = jscan.selective_scan_ref(*(j[k] for k in pos), **jkw, **kw)
    for impl in ("ref", "pallas", "auto"):
        y, h = tscan.selective_scan(*(t[k] for k in pos), **tkw, **kw, impl=impl)
        assert y.shape == (2, 24, length) and h.shape == (2, 24, 16) and h.dtype == torch.float32
        for ry, rh in ((y_pl, h_pl), (y_ref, h_ref)):
            np.testing.assert_allclose(y.numpy(), np.asarray(ry), **FP32)
            np.testing.assert_allclose(h.numpy(), np.asarray(rh), **FP32)
    y_only = tscan.selective_scan(*(t[k] for k in pos), **tkw, delta_softplus=True, impl="pallas")
    np.testing.assert_allclose(y_only.numpy(), np.asarray(y_ref), **FP32)


# chip_smoke.py's SCAN_TOL (fp32 y) and SCAN_STATE_TOL
SCAN_TOL_FP32 = dict(atol=1e-5, rtol=1e-5)


def _kernel_order_scan(x, group):
    """The CUDA kernel's arithmetic (csrc/selective_scan.cu) in numpy fp32:
    softplus(dt + bias) as max(x, 0) + log1p(e^-|x|), exp(dt * A), the state
    update as a product then a sum, and y's sum over the N states in the
    kernel's order.  Lane g of a channel's group of ``group`` lanes owns
    states [g*s, g*s + s), s = ceil(N / group), and sums h*C over them by fma
    in state order from 0 (emulated in float64: the exact product, the sum
    rounded to fp64 and then to fp32); the lanes' sums meet by the butterfly
    p += p[lane ^ o], o = group/2, ..., 1, whose bits the kernel's
    reduce-scatter gives (fp32 adds commute).  Then + D*u and * z / (1 +
    e^-z).  Returns y (fp32) and the last state."""
    f32, f64 = np.float32, np.float64
    u, A, B, C = x["u"], x["A"], x["B"], x["C"]
    dt = x["delta"] + x["delta_bias"][None, :, None]
    dt = np.maximum(dt, f32(0)) + np.log1p(np.exp(-np.abs(dt)))
    bsz, d, length = u.shape
    n = A.shape[1]
    s = -(-n // group)
    lanes = np.arange(group)
    h = x["h0"].copy() if x["h0"] is not None else np.zeros((bsz, d, n), f32)
    ys = []
    for t in range(length):
        dA = np.exp(dt[:, :, t, None] * A[None])
        h = h * dA + (dt[:, :, t] * u[:, :, t])[:, :, None] * B[:, None, :, t]
        p = np.zeros((bsz, d, group), f32)
        for k in range(s):
            own = lanes[lanes * s + k < n]
            idx = own * s + k
            p[..., own] = (h[..., idx].astype(f64) * C[:, None, idx, t].astype(f64)
                           + p[..., own].astype(f64)).astype(f32)
        o = group // 2
        while o:
            p = p + p[..., lanes ^ o]
            o //= 2
        ys.append(p[..., 0])
    y = np.stack(ys, axis=2) + u * x["D"][None, :, None]
    z = x["z"]
    return y * (z / (f32(1) + np.exp(-z))), h


@functools.lru_cache(maxsize=None)
def _scan_refs(b, d, length, n):
    """Inputs from a seed, and y and the last state from the port's
    selective_scan_ref and JAX's interpreted Pallas scan."""
    x = _scan_inputs(np.random.default_rng(21), b, d, length, n)
    x["delta"] = x["delta"] * np.float32(0.5)
    pos = ("u", "delta", "A", "B", "C")
    kw = dict(delta_softplus=True, return_last_state=True)
    tkw = {k: _t(x[k]) for k in ("D", "z", "delta_bias", "h0")}
    y_ref, h_ref = tscan.selective_scan_ref(*(_t(x[k]) for k in pos), **tkw, **kw)
    jkw = {k: jnp.asarray(x[k]) for k in ("D", "z", "delta_bias", "h0")}
    y_pl, h_pl = jscan.selective_scan_pallas(*(jnp.asarray(x[k]) for k in pos), **jkw, **kw)
    return x, ((y_ref.numpy(), h_ref.numpy()), (np.asarray(y_pl), np.asarray(h_pl)))


KERNEL_LANES = 8  # lanes sharing a channel's states in csrc/selective_scan.cu


@pytest.mark.parametrize("b,d,length,n", [
    (1, 8192, 32, 16),   # the burst: d_inner 8192, d_state 16, 32 frames
    (1, 8192, 1, 16),    # one step
    (2, 24, 12, 16),
    (2, 10, 5, 3),       # states that leave lanes of a group empty
    (1, 6, 33, 1),
    (2, 7, 9, 2),
    (3, 8, 70, 8),       # one state a lane
    (1, 5, 31, 12),      # two states on six lanes, none on the last two
    (2, 9, 64, 15),      # the last lane one state short
    (1, 12, 100, 16),    # over three chunks of 32 steps
])
def test_kernel_summation_order_matches_the_references(b, d, length, n):
    x, refs = _scan_refs(b, d, length, n)
    y, h = _kernel_order_scan(x, KERNEL_LANES)
    assert y.dtype == np.float32 and y.shape == (b, d, length)
    for ry, rh in refs:
        np.testing.assert_allclose(y, ry, **SCAN_TOL_FP32)
        np.testing.assert_allclose(h, rh, **SCAN_TOL_FP32)


def test_selective_scan_dispatch_and_grad(rng):
    """impl="pallas" has no backward (as the Pallas kernel has none) and
    refuses inputs that require grad; "auto" is differentiable; under
    no_grad the pallas path takes such inputs."""
    x = {k: _t(v) for k, v in _scan_inputs(rng, 1, 8, 5, 4).items()}
    pos = [x[k] for k in ("u", "delta", "A", "B", "C")]
    u = pos[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tscan.selective_scan(u, *pos[1:], impl="pallas")
    tscan.selective_scan(u, *pos[1:], impl="auto").sum().backward()
    assert u.grad is not None and torch.isfinite(u.grad).all()
    with torch.no_grad():
        tscan.selective_scan(u, *pos[1:], impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tscan.selective_scan(*pos, impl="assoc")


@pytest.fixture(scope="module")
def trees():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_mamba_project_chunk_continues_a_state_like_jax(trees, rng):
    """Three single steps, then a chunk of five frames from the carried
    state, in both packages: tokens and the final conv and SSM states."""
    cfg, jp, tp = trees
    tcfg = tconfig.tiny_streammind_config()
    feats = rng.standard_normal((1, 8, 6, cfg.mm_hidden_size)).astype(np.float32)
    js, ts = jmamba.init_mamba_state(cfg.mamba, 1), tmamba.init_mamba_state(tcfg.mamba, 1, "cpu")
    for i in range(3):
        _, js = jproj.mamba_project_step(jp["projector"], cfg, jnp.asarray(feats[:, i]), js)
        _, ts = tproj.mamba_project_step(tp["projector"], tcfg, _t(feats[:, i]), ts)
    jtok, js = jproj.mamba_project_chunk(jp["projector"], cfg, jnp.asarray(feats[:, 3:]), js)
    for impl in ("auto", "pallas"):
        ttok, ts2 = tproj.mamba_project_chunk(tp["projector"], tcfg, _t(feats[:, 3:]), ts,
                                              impl=impl)
        assert ttok.shape == (1, 5, cfg.text.hidden_size)
        np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), **FP32)
        np.testing.assert_allclose(ts2.ssm.numpy(), np.asarray(js.ssm), **FP32)
        np.testing.assert_allclose(ts2.conv.numpy(), np.asarray(js.conv), **FP32)
    full, _ = tproj.mamba_project(tp["projector"], tcfg, _t(feats), impl="pallas")
    ref, _ = jproj.mamba_project(jp["projector"], cfg, jnp.asarray(feats))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **FP32)
    np.testing.assert_allclose(tproj.spatial_pool(_t(feats)).numpy(),
                               np.asarray(jproj.spatial_pool(jnp.asarray(feats))), **FP32)


def _frames(cfg, n, seed):
    s = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal((n, 3, s, s)).astype(np.float32)


@pytest.mark.parametrize("tier", ["plain", "fast"])
def test_perceive_burst_matches_jax(trees, tier):
    """Two single frames, then a burst of five, in both packages: the last
    frame's gate probs (1e-5), the ring and the SSM state.  The fast tier
    (int8 gate and ViT) rounds activations to int8, so its ring may see one
    int8 step of one activation (see test_torch_quant.RING_INT8)."""
    cfg, jp, tp = trees
    kw = dict(quantize_gate="int8", fast_vision="int8") if tier == "fast" else {}
    jeng = JEngine(jp, cfg, **kw)
    teng = TEngine(tp, tconfig.tiny_streammind_config(), device="cpu", **kw)
    frames = _frames(cfg, 7, 4)
    js, ts = j_init_state(cfg), teng.new_stream_state()
    for f in frames[:2]:
        _, js = jeng.perceive_step(jnp.asarray(f[None]), js)
        _, ts = teng.perceive_step(torch.from_numpy(f[None]), ts)
    jprob, js = jeng.perceive_burst(jnp.asarray(frames[2:]), js)
    tprob, ts = teng.perceive_burst(torch.from_numpy(frames[2:]), ts)
    assert ts.frame_idx == int(js.frame_idx) == 7
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), **FP32)
    ring = dict(rtol=2e-5, atol=2e-4) if tier == "fast" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ts.memory.numpy(), np.asarray(js.memory), **ring)
    np.testing.assert_allclose(ts.mamba.ssm.numpy(), np.asarray(js.mamba.ssm), **ring)


@pytest.mark.parametrize("start", [0, 13])
def test_burst_equals_single_steps(trees, start):
    """The port's burst of five == its five perceive_steps from the same
    state: probs, every ring row, the SSM and conv states, the frame count.
    Starting at frame 13 of a 16-slot ring, the last three frames clamp to
    slot 15 and the last one wins it, as in the steps."""
    cfg, _, tp = trees
    teng = TEngine(tp, tconfig.tiny_streammind_config(), quantize_gate="int8", device="cpu")
    frames = _frames(cfg, 5, 5)
    base = teng.new_stream_state()
    base.memory.normal_(generator=torch.Generator().manual_seed(6))
    base = base._replace(frame_idx=start)
    a = base._replace(memory=base.memory.clone())
    for f in frames:
        pa, a = teng.perceive_step(torch.from_numpy(f[None]), a)
    b = base._replace(memory=base.memory.clone())
    pb, b = teng.perceive_burst(torch.from_numpy(frames), b)
    assert a.frame_idx == b.frame_idx == start + 5
    np.testing.assert_allclose(pb.numpy(), pa.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.memory.numpy(), a.memory.numpy(), **FP32)
    np.testing.assert_allclose(b.mamba.ssm.numpy(), a.mamba.ssm.numpy(), **FP32)
    np.testing.assert_allclose(b.mamba.conv.numpy(), a.mamba.conv.numpy(), **FP32)
