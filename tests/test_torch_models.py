"""streammind_torch models against the JAX package's, on the CPU.

One tiny StreamMind tree is made by the JAX package's own init and carried
over with ``params_from_numpy``; both packages then get the same numpy
inputs.  fp32 throughout; FP32 tolerances absorb sums taken in another
order (a few ulps per op, compounded over a handful of layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models import mamba as jmamba
from streammind_tpu.models import mistral as jlm
from streammind_tpu.models import projector as jproj
from streammind_tpu.models import vit as jvit
from streammind_tpu.models.meta import init_streammind_params as j_init
from streammind_tpu.utils.quantize import quantize_gate_params as j_quantize_gate
from streammind_torch import config as tconfig
from streammind_torch.models import mamba as tmamba
from streammind_torch.models import mistral as tlm
from streammind_torch.models import projector as tproj
from streammind_torch.models import vit as tvit
from streammind_torch.models.meta import init_streammind_params as t_init
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_torch.utils.quantize import quantize_gate_params as t_quantize_gate

FP32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def trees():
    jcfg = tiny_streammind_config()
    tcfg = tconfig.tiny_streammind_config()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return sum((_paths(v, f"{prefix}{k}.") for k, v in tree.items()), [])
    if isinstance(tree, (list, tuple)):
        return sum((_paths(v, f"{prefix}{i}.") for i, v in enumerate(tree)), [])
    return [(prefix[:-1], tuple(tree.shape))]


def test_init_tree_has_the_jax_layout(trees):
    """Own init: the same leaf names and shapes as the JAX package's tree."""
    _, tcfg, jp, _ = trees
    mine = t_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert sorted(_paths(mine)) == sorted(_paths(jax.tree.map(np.asarray, jp)))


def test_params_from_numpy_keeps_bf16_bits_and_fp32_leaves(trees):
    _, _, jp, _ = trees
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp["text"])
    tp = params_from_numpy(bf, "cpu")
    w = tp["layers"]["q"]["weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(), np.asarray(bf["layers"]["q"]["weight"], np.float32))
    mp = params_from_numpy(jax.tree.map(np.asarray, jp["projector"]), "cpu", dtype=torch.bfloat16)
    assert mp["mamba"]["blocks"][0]["A_log"].dtype == torch.float32
    assert mp["mamba"]["blocks"][0]["in_proj"]["weight"].dtype == torch.bfloat16


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("impl", ["auto", "exact"])
def test_vit_forward_matches_jax(trees, rng, fused, impl):
    jcfg, tcfg, jp, tp = trees
    px = rng.standard_normal((2, 3, jcfg.vision.image_size, jcfg.vision.image_size)).astype(np.float32)
    jv, tv = jp["vision"], tp["vision"]
    if fused:
        jv, tv = jvit.fuse_vit_qkv(jv), tvit.fuse_vit_qkv(tv)
    ref = jvit.vit_forward(jv, jcfg.vision, jnp.asarray(px), attn_impl=impl)
    out = tvit.vit_forward(tv, tcfg.vision, _t(px), attn_impl=impl)
    assert out.shape == (2, jcfg.vision.num_patches, jcfg.vision.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)


def test_mamba_steps_equal_the_jax_scan(trees, rng):
    """The port's step applied T times, and its full forward, both equal the
    JAX package's full-sequence forward (outputs and final state)."""
    jcfg, tcfg, jp, tp = trees
    T = 5
    x = rng.standard_normal((1, T, jcfg.mamba.d_model)).astype(np.float32)
    ref, jstate = jmamba.video_mamba_forward(jp["projector"]["mamba"], jcfg.mamba, jnp.asarray(x))
    state = tmamba.init_mamba_state(tcfg.mamba, 1, device="cpu")
    outs = []
    for t in range(T):
        y, state = tmamba.video_mamba_step(tp["projector"]["mamba"], tcfg.mamba, _t(x[:, t]), state)
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), np.asarray(ref), **FP32)
    np.testing.assert_allclose(state.ssm.numpy(), np.asarray(jstate.ssm), **FP32)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv), **FP32)
    full, fstate = tmamba.video_mamba_forward(tp["projector"]["mamba"], tcfg.mamba, _t(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **FP32)
    np.testing.assert_allclose(fstate.ssm.numpy(), np.asarray(jstate.ssm), **FP32)


@pytest.mark.parametrize("int4_gate", [False, True])
def test_projector_step_and_gate_match_jax(trees, rng, int4_gate):
    jcfg, tcfg, jp, tp = trees
    feats = rng.standard_normal((1, jcfg.vision.num_patches, jcfg.mm_hidden_size)).astype(np.float32)
    jpp, tpp = dict(jp["projector"]), dict(tp["projector"])
    if int4_gate:
        jpp["cls_net"] = j_quantize_gate(jpp["cls_net"], bits=4)
        tpp["cls_net"] = t_quantize_gate(tpp["cls_net"], bits=4)
    jstate = jmamba.init_mamba_state(jcfg.mamba, 1)
    tstate = tmamba.init_mamba_state(tcfg.mamba, 1, device="cpu")
    for _ in range(3):
        jtok, jstate = jproj.mamba_project_step(jpp, jcfg, jnp.asarray(feats), jstate)
        ttok, tstate = tproj.mamba_project_step(tpp, tcfg, _t(feats), tstate)
        feats = feats * 0.5 + 0.1
    np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), **FP32)
    jg = jproj.gate_decision_step(jpp, jcfg, jtok)
    tg = tproj.gate_decision_step(tpp, tcfg, ttok)
    assert tg.shape == (1, 2)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_text_forward_with_and_without_cache_matches_jax(trees, rng, fused):
    jcfg, tcfg, jp, tp = trees
    jt, tt = jp["text"], tp["text"]
    if fused:
        jt, tt = jlm.fuse_text_linears(jt), tlm.fuse_text_linears(tt)
        assert "qkv" in tt["layers"] and "gateup" in tt["layers"]["mlp"]
    ids = rng.integers(3, jcfg.text.vocab_size, (1, 11)).astype(np.int32)
    ref, _ = jlm.text_forward(jt, jcfg.text, input_ids=jnp.asarray(ids))
    out, _ = tlm.text_forward(tt, tcfg.text, input_ids=_t(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    # cached: a right-padded 16-token prefill (real length 11), then one token
    pad = np.zeros((1, 16), np.int32)
    pad[0, :11] = ids
    jc = jlm.init_kv_cache(jcfg.text, 1, 64, jnp.float32)
    tc = tlm.init_kv_cache(tcfg.text, 1, 64, torch.float32, device="cpu")
    adv = np.array([11], np.int32)
    jlog, jc = jlm.text_forward(jt, jcfg.text, input_ids=jnp.asarray(pad), cache=jc,
                                cache_advance=jnp.asarray(adv))
    tlog, tc = tlm.text_forward(tt, tcfg.text, input_ids=_t(pad).long(), cache=tc,
                                cache_advance=_t(adv))
    np.testing.assert_allclose(tlog[:, :11].numpy(), np.asarray(jlog[:, :11]), rtol=1e-4, atol=1e-4)
    nxt = np.array([[7]], np.int32)
    jlog, jc = jlm.text_forward(jt, jcfg.text, input_ids=jnp.asarray(nxt), cache=jc)
    tlog, tc = tlm.text_forward(tt, tcfg.text, input_ids=_t(nxt).long(), cache=tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    assert int(tc.length[0]) == int(jc.length[0]) == 12
    np.testing.assert_allclose(tc.k[:, :, :12].numpy(), np.asarray(jc.k[:, :, :12]), **FP32)
    np.testing.assert_allclose(tc.v[:, :, :12].numpy(), np.asarray(jc.v[:, :, :12]), **FP32)
