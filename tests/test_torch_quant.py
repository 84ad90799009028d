"""The port's quantization tiers against the JAX package's, on the CPU.

Quantizers (int8, int4 in groups, and their tree transforms) must give the
JAX package's bytes and scales exactly.  ``linear`` over int8 and int4
leaves, the int8 matvec's plain version, the int8 ViT and a two-turn
fast-tier session (int8 gate, int8 ViT, int8 decoder) are held to the JAX
package's with the tolerances stated beside each.  Inputs come from numpy
seeds; the JAX package's Pallas kernels run interpreted, as its own tests
run them on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammind_tpu.config import tiny_streammind_config, tiny_text_config
from streammind_tpu.models import mistral as jlm
from streammind_tpu.models import vit as jvit
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.ops.int8_matvec import int8_matvec as j_int8_matvec
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming import StreamSession as JSession
from streammind_tpu.streaming import init_stream_state as j_init_state
from streammind_tpu.utils import params as jparams
from streammind_tpu.utils import quantize as jquant
from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.models import vit as tvit
from streammind_torch.ops.int8_matvec import int8_matvec, int8_matvec_ref
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming import StreamSession as TSession
from streammind_torch.utils import params as tparams
from streammind_torch.utils import quantize as tquant
from streammind_torch.utils.from_jax import params_from_numpy

from test_torch_session import PROMPT, FakeTokenizer


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return sum((_leaves(v, f"{prefix}{k}.") for k, v in sorted(tree.items())), [])
    if isinstance(tree, (list, tuple)):
        return sum((_leaves(v, f"{prefix}{i}.") for i, v in enumerate(tree)), [])
    return [(prefix[:-1], tree)]


def _assert_trees_equal(port, ref):
    """Same leaf names, dtypes, shapes and values, bit for bit."""
    a, b = _leaves(port), _leaves(jax.tree.map(np.asarray, ref))
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, t), (_, r) in zip(a, b):
        got = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        want = np.asarray(r, np.float32) if r.dtype.name == "bfloat16" else r
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# quantizers: bytes and scales equal to the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(24, 128), (3, 40, 192), (16, 100), (2, 8, 33)])
def test_int8_and_int4_group_bytes_match_jax(rng, shape):
    """Single and layer-stacked weights; 100 inputs are no multiple of the
    int4 group (one group a row), 33 are odd (int4 keeps the weight)."""
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, :] = 0.0  # an all-zero row takes the 1e-8 scale floor
    j8, t8 = jquant.quantize_linear_weight(jnp.asarray(w)), tquant.quantize_linear_weight(_t(w))
    _assert_trees_equal(t8, j8)
    np.testing.assert_array_equal(tquant.dequantize_linear_weight(t8).numpy(),
                                  np.asarray(jquant.dequantize_linear_weight(j8)))
    j4 = jquant.quantize_linear_weight_int4(jnp.asarray(w))
    t4 = tquant.quantize_linear_weight_int4(_t(w))
    _assert_trees_equal(t4, j4)
    if "w_int4" in t4:
        np.testing.assert_array_equal(tquant.dequantize_linear_weight_int4(t4).numpy(),
                                      np.asarray(jquant.dequantize_linear_weight_int4(j4)))


@pytest.fixture(scope="module")
def tree():
    cfg = tiny_streammind_config()
    return cfg, init_streammind_params(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("which,bits,scheme", [
    ("text", 8, "group"), ("text", 4, "group"), ("text", 4, "pc"),
    ("vision", 8, None), ("gate", 8, None),
])
def test_quantize_trees_match_jax(tree, which, bits, scheme):
    _, jp = tree
    src = {"text": jp["text"], "vision": jp["vision"], "gate": jp["projector"]["cls_net"]}[which]
    tsrc = params_from_numpy(jax.tree.map(np.asarray, src), "cpu", dtype=torch.bfloat16)
    jsrc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), src)
    if which == "text":
        ref = jquant.quantize_text_params(jsrc, bits=bits, scheme=scheme)
        out = tquant.quantize_text_params(tsrc, bits=bits, scheme=scheme, free_source=True)
        # free_source pops each quantized source weight out of the input tree
        assert "weight" not in tsrc["layers"]["q"] and "weight" not in tsrc["layers"]["mlp"]["up"]
        # the serving fusion concatenates quantized leaves as the JAX package's
        _assert_trees_equal(tlm.fuse_text_linears(out), jlm.fuse_text_linears(ref))
    elif which == "vision":
        ref, out = jquant.quantize_vit_params(jsrc), tquant.quantize_vit_params(tsrc)
    else:
        ref = jquant.quantize_gate_params(jsrc, bits=8)
        out = tquant.quantize_gate_params(tsrc, bits=8)
    _assert_trees_equal(out, ref)


def test_params_from_numpy_keeps_quantization_scales_fp32(tree):
    """A quantized tree carried over with dtype=bf16: the int8 and int4
    bytes and every scale (per channel and per group) keep their dtype."""
    _, jp = tree
    for bits in (8, 4):
        q = jquant.quantize_text_params(jp["text"], bits=bits)
        t = params_from_numpy(jax.tree.map(np.asarray, q), "cpu", dtype=torch.bfloat16)
        layer = t["layers"]["q"]
        assert layer.get("scale", layer.get("scale4")).dtype == torch.float32
        assert layer.get("w_int8", layer.get("w_int4")).dtype == torch.int8
        assert t["embed_tokens"].dtype == torch.bfloat16


def test_quantize_rejects_what_the_jax_package_rejects():
    w = {"layers": {n: {"weight": torch.zeros(2, 4, 8)} for n in "qkvo"}}
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_text_params(w, bits=3)
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_gate_params(w, bits=2)
    # expert banks, once refused here, quantize as the JAX package's do
    rng = np.random.default_rng(3)
    experts = {n: rng.standard_normal((2, 3, 8, 8)).astype(np.float32) for n in
               ("gate", "up", "down")}
    qkvo = {n: {"weight": np.zeros((2, 4, 8), np.float32)} for n in "qkvo"}
    for bits, scheme in ((8, "group"), (4, "group"), (4, "pc")):
        tree = {"layers": {**qkvo, "experts": experts}}
        want = jquant.quantize_text_params(jax.tree.map(jnp.asarray, tree), bits=bits,
                                           scheme=scheme)["layers"]["experts"]
        got = tquant.quantize_text_params(params_from_numpy(tree, "cpu"), bits=bits,
                                          scheme=scheme)["layers"]["experts"]
        for n in experts:
            assert set(got[n]) == set(want[n])
            for k in want[n]:
                assert torch.equal(got[n][k], torch.from_numpy(np.array(want[n][k]))), (n, k)


@pytest.mark.parametrize("bits,scheme", [(8, "group"), (4, "group"), (4, "pc")])
def test_synth_quantized_text_params_match_jax(bits, scheme):
    cfg = tiny_text_config()
    ref = jquant.synth_quantized_text_params(cfg, bits=bits, scheme=scheme)
    out = tquant.synth_quantized_text_params(tconfig.tiny_text_config(), bits=bits,
                                             scheme=scheme, device="cpu")
    _assert_trees_equal(out, ref)


# ---------------------------------------------------------------------------
# linear over quantized leaves, the int8 matvec's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("lead", [(1,), (2, 6), (1, 12)])
def test_linear_over_quantized_leaves_matches_jax(rng, scheme, lead):
    """fp32 on the CPU: the int8 leaf takes the JAX package's formula (a
    product, then the scale), the int4 leaf the dequantized matmul; 1e-6
    covers sums taken in another order."""
    w = (rng.standard_normal((48, 128)) * 0.05).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((*lead, 128)).astype(np.float32)
    quant = {"int8": "quantize_linear_weight", "int4": "quantize_linear_weight_int4"}[scheme]
    jp = dict(getattr(jquant, quant)(jnp.asarray(w)), bias=jnp.asarray(b))
    tp = dict(getattr(tquant, quant)(_t(w)), bias=_t(b))
    ref = jparams.linear(jnp.asarray(x), jp)
    out = tparams.linear(_t(x), tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,din,dout", [(1, 256, 64), (8, 128, 24), (3, 384, 16)])
def test_int8_matvec_plain_version_matches_the_jax_kernel(rng, b, din, dout):
    """Against the Pallas kernel run interpreted.  bf16 x: both sum exact
    products in fp32, so only the order of the sums and so the one final
    bf16 rounding can differ (one bf16 step, 2**-8 relative).  The wrapper
    on a CPU tensor is the plain version."""
    w = (rng.standard_normal((dout, din)) * 0.05).astype(np.float32)
    q = jquant.quantize_linear_weight(jnp.asarray(w))
    x = rng.standard_normal((b, din)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = j_int8_matvec(xb, q["w_int8"], q["scale"])
    tq = tquant.quantize_linear_weight(_t(w))
    tx = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = int8_matvec_ref(tx, tq["w_int8"], tq["scale"])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -8, atol=1e-6)
    assert torch.equal(int8_matvec(tx, tq["w_int8"], tq["scale"]), out)
    # fp32 x: the JAX kernel rounds x to bf16 before its dot (the port's
    # kernel keeps fp32), so the two differ by x's bf16 rounding, 2**-9 of
    # each term; the limit is a bf16 step of the largest output
    ref32 = np.asarray(j_int8_matvec(jnp.asarray(x), q["w_int8"], q["scale"]))
    out32 = int8_matvec_ref(_t(x), tq["w_int8"], tq["scale"])
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), ref32, rtol=0,
                               atol=2 ** -8 * float(np.abs(ref32).max()))


# ---------------------------------------------------------------------------
# the int8 ViT
# ---------------------------------------------------------------------------
def test_int8_vit_linear_and_forward_match_jax(tree, rng):
    """fp32: the int8 product is exact in both packages, so the difference
    is the fp32 rescale and the layers around it (1e-5)."""
    cfg, jp = tree
    jv = jquant.quantize_vit_params(jp["vision"])
    tv = tquant.quantize_vit_params(params_from_numpy(jax.tree.map(np.asarray, jp["vision"]),
                                                      "cpu"))
    x = rng.standard_normal((2, 7, cfg.vision.hidden_size)).astype(np.float32)
    leaf = jax.tree.map(lambda a: a[0], jv["layers"]["fc1"])
    tleaf = {k: v[0] for k, v in tv["layers"]["fc1"].items()}
    np.testing.assert_allclose(tvit._linear_q(_t(x), tleaf).numpy(),
                               np.asarray(jvit._linear_q(jnp.asarray(x), leaf)),
                               rtol=1e-5, atol=1e-5)
    px = rng.standard_normal((2, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(
        np.float32)
    jv, tv = jvit.fuse_vit_qkv(jv), tvit.fuse_vit_qkv(tv)
    assert set(tv["layers"]["qkv"]) == {"w_int8", "scale", "bias"}
    for impl in ("auto", "bf16"):
        ref = jvit.vit_forward(jv, cfg.vision, jnp.asarray(px), attn_impl=impl)
        out = tvit.vit_forward(tv, tconfig.tiny_streammind_config().vision, _t(px),
                               attn_impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine's tiers and a fast-tier session
# ---------------------------------------------------------------------------
def test_engine_tier_values(tree):
    _, jp = tree
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg = tconfig.tiny_streammind_config()
    for value, key in ((True, "w_int8"), ("int8", "w_int8"), ("int4", "w_int4pc"),
                       (False, "weight"), (None, "weight")):
        eng = TEngine(tp, cfg, quantize_gate=value, device="cpu")
        assert key in eng.params["projector"]["cls_net"]["layers"]["v"], value
    eng = TEngine(tp, cfg, fast_vision="int8", device="cpu")
    assert "w_int8" in eng.params["vision"]["layers"]["qkv"] and eng.attn_impl == "bf16"
    assert TEngine(tp, cfg, fast_vision=True, attn_impl="exact", device="cpu").attn_impl == "exact"
    with pytest.raises(ValueError, match="quantize_gate"):
        TEngine(tp, cfg, quantize_gate="int2", device="cpu")
    with pytest.raises(ValueError, match="fast_vision"):
        TEngine(tp, cfg, fast_vision="fp8", device="cpu")
    # a quantized text tree of any scheme is fused
    for bits, scheme in ((8, "group"), (4, "group"), (4, "pc")):
        q = dict(tp, text=tquant.quantize_text_params(tp["text"], bits=bits, scheme=scheme))
        assert "qkv" in TEngine(q, cfg, device="cpu").params["text"]["layers"]


FAST = dict(eos_token_id=2, prefill_buckets=(32, 64), quantize_gate="int8", fast_vision="int8")


@pytest.fixture(scope="module")
def fast_engines(tree):
    cfg, jp = tree
    jp = dict(jp, text=jquant.quantize_text_params(jp["text"], bits=8))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, JEngine(jp, cfg, **FAST), TEngine(tp, tconfig.tiny_streammind_config(),
                                                  device="cpu", **FAST)


# The int8 ViT rounds its activations to int8: where an fp32 sum differs in
# its last bit between the packages (another order), an activation can land
# one int8 step away, which moves that frame's memory token by up to ~1e-4
# (1.0e-4 measured on one frame of seven here).  The ring's limit allows one
# such step; the gate probs and the decisions are held tight.
RING_INT8 = dict(rtol=2e-5, atol=2e-4)


def test_fast_tier_session_matches_jax(fast_engines):
    """int8 gate, int8 ViT and the load_8bit decoder in both packages: the
    same greedy tokens in both turns, gate probs frame by frame (1e-5) and
    the same decisions, the ring within RING_INT8; fp32."""
    cfg, jeng, teng = fast_engines
    assert "w_int8" in teng.params["text"]["layers"]["qkv"]
    frames = np.random.default_rng(1).standard_normal(
        (7, 1, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    fire = (2, 5)
    kw = dict(prompt_ids=list(PROMPT), gate_threshold=2.0, max_new_tokens=6)
    js, ts = JSession(jeng, FakeTokenizer(), **kw), TSession(teng, FakeTokenizer(), **kw)
    jout = [js.process_frame(jnp.asarray(f), force_fire=i in fire) for i, f in enumerate(frames)]
    tout = [ts.process_frame(torch.from_numpy(f), force_fire=i in fire)
            for i, f in enumerate(frames)]
    assert tout == jout and ts.turns == js.turns and len(ts.turns) == 2
    np.testing.assert_allclose(ts.state.memory.numpy(), np.asarray(js.state.memory),
                               **RING_INT8)
    jstate, tstate = j_init_state(cfg), teng.new_stream_state()
    decisions = []
    for f in frames:
        jprob, jstate = jeng.perceive_step(jnp.asarray(f), jstate)
        tprob, tstate = teng.perceive_step(torch.from_numpy(f), tstate)
        np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-5, atol=1e-5)
        decisions.append((bool(tprob[1] > tprob[0]), bool(jprob[1] > jprob[0])))
    assert all(t == j for t, j in decisions)
