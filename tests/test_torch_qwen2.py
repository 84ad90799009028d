"""The port's Qwen2 decoder (q/k/v biases) against the JAX package's, on the CPU.

A Qwen2 state dict from ``transformers`` converted bitwise as JAX converts
it; the init's and the cache's shapes; ``model_init`` picking the "qwen"
template and ``infer`` giving JAX's tokens (fp32, one carried-over tree);
the int8 gate and the int8 decoder keeping the biases (bytes equal to
JAX's); the fused qkv with its bias bitwise the separate q, k, v; a paged
MultiStreamServer at a GQA group of 7 (7 query heads over one kv head)
against JAX's; and the Mamba-width refusal, which the JAX package reaches
only as a shape error.

fp32 throughout.  Tolerances: the decoder's logits 2e-5 (the same sums in
another order); conversions, quantized bytes and the fused projection
exact; tokens identical.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streammind_tpu.api as japi
from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.models import mistral as tlm
from streammind_torch.streaming import StreamMindEngine as TEngine
from streammind_torch.streaming.multistream import MultiStreamServer as TServer
from streammind_torch.utils import convert as tconv
from streammind_torch.utils.from_jax import array_to_tensor, params_from_numpy
from streammind_torch.utils.quantize import quantize_gate_params as t_quantize_gate
from streammind_torch.utils.quantize import quantize_text_params as t_quantize
from streammind_tpu.config import TextConfig, tiny_streammind_config
from streammind_tpu.models import mistral as jlm
from streammind_tpu.models.meta import init_streammind_params as j_init
from streammind_tpu.streaming import StreamMindEngine as JEngine
from streammind_tpu.streaming.multistream import MultiStreamServer as JServer
from streammind_tpu.utils import convert as jconv
from streammind_tpu.utils.quantize import quantize_gate_params as j_quantize_gate
from streammind_tpu.utils.quantize import quantize_text_params as j_quantize

FP32 = dict(rtol=2e-5, atol=2e-5)
QWEN = dict(qkv_bias=True, rope_theta=1_000_000.0)


def _qwen(cfg, **kw):
    """A StreamMind config over a tiny Qwen2 decoder (its Mamba at the
    decoder's width, as the Qwen2-7B model needs)."""
    return cfg.replace(text=dataclasses.replace(cfg.text, **QWEN, **kw))


def _tree(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _equal(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _equal(t[k], j[k], f"{path}.{k}")
        return
    want = array_to_tensor(np.asarray(j))
    assert t.dtype == want.dtype and torch.equal(t, want), path


@pytest.fixture(scope="module")
def trees():
    jcfg = _qwen(tiny_streammind_config())
    tcfg = _qwen(tconfig.tiny_streammind_config())
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    # the init's biases are zeros: draw them, so every test reads them
    rng = np.random.default_rng(0)
    for n in "qkv":
        b = jp["text"]["layers"][n]["bias"]
        jp["text"]["layers"][n]["bias"] = jnp.asarray(
            0.5 * rng.standard_normal(b.shape).astype(np.float32))
    return jcfg, tcfg, jp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convert_hf_text_with_biases_bitwise(dtype):
    """transformers' Qwen2ForCausalLM state dict (q/k/v biases, untied
    embeddings) through both converters: the same bits."""
    transformers = pytest.importorskip("transformers")
    conf = transformers.Qwen2Config(vocab_size=96, hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, tie_word_embeddings=False)
    torch.manual_seed(0)
    sd = {k: v.detach().clone() for k, v in
          transformers.Qwen2ForCausalLM(conf).state_dict().items()}
    raw = dict(model_type="qwen2", vocab_size=96, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    tcfg = tconfig.text_config_from_hf(raw)
    assert tcfg.qkv_bias
    j = jconv.convert_hf_text({k: v.numpy() for k, v in sd.items()},
                              TextConfig(**dataclasses.asdict(tcfg)),
                              {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    t = tconv.convert_hf_text(sd, tcfg, dtype)
    assert "bias" in t["layers"]["k"] and "bias" not in t["layers"]["o"]
    _equal(t, jax.tree.map(lambda a: np.asarray(a), j))


def test_init_and_cache_shapes():
    """init_text_params and init_kv_cache of the Qwen2-7B config: JAX's
    shapes (read from its abstract init), the biases on q/k/v alone."""
    cfg = tconfig.qwen2_7b()
    mine = tlm.init_text_params(None, cfg, device="meta", dtype=torch.bfloat16)
    want = jax.eval_shape(lambda k: jlm.init_text_params(k, TextConfig(**dataclasses.asdict(cfg)),
                                                         jnp.bfloat16), jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got[path] = tuple(t.shape)

    walk(mine)
    assert {tuple(k.key for k in p): tuple(v.shape) for p, v in flat.items()} == got
    assert got[("layers", "q", "bias")] == (28, 3584) and ("layers", "o", "bias") not in got
    cache = tlm.init_kv_cache(cfg, 2, 64, device="meta")
    jcache = jax.eval_shape(lambda: jlm.init_kv_cache(TextConfig(**dataclasses.asdict(cfg)), 2, 64))
    assert tuple(cache.k.shape) == jcache.k.shape == (28, 2, 64, 4, 128)


def test_model_init_picks_qwen_and_infer_matches_jax(trees, rng):
    """model_init by a Qwen2 model name: version "qwen", the biases in the
    engine's tree, and infer's greedy tokens through the ChatML template
    equal to JAX's."""
    jcfg, tcfg, jp = trees
    tok = SPLikeTokenizer()
    jm, _, _, jv = japi.model_init(model_name="StreamMind-Qwen2-tiny", cfg=jcfg, params=jp,
                                   tokenizer=tok, dtype=jnp.float32)
    tm, _, _, tv = tapi.model_init(model_name="StreamMind-Qwen2-tiny", cfg=tcfg,
                                   params=_tree(jp), tokenizer=tok, dtype=torch.float32,
                                   device="cpu")
    assert tv == jv == "qwen"
    layers = tm.params["text"]["layers"]
    assert "bias" in (layers["qkv"] if "qkv" in layers else layers["q"])
    s = jcfg.vision.image_size
    video = rng.standard_normal((3, 3, s, s)).astype(np.float32)
    want = japi.infer(jm, video, "What is happening?", tok, version="qwen", max_new_tokens=6)
    assert tapi.infer(tm, video, "What is happening?", tok, version="qwen",
                      max_new_tokens=6) == want


def test_quantize_gate_and_int8_decoder_keep_biases(trees):
    """The int8 decoder (load_8bit) and the int8 and int4 gates over a tree
    with q/k/v biases: the same bytes, scales and biases as JAX's; the int8
    decoder's logits equal to JAX's."""
    jcfg, tcfg, jp = trees
    tp = _tree(jp)
    jq, tq = j_quantize(jp["text"], bits=8), t_quantize(tp["text"], bits=8)
    _equal(tq["layers"], jax.tree.map(np.asarray, jq["layers"]))
    assert torch.equal(tq["layers"]["q"]["bias"], tp["text"]["layers"]["q"]["bias"])
    gate_j = dict(jp["projector"]["cls_net"])
    gate_j["layers"] = dict(gate_j["layers"], q=dict(jp["text"]["layers"]["q"]))
    gate_j["layers"]["q"] = {"weight": gate_j["layers"]["q"]["weight"][:2],
                             "bias": gate_j["layers"]["q"]["bias"][:2]}
    gate_t = _tree(gate_j)
    for bits in (8, 4):
        got = t_quantize_gate(gate_t, bits=bits)["layers"]["q"]
        _equal(got, jax.tree.map(np.asarray, j_quantize_gate(gate_j, bits=bits)["layers"]["q"]))
        assert "bias" in got
    ids = np.array([[1, 7, 23, 5]], np.int32)
    tl, _ = tlm.text_forward(tq, tcfg.text, input_ids=torch.from_numpy(ids).long())
    jl, _ = jlm.text_forward(jq, jcfg.text, input_ids=jnp.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)


@pytest.mark.parametrize("bits", [None, 8])
def test_fused_qkv_with_bias_is_the_separate_projection(trees, bits):
    """fuse_text_linears concatenates the biases with the weights: the fused
    q, k, v bitwise the separate ones (plain and int8 leaves)."""
    _, tcfg, jp = trees
    text = _tree(jp)["text"]
    if bits:
        text = t_quantize(text, bits=bits)
    fused = tlm.fuse_text_linears(text)
    assert "bias" in fused["layers"]["qkv"] and "q" not in fused["layers"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, tcfg.text.hidden_size)).astype(np.float32))
    lp = {k: v for k, v in text["layers"].items() if k in "qkv"}
    lp = {k: {n: t[0] for n, t in v.items()} for k, v in lp.items()}
    lf = {"qkv": {n: t[0] for n, t in fused["layers"]["qkv"].items()}}
    for a, b in zip(tlm.qkv_proj(x, lp, tcfg.text), tlm.qkv_proj(x, lf, tcfg.text)):
        assert torch.equal(a, b)


class _Tok:
    bos_token_id = 1
    eos_token_id = 2
    eos_token = "</s>"

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([self.bos_token_id] + [3 + (ord(c) % 200) for c in text][:20])

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_paged_server_at_gqa_group_seven_matches_jax():
    """A Qwen2-shaped decoder with 7 query heads over one kv head (Qwen2-7B's
    group of 7): a paged MultiStreamServer, three streams firing together
    then one alone, utterances equal to JAX's."""
    jcfg = _qwen(tiny_streammind_config(), num_heads=7, num_kv_heads=1, head_dim=16)
    tcfg = _qwen(tconfig.tiny_streammind_config(), num_heads=7, num_kv_heads=1, head_dim=16)
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    kw = dict(eos_token_id=2, prefill_buckets=(32, 64))
    engines = (JEngine(jp, jcfg, **kw), TEngine(_tree(jp), tcfg, device="cpu", **kw))
    rng = np.random.default_rng(3)
    s = jcfg.vision.image_size
    frames = [{sid: rng.standard_normal((1, 3, s, s)).astype(np.float32) for sid in "abc"}
              for _ in range(2)]
    schedule = ({"a", "b", "c"}, {"b"})
    logs = []
    for eng, conv in zip(engines, (jnp.asarray, torch.from_numpy)):
        srv = (JServer if eng is engines[0] else TServer)(eng, capacity=4, kv_mode="paged",
                                                          num_pages=32, page_size=8)
        for sid in "abc":
            srv.add_stream(sid, _Tok(), max_new_tokens=4)
        log = []
        for t, f in enumerate(frames):
            for slot in srv.slots:
                if slot is not None:
                    slot.gate_threshold = -1.0 if slot.stream_id in schedule[t] else 2.0
            log.append(srv.step({k: conv(v) for k, v in f.items()}))
        logs.append(log)
    assert logs[1] == logs[0]
    assert [sorted(k for k, v in o.items() if v is not None) for o in logs[1]] == [
        ["a", "b", "c"], ["b"]]


def test_mamba_width_mismatch_is_refused(tmp_path):
    """An HF Qwen2 config.json gives the decoder's width to the text and the
    gate but leaves the Mamba at 4096 (in both packages: the configs are
    equal).  The port refuses it before building anything; the JAX package
    builds it and fails on a shape in the projector."""
    raw = {"model_type": "qwen2", "hidden_size": 64, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_hidden_layers": 2, "intermediate_size": 128,
           "vocab_size": 256}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    cfg = tapi._load_config(str(tmp_path))
    assert cfg.to_json() == japi._load_config(str(tmp_path)).to_json()
    assert (cfg.mamba.d_model, cfg.text.hidden_size, cfg.text.qkv_bias) == (4096, 64, True)
    with pytest.raises(ValueError, match="d_model 4096 differs from the decoder's hidden_size 64"):
        tapi.model_init(str(tmp_path), tokenizer=SPLikeTokenizer(), device="cpu")
    # the same mismatch at tiny widths: the port refuses to build it, the JAX
    # package builds it and fails on the first frame's projection
    base = tiny_streammind_config()
    jcfg = base.replace(text=dataclasses.replace(base.text, hidden_size=48, head_dim=12, **QWEN))
    tcfg = tconfig.StreamMindConfig.from_json(jcfg.to_json())
    with pytest.raises(ValueError, match="d_model 64 differs"):
        tapi.model_init(cfg=tcfg, tokenizer=SPLikeTokenizer(), dtype=torch.float32, device="cpu")
    jm, _, _, _ = japi.model_init(cfg=jcfg, tokenizer=SPLikeTokenizer(), dtype=jnp.float32)
    video = np.zeros((2, 3, base.vision.image_size, base.vision.image_size), np.float32)
    with pytest.raises((TypeError, ValueError)):
        japi.infer(jm, video, "What is happening?", SPLikeTokenizer(), max_new_tokens=2)
