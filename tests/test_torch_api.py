"""The port's public API and its decode entry points against the JAX package.

One tiny tree (the JAX package's init, carried over with params_from_numpy)
goes into ``model_init`` of both packages; the same seeded frames and
prompts then go through ``infer`` (greedy, with history, with memory
subsampling), ``x_infer``, ``infer_beams`` and the engine's
``decode_stream`` and ``beam_generate``.  Greedy tokens and texts, and beam
lists, must be identical; beam scores within 1e-5; sampled decoding is
compared through ``filtered_logits`` (the two packages draw from different
RNGs).  fp32 on the CPU, the JAX side as its own tests run it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streammind_torch
import streammind_tpu.api as japi
from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch.streaming.logit_filters import filtered_logits as t_filtered
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.streaming.logit_filters import filtered_logits as j_filtered

QUESTION = "What is happening?"


@pytest.fixture(scope="module")
def models():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = SPLikeTokenizer()
    jm, _, _, jv = japi.model_init(cfg=cfg, params=jp, tokenizer=tok, dtype=jnp.float32)
    tm, _, _, tv = tapi.model_init(cfg=tconfig.tiny_streammind_config(), params=tp,
                                   tokenizer=tok, dtype=torch.float32, device="cpu")
    assert jv == tv == "llama_2"
    return jm, tm, tok


def _video(n=4, seed=0):
    s = tiny_streammind_config().vision.image_size
    return np.random.default_rng(seed).standard_normal((n, 3, s, s)).astype(np.float32)


CASES = {
    "plain": dict(),
    "history": dict(history=[("Who is there?", "A man."), ("And now?", "He runs.")]),
    "log": dict(sample_type="log", sample_per=0.5),
    "similarity": dict(sample_type="similarity", sample_per=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_infer_matches_jax(models, case):
    jm, tm, tok = models
    kw = CASES[case]
    video = _video(6)
    jplan, jbuf = japi._prepare_cognition_inputs(jm, video, QUESTION, tok, "llama_2", **kw)
    tplan, tbuf = tapi._prepare_cognition_inputs(tm, video, QUESTION, tok, "llama_2", **kw)
    for key in ("token_ids", "mem_index", "use_mem", "attn_mask"):
        np.testing.assert_array_equal(getattr(tplan, key), getattr(jplan, key))
    assert tplan.length == jplan.length
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=1e-5, atol=1e-5)

    a = japi.infer(jm, video, QUESTION, tok, max_new_tokens=8, **kw)
    b = tapi.infer(tm, video, QUESTION, tok, max_new_tokens=8, **kw)
    assert b == a and b  # the fake tokenizer spells every id, so equal text is equal ids


def test_unknown_sample_type_raises_in_both(models):
    jm, tm, tok = models
    for api, m in ((japi, jm), (tapi, tm)):
        with pytest.raises(ValueError, match="sample_type"):
            api.infer(m, _video(3), QUESTION, tok, max_new_tokens=2, sample_type="uniform")


@pytest.mark.parametrize("mode", ["mcqa", "openend", "vanilla"])
def test_x_infer_matches_jax(models, mode):
    jm, tm, tok = models
    video = _video(3, seed=1)
    a = japi.x_infer(video, "Which option?", jm, tok, mode=mode)
    b = streammind_torch.x_infer(video, "Which option?", tm, tok, mode=mode)
    assert b == a
    with pytest.raises(ValueError):
        streammind_torch.x_infer(video, "q", tm, tok, mode="bogus")


def test_infer_beams_matches_jax(models):
    jm, tm, tok = models
    video = _video(4, seed=2)
    a = japi.infer_beams(jm, video, "Predict the next actions.", tok, num_beams=4,
                         num_return_sequences=4, max_new_tokens=6)
    b = tapi.infer_beams(tm, video, "Predict the next actions.", tok, num_beams=4,
                         num_return_sequences=4, max_new_tokens=6)
    assert b == a and len(b) == 4


def _prefill(jm, tm, tok, video):
    jplan, jbuf = japi._prepare_cognition_inputs(jm, video, QUESTION, tok, "llama_2")
    tplan, tbuf = tapi._prepare_cognition_inputs(tm, video, QUESTION, tok, "llama_2")
    jeng, teng = jm.engine, tm.engine
    jlast, jcache = jeng.prefill(jplan, jbuf, jeng.new_kv_cache(capacity=256))
    tlast, tcache = teng.prefill(tplan, tbuf, teng.new_kv_cache(capacity=256))
    return (jplan, jbuf, jlast, jcache), (tplan, tbuf, tlast, tcache)


def test_sampled_infer_filtered_logits_match_jax(models):
    jm, tm, tok = models
    (_, _, jlast, _), (_, _, tlast, _) = _prefill(jm, tm, tok, _video(4, seed=3))
    for temp, top_k, top_p in ((0.2, 0, 0.0), (0.8, 5, 0.0), (0.7, 0, 0.9), (1.3, 12, 0.8)):
        a = np.asarray(j_filtered(jlast[0], jnp.float32(temp), jnp.int32(top_k),
                                  jnp.float32(top_p)))
        b = t_filtered(tlast[0], temp, top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isneginf(b), np.isneginf(a))
        keep = ~np.isneginf(a)
        np.testing.assert_allclose(b[keep], a[keep], rtol=1e-5, atol=1e-5)
    out = tapi.infer(tm, _video(4, seed=3), QUESTION, tok, do_sample=True, max_new_tokens=6,
                     seed=1, top_k=5, top_p=0.9)
    again = tapi.infer(tm, _video(4, seed=3), QUESTION, tok, do_sample=True, max_new_tokens=6,
                       seed=1, top_k=5, top_p=0.9)
    assert isinstance(out, str) and out == again  # one seed, one draw


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_decode_stream_equals_generate_from_prefill(models, temperature):
    jm, tm, tok = models
    teng = tm.engine
    _, (tplan, tbuf, _, _) = _prefill(jm, tm, tok, _video(4, seed=4))
    outs = []
    for use_stream in (False, True):
        last, cache = teng.prefill(tplan, tbuf, teng.new_kv_cache(capacity=256))
        gen = torch.Generator().manual_seed(7)
        if use_stream:
            outs.append(list(teng.decode_stream(last, cache, max_new_tokens=12,
                                                temperature=temperature, top_k=20,
                                                generator=gen)))
        else:
            outs.append(teng.generate_from_prefill(last, cache, max_new_tokens=12,
                                                   temperature=temperature, top_k=20,
                                                   generator=gen)[0])
    assert outs[1] == outs[0] and len(outs[0]) > 0


def test_decode_stream_matches_jax(models):
    jm, tm, tok = models
    (_, _, jlast, jcache), (_, _, tlast, tcache) = _prefill(jm, tm, tok, _video(4, seed=5))
    a = list(jm.engine.decode_stream(jlast, jcache, max_new_tokens=10))
    b = list(tm.engine.decode_stream(tlast, tcache, max_new_tokens=10))
    assert b == a


def test_beam_generate_one_beam_is_greedy(models):
    jm, tm, tok = models
    teng = tm.engine
    _, (tplan, tbuf, tlast, tcache) = _prefill(jm, tm, tok, _video(4, seed=6))
    greedy, _ = teng.generate_from_prefill(tlast, tcache, max_new_tokens=9)
    beams = teng.beam_generate(tplan, tbuf, num_beams=1, max_new_tokens=9)
    assert len(beams) == 1 and beams[0][0] == greedy


@pytest.mark.parametrize("length_penalty", [1.0, 0.5])
def test_beam_generate_matches_jax(models, length_penalty):
    jm, tm, tok = models
    (jplan, jbuf, _, _), (tplan, tbuf, _, _) = _prefill(jm, tm, tok, _video(4, seed=7))
    kw = dict(num_beams=4, max_new_tokens=7, num_return_sequences=4,
              length_penalty=length_penalty)
    a = jm.engine.beam_generate(jplan, jbuf, **kw)
    b = tm.engine.beam_generate(tplan, tbuf, **kw)
    assert [s for s, _ in b] == [s for s, _ in a] and len(b) == 4
    np.testing.assert_allclose([float(x) for _, x in b], [float(x) for _, x in a],
                               rtol=0, atol=1e-5)
    assert [x for _, x in b] == sorted((x for _, x in b), reverse=True)


@pytest.mark.parametrize("name,version", [
    ("StreamMind-7B", "llama_2"), ("vicuna-7b-v1.5", "v1"), ("StreamMind-Qwen2-tiny", "qwen"),
])
def test_model_init_version_from_name(name, version):
    cfg = tconfig.tiny_streammind_config()
    _, processor, tok, v = tapi.model_init(model_name=name, cfg=cfg, tokenizer=SPLikeTokenizer(),
                                           dtype=torch.float32, device="cpu")
    assert v == version and tok is not None
    frames = (np.random.default_rng(0).random((5, 20, 30, 3)) * 255).astype(np.uint8)
    assert processor(frames).shape == (5, 3, cfg.vision.image_size, cfg.vision.image_size)


def test_model_init_random_tree_layout():
    """The bundle holds the engine's tree: the decoder's q/k/v and gate/up
    fused (a tiny tree is under the fusing limit), the ViT's q/k/v fused,
    the gate LM unfused."""
    model, _, _, _ = tapi.model_init(cfg=tconfig.tiny_streammind_config(),
                                     tokenizer=SPLikeTokenizer(), dtype=torch.float32,
                                     device="cpu")
    text = model.params["text"]["layers"]
    assert {"qkv", "o"} <= set(text) and "q" not in text and "gateup" in text["mlp"]
    assert "qkv" in model.params["vision"]["layers"]
    assert "q" in model.params["projector"]["cls_net"]["layers"]
    assert set(model.params) == {"vision", "projector", "text"}


def test_one_shot_infer_rightsizes_cache(models, monkeypatch):
    jm, tm, tok = models
    eng = tm.engine
    assert eng.cache_capacity_for(128, 64) == 256
    assert eng.cache_capacity_for(1024, 128) == 2048
    assert eng.cache_capacity_for(8000, 500) == eng.kv_capacity  # saturates
    seen = []
    real = eng.new_kv_cache

    def spy(dtype=None, capacity=None):
        seen.append(capacity)
        return real(dtype=dtype, capacity=capacity)

    monkeypatch.setattr(eng, "new_kv_cache", spy)
    out = tapi.infer(tm, _video(2), "what", tok, max_new_tokens=4)
    assert seen == [256] and isinstance(out, str)
    assert out == japi.infer(jm, _video(2), "what", tok, max_new_tokens=4)


@pytest.mark.parametrize("flag", [dict(load_8bit=True), dict(load_4bit=True),
                                  dict(load_4bit="pc")])
def test_model_init_quantized_decoder_matches_jax(flag):
    """load_8bit / load_4bit (group) / load_4bit="pc": the port's layout after
    quantize_text_params and fuse_text_linears, and greedy infer equal to
    the JAX package's on the same quantized tree."""
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = SPLikeTokenizer()
    jm, _, _, _ = japi.model_init(cfg=cfg, params=jp, tokenizer=tok, dtype=jnp.float32, **flag)
    tm, _, _, _ = tapi.model_init(cfg=tconfig.tiny_streammind_config(), params=tp, tokenizer=tok,
                                  dtype=torch.float32, device="cpu", **flag)
    leaf = {"load_8bit": "w_int8", True: "w_int4", "pc": "w_int4pc"}[
        "load_8bit" if "load_8bit" in flag else flag["load_4bit"]]
    layers = tm.params["text"]["layers"]
    assert leaf in layers["qkv"] and leaf in layers["mlp"]["gateup"] and leaf in layers["o"]
    video = _video(3, seed=8)
    assert tapi.infer(tm, video, QUESTION, tok, max_new_tokens=6) == japi.infer(
        jm, video, QUESTION, tok, max_new_tokens=6)


def test_new_session_runs_a_turn(models):
    _, tm, tok = models
    session = tm.new_session(tok, max_new_tokens=3, gate_threshold=2.0)
    frame = torch.from_numpy(_video(1))
    assert session.process_frame(frame) is None
    assert isinstance(session.process_frame(frame, force_fire=True), str)


def test_model_init_refuses_qwen_and_mixtral():
    """Qwen2 (q/k/v biases) and Mixtral (experts) configs, once refused here,
    now build: model_init on one carried-over tree each, and greedy infer
    equal to the JAX package's (their int8 decoders: tests/test_torch_moe.py
    and tests/test_torch_qwen2.py).  What is still refused: a Mamba width
    other than the decoder's (ValueError, before anything is built)."""
    jbase, tbase = tiny_streammind_config(), tconfig.tiny_streammind_config()
    tok = SPLikeTokenizer()
    video = _video(3, seed=11)
    for change in (dict(qkv_bias=True), dict(num_experts=4)):
        jcfg = jbase.replace(text=dataclasses.replace(jbase.text, **change))
        tcfg = tbase.replace(text=dataclasses.replace(tbase.text, **change))
        jp = init_streammind_params(jax.random.PRNGKey(3), jcfg)
        jm, _, _, _ = japi.model_init(cfg=jcfg, params=jp, tokenizer=tok, dtype=jnp.float32)
        tm, _, _, _ = tapi.model_init(cfg=tcfg, params=params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"), tokenizer=tok, dtype=torch.float32,
            device="cpu")
        assert tapi.infer(tm, video, QUESTION, tok, max_new_tokens=5) == japi.infer(
            jm, video, QUESTION, tok, max_new_tokens=5)
    wide = tbase.replace(text=dataclasses.replace(tbase.text, hidden_size=48, head_dim=12))
    with pytest.raises(ValueError, match="d_model"):
        tapi.model_init(cfg=wide, tokenizer=tok, dtype=torch.float32, device="cpu")


def test_one_beam_is_greedy_where_logits_tie(models, monkeypatch):
    """bf16 logits tie often; candidates that tie are taken lowest index
    first, greedy's argmax rule, so one beam is greedy decoding."""
    from streammind_torch.models import mistral

    _, tm, _ = models
    eng = tm.engine
    V = tm.cfg.text.vocab_size
    plan, mem_buf = tapi._prepare_cognition_inputs(tm, _video(2), QUESTION, SPLikeTokenizer(),
                                                   "llama_2")
    tied = torch.zeros((1, V))
    tied[0, [7, 40, 200]] = 3.0  # a three-way tie at the top, every step

    def prefill(plan, memory, cache):
        return tied.clone(), cache

    def text_forward(params, cfg, input_ids=None, cache=None, **kw):
        b = input_ids.shape[0]
        return tied.expand(b, V).clone()[:, None, :], cache._replace(length=cache.length + 1)

    monkeypatch.setattr(eng, "prefill", prefill)
    monkeypatch.setattr(mistral, "text_forward", text_forward)
    (tokens, _), = eng.beam_generate(plan, mem_buf, num_beams=1, max_new_tokens=5)
    last, cache = prefill(plan, mem_buf, eng.new_kv_cache(capacity=256))
    assert tokens == eng.generate_from_prefill(last, cache, 5)[0] == [7] * 5


def _scores(kind, rng):
    if kind == "ties":  # bf16-like scores: few distinct values, many ties
        return np.round(rng.standard_normal(5 * 311), 1).astype(np.float32)
    if kind == "finished":  # the frozen rows of finished beams: -inf but one entry
        v = rng.standard_normal((5, 311)).astype(np.float32)
        v[[1, 3]] = -np.inf
        v[1, 2], v[3, 2] = v.max(), -1.0
        return v.ravel()
    if kind == "all_tied":
        return np.zeros(64, np.float32)
    if kind == "nan":
        v = rng.standard_normal(64).astype(np.float32)
        v[[3, 9]] = np.nan
        return v
    return rng.standard_normal(7).astype(np.float32)  # "short": n past the size


@pytest.mark.parametrize("kind", ["ties", "finished", "all_tied", "nan", "short"])
def test_top_stable_equals_the_full_stable_sort(kind):
    """The beam step's top 2K by partition: the same indices in the same
    order as the stable sort of every candidate, ties lowest index first."""
    from streammind_torch.streaming.engine import top_stable

    rng = np.random.default_rng(0)
    for _ in range(20):
        v = _scores(kind, rng)
        for n in (1, 2, 10):
            assert top_stable(v, n).tolist() == np.argsort(-v, kind="stable")[:n].tolist()
