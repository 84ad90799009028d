"""The port's evaluation (``streammind_torch/eval``) against the JAX package's.

The metric, NLG, MCQA, judge and LTA cases of ``tests/test_eval.py`` and
``tests/test_eval_runners.py`` run on both packages on the same seeded
inputs and must agree bitwise.  Then one tiny tree (the JAX package's init,
carried over) behind both packages' ``model_init`` (fp32, CPU):
``evaluate_gate_stream`` must give identical fire times and summary, the
Ego4D ``llm`` perplexity agree to 1e-5 relative with equal correctness and
captions, the ``cls`` metrics be equal, the LTA beams and ``score_lta``, and
MCQA and OQA answers through ``x_infer``, be the same.  Each runner's
``main`` is held against the JAX package's in ``test_torch_eval_main.py``.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streammind_tpu.api as japi
from sp_like_tokenizer import SPLikeTokenizer
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch import eval as teval
from streammind_torch.data import ego4d as tego
from streammind_torch.eval import gpt_judge as tjudge
from streammind_torch.eval import run_ego4d_lta as tlta
from streammind_torch.eval import run_ego4d_stream as tego_run
from streammind_torch.eval import run_gate_stream as tgate
from streammind_torch.eval import run_mcqa as tmcqa
from streammind_torch.utils.from_jax import params_from_numpy
from streammind_tpu import eval as jeval
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.data import ego4d as jego
from streammind_tpu.eval import gpt_judge as jjudge
from streammind_tpu.eval import run_ego4d_lta as jlta
from streammind_tpu.eval import run_ego4d_stream as jego_run
from streammind_tpu.eval import run_gate_stream as jgate
from streammind_tpu.eval import run_mcqa as jmcqa
from streammind_tpu.models.meta import init_streammind_params

# ---------------------------------------------------------------------------
# metrics, NLG, MCQA helpers, the judge (bitwise)
# ---------------------------------------------------------------------------
CAPTIONS = ["the cat sat on the mat", "a goal was scored", "the quick brown fox",
            "jumps over the lazy dog", "no match here at all", "a cat", ""]


def _corpus(seed):
    rng = random.Random(seed)
    refs, hyps = {}, {}
    for i in range(6):
        refs[i] = [rng.choice(CAPTIONS[:-1]) for _ in range(rng.randint(1, 3))]
        words = rng.choice(CAPTIONS[:-1]).split()
        rng.shuffle(words)
        hyps[i] = [" ".join(words[: rng.randint(1, len(words))])]
    return refs, hyps


@pytest.mark.parametrize("seed", range(4))
def test_nlg_scores_match_jax(seed):
    refs, hyps = _corpus(seed)
    assert teval.bleu(refs, hyps) == jeval.bleu(refs, hyps)
    assert teval.rouge_l(refs, hyps) == jeval.rouge_l(refs, hyps)
    assert teval.cider(refs, hyps) == jeval.cider(refs, hyps)
    assert teval.meteor_lite(refs, hyps) == jeval.meteor_lite(refs, hyps)
    assert teval.calculate_metrics(refs, hyps) == jeval.calculate_metrics(refs, hyps)
    same = {k: [v[0]] for k, v in refs.items()}
    assert float(teval.calculate_metrics(same, same)["BLEU-1"]) == pytest.approx(100.0, abs=0.01)


@pytest.mark.parametrize("seed", range(4))
def test_gate_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    targets = sorted(rng.uniform(0, 120, 6).round(1).tolist())
    preds = sorted(rng.uniform(0, 120, rng.integers(0, 9)).round(1).tolist())
    for tol in (1, 5, 10):
        assert teval.gate_prf(targets, preds, tol) == jeval.gate_prf(targets, preds, tol)
    labels, fired = rng.integers(0, 2, 40), rng.integers(0, 2, 40)
    for n in (0, 2, 5):
        np.testing.assert_array_equal(teval.relaxed_correct(labels, fired, n),
                                      jeval.relaxed_correct(labels, fired, n))
        assert (teval.gate_frame_metrics(labels, fired, n)
                == jeval.gate_frame_metrics(labels, fired, n))
    assert teval.gate_timediff(labels, fired) == jeval.gate_timediff(labels, fired)
    logits = rng.standard_normal((9, 13)).astype(np.float32)
    ids = rng.integers(0, 13, 9)
    assert teval.turn_ppl_correctness(logits, ids) == jeval.turn_ppl_correctness(logits, ids)
    eos_labels = np.where(rng.random(30) < 0.2, 2, rng.integers(3, 9, 30))
    assert teval.split_turns_by_eos(eos_labels) == jeval.split_turns_by_eos(eos_labels)
    assert teval.aggregate([1.0, 2.5]) == jeval.aggregate([1.0, 2.5]) and teval.aggregate([]) == 0


def test_turn_ppl_matches_torch_cross_entropy():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 7)
    ppl, _, n = teval.turn_ppl_correctness(logits, labels)
    want = float(torch.nn.functional.cross_entropy(torch.tensor(logits),
                                                   torch.tensor(labels)).exp())
    assert ppl == pytest.approx(want, rel=1e-5) and n == 7


RESPONSES = ["The best answer is C.", "(B) because ...", "A", "d", "E. something", "",
             "this is a very long rambling response that never commits to anything definite",
             "The correct option isD", "Best answer:Best option: B"]


def test_mcqa_helpers_match_jax(tmp_path):
    for r in RESPONSES:
        for choices in ("ABCD", "ABCDE"):
            assert (teval.extract_choice_letter(r, choices)
                    == jeval.extract_choice_letter(r, choices))
    for n_items in (0, 1, 7, 10):
        for n in (1, 3, 4):
            lst = list(range(n_items))
            assert teval.split_list(lst, n) == jeval.split_list(lst, n)
            for k in range(n + 1):
                assert teval.get_chunk(lst, n, k) == jeval.get_chunk(lst, n, k)
    rows = [{"pred": "A", "gt": "A", "task_type": "x"}, {"pred": "B", "gt": "C", "task_type": "x"},
            {"pred": "C", "gt": "C", "task_type": "y"}, {"pred": "", "gt": "D", "task_type": None}]
    assert teval.mcqa_accuracy(rows) == jeval.mcqa_accuracy(rows) == pytest.approx(50.0)
    path = tmp_path / "ans.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    assert tmcqa.score_answers(str(path)) == jmcqa.score_answers(str(path))
    for bench in ("videomme", "mvbench", "egoschema", "perception"):
        for answer in ("B", "banana", 1, "7", None):
            opts = ["apple", "banana", "cherry", "date"]
            assert (tmcqa.normalize_gt(bench, answer, opts)
                    == jmcqa.normalize_gt(bench, answer, opts))
    q = ["apple", "B. banana", " C. cherry "]
    assert tmcqa.format_mcqa_question("What?", q) == jmcqa.format_mcqa_question("What?", q)


def test_srt_and_subtitle_window_match_jax(tmp_path):
    srt = tmp_path / "vid.srt"
    srt.write_text(
        "1\n00:00:01,000 --> 00:00:03,000\nhello there\n\n"
        "2\n00:00:10,500 --> 00:00:12,000\nsecond line\nwrapped\n\n"
        "3\n00:01:00,000 --> 00:01:02,000\nlate line\n\n", encoding="utf-8")
    subs = tmcqa.parse_srt(str(srt))
    assert subs == jmcqa.parse_srt(str(srt)) and len(subs) == 3
    for dur, n in ((8000, 4), (62000, 62), (1000, 4), (0, 4)):
        assert (tmcqa.subtitles_for_window(subs, dur, n)
                == jmcqa.subtitles_for_window(subs, dur, n))


@pytest.mark.parametrize("dimension", ["generic", "correctness", "detail", "context",
                                       "temporal", "consistency", "msvc_correctness",
                                       "msvc_detailedness"])
def test_judge_messages_match_jax(dimension):
    kw = dict(question2="q2?", pred2="p2") if dimension == "consistency" else {}
    answer = ["r1", "r2"] if dimension.startswith("msvc") else "truth"
    assert (tjudge.build_judge_messages("q?", answer, "guess", dimension, **kw)
            == jjudge.build_judge_messages("q?", answer, "guess", dimension, **kw))
    if dimension == "consistency":
        with pytest.raises(ValueError, match="question2"):
            tjudge.build_judge_messages("q?", answer, "guess", dimension)


def test_judge_pipeline_matches_jax(tmp_path):
    for text in ("{'pred': 'yes', 'score': 4}", "noise {'pred': 'no', 'score': 1} trailing",
                 "{'score': 4}"):
        assert tjudge.parse_judge_response(text) == jjudge.parse_judge_response(text)
    with pytest.raises(ValueError):
        tjudge.parse_judge_response("garbage")
    preds = [{"id": "a", "question": "q", "answer": "x", "pred": "x"},
             {"id": "b", "question": "q", "answer": "y", "pred": "z"}]
    outs, caches = [], []
    for name, mod in (("jax", jjudge), ("port", tjudge)):
        calls = {"n": 0}

        def judge(messages, model=None, calls=calls):
            calls["n"] += 1
            if calls["n"] == 1:
                return "garbage"  # one retry
            return "{'pred': 'yes', 'score': 5}" if "x" in messages[1]["content"] else \
                "{'pred': 'no', 'score': 2}"

        d = tmp_path / name
        out = mod.judge_predictions(preds, str(d), judge_fn=judge, retry_sleep=0)
        n = calls["n"]
        assert mod.judge_predictions(preds, str(d), judge_fn=judge) == out and calls["n"] == n
        outs.append(out)
        caches.append({f: json.loads((d / f).read_text()) for f in sorted(os.listdir(d))})
    assert outs[1] == outs[0] and caches[1] == caches[0]


def test_lta_metric_matches_jax():
    rng = random.Random(0)
    for _ in range(20):
        a = [rng.randint(0, 4) for _ in range(rng.randint(0, 6))]
        b = [rng.randint(0, 4) for _ in range(rng.randint(0, 6))]
        assert tlta.edit_distance(a, b) == jlta.edit_distance(a, b)
    vv = {"take": 0, "put": 1, "stir": 2}
    nv = {"spoon": 0, "pot": 1, "cup": 2}
    for text in ("take spoon, stir pot", "put cup; take\nstir the pot.", "", "jump"):
        assert (tlta.parse_action_text(text, vv, nv, z=4)
                == jlta.parse_action_text(text, vv, nv, z=4))
    preds = [["take spoon, stir pot", "put cup"], ["put cup, put cup"]]
    args = (preds, [[0, 2], [0, 2, 1]], [[0, 1], [0, 1, 2]], vv, nv)
    assert tlta.score_lta(*args) == jlta.score_lta(*args)
    assert tlta.score_lta([], [], [], vv, nv) == jlta.score_lta([], [], [], vv, nv)


def test_ego4d_sample_evaluators_match_jax(tmp_path):
    class MiniTok:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(f"t{i}" for i in ids)

    rng = np.random.default_rng(1)
    labels = np.array([-100, 5, 6, 2, -100, 7, 2, -100, -100, 2])
    logits = rng.standard_normal((10, 16)).astype(np.float32)
    assert tego_run.eval_llm_sample(logits, labels, MiniTok()) == \
        jego_run.eval_llm_sample(logits, labels, MiniTok())
    g = rng.standard_normal((12, 2))
    gl = rng.integers(0, 2, 12)
    for tol in (0, 2):
        assert tego_run.eval_cls_sample(g, gl, tol) == jego_run.eval_cls_sample(g, gl, tol)
    rows = [("a goal", "a goal"), ("bad pred", "the truth")]
    for name, mod in (("j", jego_run), ("t", tego_run)):
        mod.write_caption_csv(str(tmp_path / f"{name}.csv"), rows)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert tego_run.score_caption_csv(str(tmp_path / "t.csv")) == \
        jego_run.score_caption_csv(str(tmp_path / "j.csv"))


# ---------------------------------------------------------------------------
# the runners on one carried-over tiny tree (fp32, CPU)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg = tiny_streammind_config()
    jp = init_streammind_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = SPLikeTokenizer()
    jm, _, _, _ = japi.model_init(cfg=cfg, params=jp, tokenizer=tok, dtype=jnp.float32)
    tm, _, _, _ = tapi.model_init(cfg=tconfig.tiny_streammind_config(), params=tp,
                                  tokenizer=tok, dtype=torch.float32, device="cpu")
    return jm, tm, tok


def _frames(n, size, seed):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _matchtime_tree(tmp_path, captions=((1, "00:02", "a pass"), (1, "00:05", "a shot"),
                                        (2, "00:03", "a goal"))):
    paths = []
    lab = tmp_path / "dataset" / "MatchTime" / "train" / "m"
    lab.mkdir(parents=True)
    (lab / "Labels-caption.json").write_text(json.dumps({"annotations": [
        {"gameTime": f"{h} - {t}", "anonymized": c} for h, t, c in captions]}))
    feat = tmp_path / "features_video" / "m"
    feat.mkdir(parents=True)
    for half in (1, 2):
        paths.append(str(feat / f"{half}_224p.mkv"))
    return paths


def test_gate_stream_fires_and_summary_match_jax(models, tmp_path):
    jm, tm, tok = models
    size = tm.cfg.vision.image_size
    videos = _matchtime_tree(tmp_path)

    def loader(path, cur_fps):
        seed = 1 + int(os.path.basename(path)[0])
        return [(i / cur_fps, f[None]) for i, f in enumerate(_frames(16, size, seed))]

    # a threshold between the gate's probabilities, so that it fires a few times
    probs = []

    class Probe:
        engine = tm.engine

        def __init__(self):
            self.state = tm.engine.new_stream_state()

        def process_frame(self, pixels):
            p, self.state = tm.engine.perceive_step(pixels, self.state)
            probs.append(float(p[1]))

    for v in videos:
        tgate.stream_video_fire_times(Probe(), v, frame_loader=loader)
    ranked = sorted(probs)
    threshold = (ranked[-5] + ranked[-6]) / 2
    kw = dict(session_kw=dict(gate_threshold=threshold, max_new_tokens=3), frame_loader=loader)
    jsum, jrows = jgate.evaluate_gate_stream(jm, tok, videos, **kw)
    tsum, trows = tgate.evaluate_gate_stream(tm, tok, videos, **kw)
    assert tsum == jsum and trows == jrows
    assert sum(len(r["fires"]) for r in trows) == 5
    assert set(tsum) == {f"{m}@{t}" for m in ("precision", "recall", "f1") for t in (5, 10, 1)}


def _ego4d_ds(mod, tok, tmp_path, model_type, size):
    anno = tmp_path / "ego.json"
    anno.write_text(json.dumps({
        "uid1": [[0.5, "You open the door."], [2.0, "You enter the room."],
                 [3.5, "You sit down."]],
        "uid2": [[1.0, "You pick a cup."], [1.5, "You drink."]]}))

    def loader(path, start, end):
        return _frames(int(round((end - start) * 2)), size, len(path) + int(end * 10))

    return mod.Ego4dNarrationDataset(str(tmp_path), str(anno), tok, model_type=model_type,
                                     frame_loader=loader)


def _jax_llm_logits(model, sample):
    """The JAX runner's llm loop body (``main`` holds it inline)."""
    from streammind_tpu.models import mistral as lm_mod
    from streammind_tpu.models import projector as proj_mod
    from streammind_tpu.models.meta import (
        build_splice_plan, bucket_length, encode_frames, splice_embeds)

    cfg = model.cfg
    feats = encode_frames(model.params, cfg, jnp.asarray(sample["video"]))
    memory, _ = proj_mod.mamba_project(model.params["projector"], cfg, feats)
    ids = list(sample["input_ids"][0])
    n = len(ids) - len(sample["span_frames"]) + int(memory.shape[1])
    plan = build_splice_plan(ids, sample["span_frames"], -201,
                             bucket_length(n, (256, 512, 1024, 2048, 4096)),
                             labels=list(sample["labels"][0]))
    embeds = splice_embeds(model.params["text"], jnp.asarray(plan.token_ids)[None],
                           jnp.asarray(plan.mem_index)[None], jnp.asarray(plan.use_mem)[None],
                           memory)
    logits, _ = lm_mod.text_forward(model.params["text"], cfg.text, inputs_embeds=embeds,
                                    attn_mask=jnp.asarray(plan.attn_mask)[None])
    glogits = proj_mod.gate_decision_step(model.params["projector"], cfg, memory[0])
    return np.asarray(logits[0][: plan.length]), plan.labels[: plan.length], np.asarray(glogits)


def test_ego4d_llm_and_cls_match_jax(models, tmp_path):
    jm, tm, tok = models
    size = tm.cfg.vision.image_size
    tds = _ego4d_ds(tego, tok, tmp_path, "llm", size)
    jds = _ego4d_ds(jego, tok, tmp_path, "llm", size)
    jppl, jcorr, jrows, jcls = [], [], [], []
    for i in range(len(jds)):
        sample = jds[i]
        logits, labels, glogits = _jax_llm_logits(jm, sample)
        out = jego_run.eval_llm_sample(logits, labels, tok)
        tlogits, tlabels = tego_run.llm_sample_logits(tm, tds[i])
        np.testing.assert_array_equal(tlabels, labels)
        np.testing.assert_allclose(tlogits, logits, rtol=1e-5, atol=1e-5)
        jppl.append(out["lm_ppl"])
        jcorr.append(out["lm_correctness"])
        jrows.extend(out["rows"])
        n = min(glogits.shape[0], sample["gate_labels"].shape[1])
        jcls.append(jego_run.eval_cls_sample(glogits[:n], sample["gate_labels"][0, :n]))
    got = tego_run.evaluate_llm(tm, tok, tds, range(len(tds)), str(tmp_path / "cap.csv"))
    assert got["lm_ppl"] == pytest.approx(np.mean(jppl), rel=1e-5)
    assert got["lm_correctness"] == np.mean(jcorr)
    jego_run.write_caption_csv(str(tmp_path / "jcap.csv"), jrows)
    assert got["nlg"] == jego_run.score_caption_csv(str(tmp_path / "jcap.csv"))
    cls = tego_run.evaluate_cls(tm, _ego4d_ds(tego, tok, tmp_path, "cls", size), range(2))
    assert cls == {k: np.mean([m[k] for m in jcls]) for k in cls}


def test_lta_beams_and_score_match_jax(models):
    jm, tm, tok = models
    video = _frames(5, tm.cfg.vision.image_size, 7)
    prompt = "Predict the next 20 future actions as 'verb noun' steps separated by commas."
    kw = dict(num_beams=3, num_return_sequences=3, max_new_tokens=8)
    jb = japi.infer_beams(jm, video, prompt, tok, **kw)
    tb = tapi.infer_beams(tm, video, prompt, tok, **kw)
    assert tb == jb and len(tb) == 3
    words = sorted({w.strip(",.") for b in tb for w in b.split()} | {"take", "cup"})
    vocab = {w: i for i, w in enumerate(words)}
    args = ([tb], [[vocab["take"], 1, 2]], [[0, vocab["cup"], 1]], vocab, vocab)
    assert tlta.score_lta(*args) == jlta.score_lta(*args)


def test_mcqa_and_oqa_answers_match_jax(models, tmp_path):
    jm, tm, tok = models
    size = tm.cfg.vision.image_size

    def processor(path, num_frames=8):
        if "missing" in path:
            raise IOError(f"cannot open {path}")
        return _frames(num_frames, size, len(path))

    records = [
        {"video": "a.mp4", "question": "What happens?", "candidates": ["a dog", "a cat",
         "a car", "rain"], "answer": "a cat", "task_type": "action", "question_id": 1},
        {"video": "missing.mp4", "question": "Scene?", "candidates": ["in", "out", "up", "down"],
         "answer": "up", "task_type": "scene", "question_id": 2},
        {"video": "bb.mp4", "question": "Count?", "candidates": ["one", "two", "three", "four"],
         "answer": "one", "task_type": "action", "question_id": 3},
    ]
    rows = {}
    for name, mod, model in (("jax", jmcqa, jm), ("port", tmcqa, tm)):
        rows[name] = list(mod.run_inference(model, tok, records, "mvbench", str(tmp_path),
                                            processor, num_frames=3))
    assert rows["port"] == rows["jax"] and rows["port"][1]["error"]
    video = processor("q.mp4", 4)
    for mode in ("openend", "vanilla"):
        assert (tapi.x_infer(video, "What is moving?", tm, tok, mode=mode)
                == japi.x_infer(video, "What is moving?", jm, tok, mode=mode))
