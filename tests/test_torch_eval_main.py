"""Each evaluation runner's ``main`` (``streammind_torch/eval/run_*.py``) with
``--device cpu`` against the JAX package's ``main`` on the same tiny
checkpoint directory (released key names, a word-level tokenizer, clips
written by the native ingest): the gate-stream summary and fires, the Ego4D
``llm`` (perplexity to 1e-5 relative) and ``cls`` reports, the LTA scores,
the MCQA answer file and scores, the OQA answer file and its judged report.
Both packages load the checkpoint in fp32 here and read the clips through
the ingest library the port builds.
"""
import dataclasses
import functools
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streammind_tpu.api as japi
from streammind_torch import api as tapi
from streammind_torch import config as tconfig
from streammind_torch import native as tnative
from streammind_torch.eval import gpt_judge as tjudge
from streammind_torch.eval import run_ego4d_lta as tlta
from streammind_torch.eval import run_ego4d_stream as tego_run
from streammind_torch.eval import run_gate_stream as tgate
from streammind_torch.eval import run_mcqa as tmcqa
from streammind_torch.eval import run_oqa as toqa
from streammind_tpu import native as jnative
from streammind_tpu.eval import gpt_judge as jjudge
from streammind_tpu.eval import run_ego4d_lta as jlta
from streammind_tpu.eval import run_ego4d_stream as jego_run
from streammind_tpu.eval import run_gate_stream as jgate
from streammind_tpu.eval import run_mcqa as jmcqa
from streammind_tpu.eval import run_oqa as joqa


# ---------------------------------------------------------------------------
def _write_tokenizer(d):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i in range(3, 256):
        vocab[f"w{i}"] = i
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)


def _released_sd(tree, cfg) -> dict:
    """A port param tree under the released full-SFT key names (HF Mistral,
    the mm_projector, HF CLIP under the vision tower)."""
    from streammind_torch.utils.checkpoint import export_projector_torch_sd

    t, v = tree["text"], tree["vision"]
    sd = {"model.embed_tokens.weight": t["embed_tokens"],
          "model.norm.weight": t["final_norm"]["weight"],
          "lm_head.weight": t["lm_head"]["weight"]}
    text = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm",
            "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
            "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}
    for i in range(cfg.text.num_layers):
        for ours, theirs in text.items():
            leaf = t["layers"][ours] if ours in t["layers"] else t["layers"]["mlp"][ours]
            sd[f"model.layers.{i}.{theirs}.weight"] = leaf["weight"][i]
    sd.update({"model.mm_projector." + k: x
               for k, x in export_projector_torch_sd(tree["projector"]).items()})
    pre = "model.vision_tower.vision_tower.vision_model."
    c = cfg.vision
    sd[pre + "embeddings.class_embedding"] = v["class_embedding"]
    sd[pre + "embeddings.patch_embedding.weight"] = v["patch_embedding"].reshape(
        c.hidden_size, 3, c.patch_size, c.patch_size)
    sd[pre + "embeddings.position_embedding.weight"] = v["position_embedding"]
    for p in ("weight", "bias"):
        sd[pre + f"pre_layrnorm.{p}"] = v["pre_layernorm"][p]
    clip = {"ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.out_proj", "ln2": "layer_norm2",
            "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(c.num_layers):
        for ours, theirs in clip.items():
            for p in ("weight", "bias"):
                sd[pre + f"encoder.layers.{i}.{theirs}.{p}"] = v["layers"][ours][p][i]
    return {k: x.detach().clone().contiguous() for k, x in sd.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A released-layout checkpoint of the tiny config with a 336 ViT input
    (the native reader's default size), a word-level tokenizer, two clips;
    the JAX binding reads through the port's ingest library."""
    pytest.importorskip("tokenizers")
    from streammind_torch.models.meta import init_streammind_params as t_init

    if not tnative.available():
        pytest.skip("the ingest library does not build here")
    root = tmp_path_factory.mktemp("eval_main")
    d = root / "ckpt"
    d.mkdir()
    base = tconfig.tiny_streammind_config()
    cfg = base.replace(vision=dataclasses.replace(base.vision, image_size=336))
    (d / "streammind_config.json").write_text(cfg.to_json())
    tree = t_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    torch.save(_released_sd(tree, cfg), d / "pytorch_model.bin")
    _write_tokenizer(str(d))
    vids = root / "videos"
    vids.mkdir()
    for name in ("a.mp4", "b.mp4"):
        tnative.write_test_video(str(vids / name), w=64, h=48, n_frames=12, fps=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(root))
        mp.setattr(jnative, "_LIB_PATH", str(tnative.lib_path()))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        # the checkpoint loaded in fp32 by both packages' runners, so that
        # their answers can be held equal (in bf16 the two frameworks round
        # differently and greedy decodes part within a few tokens)
        mp.setattr(japi, "model_init", functools.partial(japi.model_init, dtype=jnp.float32))
        mp.setattr(tapi, "model_init", functools.partial(tapi.model_init, dtype=torch.float32))
        yield root, str(d), str(vids)


def _mains(monkeypatch, capsys, jmain, tmain, argv):
    """JAX main (argv through sys.argv) then the port's main(argv + --device
    cpu); returns their standard outputs."""
    monkeypatch.setattr(sys, "argv", ["main"] + argv)
    jmain()
    jout = capsys.readouterr().out
    tmain(argv + ["--device", "cpu"])
    return jout, capsys.readouterr().out


def test_gate_stream_main_matches_jax(ckpt, monkeypatch, capsys):
    root, d, _ = ckpt
    lab = root / "gate" / "dataset" / "MatchTime" / "train" / "m"
    lab.mkdir(parents=True)
    (lab / "Labels-caption.json").write_text(json.dumps({"annotations": [
        {"gameTime": "1 - 00:01", "anonymized": "a pass"},
        {"gameTime": "2 - 00:01", "anonymized": "a goal"}]}))
    feat = root / "gate" / "features_video" / "m"
    feat.mkdir(parents=True)
    for half in (1, 2):
        tnative.write_test_video(str(feat / f"{half}_224p.mkv"), w=64, h=48, n_frames=18, fps=6)
    outs = [str(root / f"gate_{n}.json") for n in ("j", "t")]
    argv = ["--model-path", d, "--data-path", str(root / "gate" / "features_video")]
    monkeypatch.setattr(sys, "argv", ["main"] + argv + ["--output", outs[0]])
    jgate.main()
    tgate.main(argv + ["--output", outs[1], "--device", "cpu"])
    j, t = (json.loads(open(p).read()) for p in outs)
    assert t == j and len(t["per_video"]) == 2


def test_ego4d_main_matches_jax(ckpt, monkeypatch, capsys):
    root, d, _ = ckpt
    anno = root / "ego_main.json"
    anno.write_text(json.dumps({"v1": [[0.5, "w5 w6"], [1.5, "w7 w8 w9"]]}))

    def read(path, ids):
        return np.stack([np.full((48, 64, 3), 17 * int(i) % 255, np.uint8) for i in ids])

    from streammind_torch import mm_utils as tmm
    from streammind_tpu import mm_utils as jmm

    for mod in (tmm, jmm):  # the runner's Python reader in place of a decoder
        monkeypatch.setattr(mod, "read_video_frames", read)
        monkeypatch.setattr(mod, "video_metadata", lambda path: (12, 6.0))
    for kind in ("llm", "cls"):
        argv = ["--model-path", d, "--video-root", str(root), "--anno-path", str(anno),
                "--eval-type", kind, "--caption-path", str(root / f"ego_{kind}.csv")]
        jout, tout = _mains(monkeypatch, capsys, jego_run.main, tego_run.main, argv)
        j, t = json.loads(jout), json.loads(tout)
        if kind == "llm":
            assert t["lm_ppl"] == pytest.approx(j["lm_ppl"], rel=1e-5)
            t.pop("lm_ppl"), j.pop("lm_ppl")
        assert t == j


def test_lta_main_matches_jax(ckpt, monkeypatch, capsys):
    root, d, vids = ckpt
    anno = root / "lta.json"
    anno.write_text(json.dumps([
        {"clip": "a.mp4", "gt_verbs": [0, 1], "gt_nouns": [1, 0], "prompt": "w5 w6"},
        {"clip": "missing.mp4", "gt_verbs": [0], "gt_nouns": [0]}]))
    (root / "verbs.txt").write_text("w3\nw4\nw5\n")
    (root / "nouns.json").write_text(json.dumps(["w6", "w7"]))
    argv = ["--model-path", d, "--video-root", vids, "--anno-path", str(anno),
            "--verb-vocab", str(root / "verbs.txt"), "--noun-vocab", str(root / "nouns.json"),
            "--k", "2", "--num-frames", "4"]
    jout, tout = _mains(monkeypatch, capsys, jlta.main, tlta.main, argv)
    assert tout == jout and '"n_clips": 1' in tout


def test_mcqa_main_matches_jax(ckpt, monkeypatch, capsys):
    root, d, vids = ckpt
    qfile = root / "mcqa_q.json"
    qfile.write_text(json.dumps([
        {"q_uid": "a", "question": "What is shown?", "options": ["v", "w", "x", "y", "z"],
         "answer": 0},
        {"q_uid": "b", "question": "Then?", "options": ["p", "q", "r", "s", "t"],
         "answer": 3}]))
    outs = [str(root / f"mcqa_{n}.jsonl") for n in ("j", "t")]
    base = ["--model-path", d, "--benchmark", "egoschema", "--question-file", str(qfile),
            "--video-root", vids, "--num-frames", "3"]
    monkeypatch.setattr(sys, "argv", ["main"] + base + ["--answer-file", outs[0]])
    jmcqa.main()
    jout = capsys.readouterr().out
    tmcqa.main(base + ["--answer-file", outs[1], "--device", "cpu"])
    assert capsys.readouterr().out == jout
    assert open(outs[1]).read() == open(outs[0]).read()


def test_oqa_main_and_judge_match_jax(ckpt, monkeypatch, capsys):
    root, d, vids = ckpt
    qfile = root / "oqa_q.json"
    qfile.write_text(json.dumps([
        {"question_id": 1, "video_name": "a.mp4", "question": "w4 w5", "answer": "w6"},
        {"question_id": 2, "video_name": "b", "question_1": "w7", "question_2": "w8",
         "answer": "w9"},
        {"question_id": 3, "video_name": "missing.mp4", "question": "w3", "answer": "w3"}]))
    outs = [str(root / f"oqa_{n}.jsonl") for n in ("j", "t")]
    base = ["--model-path", d, "--question-file", str(qfile), "--video-root", vids]
    monkeypatch.setattr(sys, "argv", ["main"] + base + ["--answer-file", outs[0]])
    joqa.main()
    toqa.main(base + ["--answer-file", outs[1], "--device", "cpu"])
    j = [json.loads(line) for line in open(outs[0])]
    t = [json.loads(line) for line in open(outs[1])]
    assert t == j and "pred2" in t[1] and t[2]["pred"] == ""
    capsys.readouterr()
    judge = lambda messages, model=None: "{'pred': 'yes', 'score': 3}"  # noqa: E731
    monkeypatch.setattr(jjudge, "default_judge_fn", judge)
    monkeypatch.setattr(tjudge, "default_judge_fn", judge)
    printed = []
    for main, out, name in ((joqa.main, outs[0], "j"), (toqa.main, outs[1], "t")):
        argv = ["--judge-only", "--answer-file", out, "--judge-dim", "correctness",
                "--judge-dir", str(root / f"judge_{name}")]
        if main is joqa.main:
            monkeypatch.setattr(sys, "argv", ["main"] + argv)
            main()
        else:
            main(argv)
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and '"n_failed": 1' in printed[1]
