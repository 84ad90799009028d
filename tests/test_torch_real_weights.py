"""The port's released-checkpoint smoke tool
(``streammind_torch/tools/real_weights_smoke.py``) on a synthetic
released-format checkpoint drawn from a seed (the tiny config's widths, the
released key names, a word-level tokenizer; no download).

The CLI with ``--device cpu`` in a subprocess: its ``OK`` line and both
deltas against the ``transformers`` mirrors under 2e-4.  In process, the
checkpoint loaded in fp32 by both packages' ``model_init``: the port's ViT
features and prefill logits within 2e-5 relative rms of JAX's
``vit_forward`` / ``text_forward``, and the greedy caption and 8-frame
answer equal to JAX's ``infer`` / ``x_infer`` strings.  With
``transformers`` hidden, ``main()`` exits non-zero and names it.  Nothing
here needs either package's native library.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_convert import _tiny_manifest
from test_torch_eval_main import _write_tokenizer
from streammind_torch import config as tconfig
from streammind_torch.tools import real_weights_smoke as rws

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops gain nothing from threads, and under the
    suite's parallel workers a thread pool a worker oversubscribes the
    cores; the thread count is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The synthetic checkpoint of tests/test_real_weights_smoke.py: every
    released key at the tiny config's shape, N(0, 0.02) from seed 1."""
    d = tmp_path_factory.mktemp("rws") / "ckpt"
    d.mkdir()
    cfg = tconfig.tiny_streammind_config()
    (d / "streammind_config.json").write_text(cfg.to_json())
    rng = np.random.default_rng(1)
    sd = {k: torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.02)
          for k, shape in _tiny_manifest(cfg).items()}
    torch.save(sd, d / "pytorch_model.bin")
    _write_tokenizer(str(d))
    return str(d)


def test_cli_on_synthetic_checkpoint(ckpt):
    # transformers without TensorFlow; one thread, as in this process
    env = dict(os.environ, USE_TF="0", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "streammind_torch.tools.real_weights_smoke",
                        "--model-path", ckpt, "--max-new-tokens", "4", "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK: all deltas within tol" in r.stdout
    line = next(l for l in r.stdout.splitlines() if l.startswith('{"deltas"'))
    out = json.loads(line)
    assert out["tol"] == 2e-4
    assert set(out["deltas"]) == {"vit_feature_rms", "decoder_logits_rms"}
    assert all(v < 2e-4 for v in out["deltas"].values()), out
    assert "[config1] caption" in r.stdout and "[config2] 8-frame QA" in r.stdout


@pytest.fixture(scope="module")
def loaded(ckpt):
    """Both packages' fp32 model_init of the checkpoint, and the tool's
    config 1 / config 2 inputs drawn as the tool draws them."""
    from streammind_tpu import api as japi

    jm, _, jtok, jver = japi.model_init(ckpt, dtype=jnp.float32)
    tm, _, ttok, tver = rws.load_model(ckpt, device="cpu")
    assert jver == tver and ttok is not None
    size = tm.cfg.vision.image_size
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((1, 3, size, size)).astype(np.float32)
    video = rng.standard_normal((8, 3, size, size)).astype(np.float32)
    return dict(jax=(jm, jtok), port=(tm, ttok), version=tver, pixels=pixels, video=video)


@pytest.mark.parametrize("what", ["features", "logits"])
def test_port_side_matches_jax(loaded, what):
    from streammind_tpu.models import mistral as jlm
    from streammind_tpu.models.vit import vit_forward

    jm, tm = loaded["jax"][0], loaded["port"][0]
    if what == "features":
        ours = rws.vision_features(tm, loaded["pixels"])
        want = np.asarray(vit_forward(jm.params["vision"], jm.cfg.vision,
                                      jnp.asarray(loaded["pixels"])))
    else:
        ids = list(range(1, 17))
        ours = rws.decoder_logits(tm, ids)
        want = np.asarray(jlm.text_forward(jm.params["text"], jm.cfg.text,
                                           input_ids=jnp.asarray([ids], jnp.int32))[0])[0]
    assert ours.shape == want.shape and np.isfinite(ours).all()
    assert rws._rms(ours, want) < FEATURE_TOL


@pytest.mark.parametrize("turn", ["caption", "qa"])
def test_answers_match_jax(loaded, turn):
    from streammind_tpu import api as japi

    (jm, jtok), (tm, ttok), version = loaded["jax"], loaded["port"], loaded["version"]
    if turn == "caption":
        want = japi.infer(jm, loaded["pixels"], "Describe the image.", jtok, version=version,
                          max_new_tokens=8)
        got = rws.caption(tm, loaded["pixels"], ttok, version, 8)
    else:
        want = japi.x_infer(loaded["video"], "What is happening in this video?", jm, jtok,
                            mode="openend", version=version)
        got = rws.video_qa(tm, loaded["video"], ttok, version)
    assert got == want and got


def test_main_without_transformers_exits_nonzero(ckpt, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert rws.main(["--model-path", ckpt, "--device", "cpu"]) != 0
    captured = capsys.readouterr()
    assert "transformers" in captured.err and "OK" not in captured.out


def test_fp32_matmuls_restores_tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with rws.fp32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
