"""The port's host preprocessing and configs against the JAX package's.

Frame sampling, the CLIP preprocessing (square pad, bicubic resize, crop,
normalization), AnyRes crops, video decode from arrays and from a GIF
written in tmp_path, the temporal-aug photo grids and the base64 image
loader must give bitwise the JAX package's numpy output.  Configs written
by either package load in the other.
"""
import base64
import dataclasses
import io

import numpy as np
import pytest

from streammind_torch import config as tconfig
from streammind_torch import mm_utils as tmm
from streammind_tpu import config as jconfig
from streammind_tpu import mm_utils as jmm

Image = pytest.importorskip("PIL.Image")


def _frames(n, h, w, seed=0):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 255).astype(np.uint8)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("duration,n", [(100, 8), (7, 8), (1, 4), (1000, 16)])
def test_frame_sample_uniform(duration, n):
    assert tmm.frame_sample(duration, "uniform", n) == jmm.frame_sample(duration, "uniform", n)


@pytest.mark.parametrize("duration,fps", [(300, 30.0), (10, 30.0), (95, 24.5), (5, 0.5)])
def test_frame_sample_fps(duration, fps):
    a = jmm.frame_sample(duration, "fps", local_fps=fps)
    assert tmm.frame_sample(duration, "fps", local_fps=fps) == a
    with pytest.raises(ValueError):
        tmm.frame_sample(duration, "scene")


@pytest.mark.parametrize("size", [(40, 24), (24, 40), (33, 33)])
def test_expand2square(size):
    img = Image.fromarray(_frames(1, size[1], size[0])[0])
    bg = tmm.clip_background_color()
    assert bg == jmm.clip_background_color()
    _same(np.asarray(tmm.expand2square(img, bg)), np.asarray(jmm.expand2square(img, bg)))


@pytest.mark.parametrize("pad_square", [True, False])
@pytest.mark.parametrize("image_size", [56, 336])
def test_clip_preprocess(pad_square, image_size):
    imgs = [Image.fromarray(f) for f in _frames(2, 30, 50, seed=1)]
    imgs.append(Image.fromarray(_frames(1, 60, 20, seed=2)[0]).convert("L"))  # not RGB
    _same(tmm.clip_preprocess(imgs, image_size=image_size, pad_square=pad_square),
          jmm.clip_preprocess(imgs, image_size=image_size, pad_square=pad_square))


@pytest.mark.parametrize("aspect_ratio", ["pad", None, "anyres"])
def test_process_image(aspect_ratio, tmp_path):
    arr = _frames(1, 500, 700, seed=3)[0]
    _same(tmm.process_image(arr, aspect_ratio=aspect_ratio),
          jmm.process_image(arr, aspect_ratio=aspect_ratio))
    path = str(tmp_path / "img.png")
    Image.fromarray(arr).save(path)
    _same(tmm.process_image(path, aspect_ratio=aspect_ratio),
          jmm.process_image(path, aspect_ratio=aspect_ratio))


def test_anyres_helpers():
    res = [(672, 672), (336, 672), (336, 1008)]
    for size in ((1000, 400), (300, 900), (336, 336)):
        assert tmm.select_best_resolution(size, res) == jmm.select_best_resolution(size, res)
        assert (tmm.get_anyres_image_grid_shape(size, "[(2, 2), (1, 3)]", 336)
                == jmm.get_anyres_image_grid_shape(size, "[(2, 2), (1, 3)]", 336))


@pytest.mark.parametrize("aspect_ratio", ["pad", None])
def test_process_video_arrays(aspect_ratio):
    video = _frames(5, 24, 40, seed=4)
    _same(tmm.process_video(video, aspect_ratio=aspect_ratio, image_size=56),
          jmm.process_video(video, aspect_ratio=aspect_ratio, image_size=56))
    one = video[0]  # a single (H, W, 3) frame
    _same(tmm.process_video(one, image_size=56), jmm.process_video(one, image_size=56))


def _gif(tmp_path, n=12):
    import imageio

    path = str(tmp_path / "clip.gif")
    imageio.mimsave(path, list(_frames(n, 32, 48, seed=5)), duration=0.1)
    return path


def test_process_video_gif(tmp_path):
    path = _gif(tmp_path)
    assert tmm.video_metadata(path) == jmm.video_metadata(path)
    _same(tmm.read_video_frames(path, [0, 3, 3, 11, 5]),
          jmm.read_video_frames(path, [0, 3, 3, 11, 5]))
    for n in (4, 16):  # fewer and more samples than frames
        _same(tmm.process_video(path, num_frames=n, image_size=56),
              jmm.process_video(path, num_frames=n, image_size=56))


def test_process_video_taug(tmp_path):
    for video in (_frames(12, 20, 20, seed=6), _frames(32, 20, 20, seed=7), _gif(tmp_path)):
        _same(tmm.process_video_taug(video, num_frames=4, aspect_ratio=None, image_size=56),
              jmm.process_video_taug(video, num_frames=4, aspect_ratio=None, image_size=56))
    frames = [Image.fromarray(f) for f in _frames(9, 10, 12, seed=8)]
    _same(np.asarray(tmm.frame_expansion(frames, 3)), np.asarray(jmm.frame_expansion(frames, 3)))
    assert tmm.chunk_list(list(range(7)), 3) == jmm.chunk_list(list(range(7)), 3)


def test_load_image_from_base64_and_model_names():
    buf = io.BytesIO()
    Image.fromarray(_frames(1, 16, 16, seed=9)[0]).save(buf, format="PNG")
    data = base64.b64encode(buf.getvalue()).decode()
    _same(np.asarray(tmm.load_image_from_base64(data)), np.asarray(jmm.load_image_from_base64(data)))
    for p in ("ckpts/StreamMind-7B", "/a/b/StreamMind-7B/checkpoint-200/", "vicuna"):
        assert tmm.get_model_name_from_path(p) == jmm.get_model_name_from_path(p)


@pytest.mark.parametrize("name", ["default", "tiny", "qwen2", "mixtral", "llama2"])
def test_config_json_crosses_packages(name):
    def make(mod):
        base = mod.tiny_streammind_config() if name == "tiny" else mod.StreamMindConfig()
        text = {"qwen2": getattr(mod, "qwen2_7b", None), "mixtral": mod.mixtral_8x7b,
                "llama2": mod.llama2_7b}.get(name)
        return base.replace(text=text()) if text else base

    j, t = make(jconfig), make(tconfig)
    assert t.to_json() == j.to_json()
    assert tconfig.StreamMindConfig.from_json(j.to_json()) == t
    assert jconfig.StreamMindConfig.from_json(t.to_json()) == j
    assert dataclasses.asdict(tconfig.mistral_7b()) == dataclasses.asdict(jconfig.mistral_7b())


@pytest.mark.parametrize("raw", [
    {},
    {"model_type": "mistral", "hidden_size": 4096, "num_attention_heads": 32,
     "num_key_value_heads": 8, "sliding_window": 4096, "rope_theta": 1e6},
    {"model_type": "qwen2", "hidden_size": 3584, "num_attention_heads": 28,
     "num_key_value_heads": 4, "vocab_size": 152064, "tie_word_embeddings": False},
    {"model_type": "mixtral", "num_local_experts": 8, "num_experts_per_tok": 2,
     "sliding_window": None},
])
def test_text_config_from_hf(raw):
    assert (dataclasses.asdict(tconfig.text_config_from_hf(raw))
            == dataclasses.asdict(jconfig.text_config_from_hf(raw)))
