"""The port's native video ingest (``streammind_torch/native.py``) against the
JAX package's binding.

Both bindings read through the library the port builds from
``native/ingest.cpp`` into ``streammind_torch/_kernels/``: the JAX module's
``_LIB_PATH`` and ``_lib`` are pointed at it (and its ``_NATIVE_DIR`` at an
empty directory, so it starts no ``make`` into ``native/``).  Frames must
be bitwise equal in every request order, on short reads with and without
``strict``, through ``native_process_video`` and through the port's
``mm_utils.process_video``, which must take the native branch.
"""
import threading

import numpy as np
import pytest

from streammind_torch import mm_utils as tmm
from streammind_torch import native as tnative
from streammind_torch.constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from streammind_tpu import mm_utils as jmm
from streammind_tpu import native as jnative


@pytest.fixture(scope="module")
def jax_binding(tmp_path_factory):
    """The JAX binding, loaded from the port-built library."""
    if not tnative.available():
        pytest.skip("the ingest library does not build here (no g++ or libav)")
    empty = tmp_path_factory.mktemp("no_native_src")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(empty))
        mp.setattr(jnative, "_LIB_PATH", str(tnative.lib_path()))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        assert jnative.available()
        yield jnative


@pytest.fixture(scope="module")
def video(jax_binding, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "test.mp4")
    tnative.write_test_video(path, w=224, h=160, n_frames=30, fps=10)
    return path


def test_library_is_built_into_the_port_by_hash():
    path = tnative.lib_path()
    assert path.parent == tnative.BUILD_DIR and path.parent.name == "_kernels"
    assert path.parent.parent.name == "streammind_torch"
    assert path.name.startswith("libsm_ingest_") and path.suffix == ".so"


def test_concurrent_builds_rename_into_place(monkeypatch, tmp_path):
    """Several builders at once (as test workers are) each write a temporary
    file and rename it: one library, no temporary file left behind."""
    if not tnative.available():
        pytest.skip("the ingest library does not build here")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_kernels")
    errors, paths = [], []

    def one():
        try:
            paths.append(tnative.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and paths[0].exists()
    assert sorted(p.name for p in (tmp_path / "_kernels").iterdir()) == [paths[0].name]


def test_available_false_when_the_build_fails(monkeypatch, tmp_path):
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_kernels")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)
    assert not tnative.available()
    assert tnative._load_failed and not tnative.available()  # remembered, not rebuilt
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.NativeVideoReader("any.mp4")
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.write_test_video(str(tmp_path / "x.mp4"))


def test_open_and_info_match_jax(video, jax_binding):
    with tnative.NativeVideoReader(video) as t, jax_binding.NativeVideoReader(video) as j:
        got = (t.fps, t.num_frames, t.width, t.height)
        assert got == (j.fps, j.num_frames, j.width, j.height)
    assert got[2:] == (224, 160) and 28 <= got[1] <= 32
    assert got[0] == pytest.approx(10.0, rel=0.1)
    with pytest.raises(IOError, match="cannot open"):
        tnative.NativeVideoReader(video + ".missing")


@pytest.mark.parametrize("ids,size,pad", [
    ([0, 5, 10], 112, True), ([10, 2, 5], 112, True), ([7, 7, 1], 64, True),
    ([3, 20, 9, 0], 336, True), ([4, 1], 112, False),
])
def test_frames_bitwise_in_request_order(video, jax_binding, ids, size, pad):
    with tnative.NativeVideoReader(video) as t, jax_binding.NativeVideoReader(video) as j:
        got = t.read(ids, size=size, pad_square=pad)
        want = j.read(ids, size=size, pad_square=pad)
        asc = t.read(sorted(ids), size=size, pad_square=pad)
    assert got.shape == (len(ids), 3, size, size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    order = np.argsort(ids, kind="stable")
    for pos, src in enumerate(order):  # row pos of the ascending read is request order[pos]
        np.testing.assert_array_equal(got[src], asc[pos])
    if pad:  # letterbox rows (160 of 224 → pad top and bottom) hold the CLIP mean fill
        mean = np.asarray(CLIP_IMAGE_MEAN).reshape(3, 1)
        std = np.asarray(CLIP_IMAGE_STD).reshape(3, 1)
        fill = (np.round(mean * 255) / 255 - mean) / std
        np.testing.assert_allclose(got[0, :, 0, :], np.broadcast_to(fill, (3, size)),
                                   atol=0.02)


def test_sequential_and_backward_reads_match_jax(video, jax_binding):
    with tnative.NativeVideoReader(video) as t, jax_binding.NativeVideoReader(video) as j:
        for ids in ([0], [20], [0], [25, 26], [3]):  # forward, then back to the start
            np.testing.assert_array_equal(t.read(ids, size=112), j.read(ids, size=112))
    with tnative.NativeVideoReader(video) as t:
        a, b = t.read([0], size=112), t.read([20], size=112)
    assert not np.allclose(a, b)


@pytest.mark.parametrize("ids", [[500, 2, 5], [2, 5, 499], [1, 600, 0]])
def test_short_reads_match_jax(video, jax_binding, ids):
    with tnative.NativeVideoReader(video) as t, jax_binding.NativeVideoReader(video) as j:
        with pytest.raises(IOError, match="short read"):
            t.read(ids, size=112)
        with pytest.raises(IOError, match="short read"):
            j.read(ids, size=112)
        got = t.read(ids, size=112, strict=False)
        want = j.read(ids, size=112, strict=False)
        ref = t.read(sorted(i for i in ids if i < 100), size=112)
    np.testing.assert_array_equal(got, want)
    # the frames decoded keep their requested relative order
    kept = [i for i in ids if i < 100]
    assert got.shape[0] == len(kept)
    for pos, i in enumerate(kept):
        np.testing.assert_array_equal(got[pos], ref[sorted(kept).index(i)])


@pytest.mark.parametrize("num_frames,scheme,size", [(4, "uniform", 112), (8, "uniform", 336),
                                                     (40, "uniform", 64), (4, "fps", 112)])
def test_native_process_video_matches_jax(video, jax_binding, num_frames, scheme, size):
    got = tnative.native_process_video(video, num_frames=num_frames, sample_scheme=scheme,
                                       size=size)
    want = jax_binding.native_process_video(video, num_frames=num_frames,
                                            sample_scheme=scheme, size=size)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1:] == (3, size, size) and np.isfinite(got).all()


@pytest.mark.parametrize("aspect", ["pad", None])
def test_process_video_takes_the_native_branch(video, jax_binding, monkeypatch, aspect):
    calls = []
    real = tnative.native_process_video

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tnative, "native_process_video", counting)
    got = tmm.process_video(video, num_frames=6, aspect_ratio=aspect, image_size=112)
    want = jmm.process_video(video, num_frames=6, aspect_ratio=aspect, image_size=112)
    assert len(calls) == 1 and calls[0]["pad_square"] == (aspect == "pad")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 3, 112, 112)


def test_arrays_and_gifs_take_the_python_path(jax_binding, monkeypatch, tmp_path):
    """Arrays and GIF files never reach the native reader, as in the JAX
    package."""
    from PIL import Image

    monkeypatch.setattr(tnative, "native_process_video",
                        lambda *a, **kw: pytest.fail("this input must not take the native path"))
    frames = np.random.default_rng(0).integers(0, 255, (2, 40, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tmm.process_video(frames, image_size=56),
                                  jmm.process_video(frames, image_size=56))
    gif = str(tmp_path / "clip.gif")
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=100)
    np.testing.assert_array_equal(tmm.process_video(gif, num_frames=2, image_size=56),
                                  jmm.process_video(gif, num_frames=2, image_size=56))
