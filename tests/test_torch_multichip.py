"""Tensor-parallel serving in the port against the JAX package's, on the CPU.

``tests/test_multichip_inference.py``'s five cases: the port's engine runs
``StreamMindEngine(mesh=...)`` on every rank of a spawned gloo world of 4
(``test_torch_parallel.multichip_world``) on (2,1,2) and (1,2,2) meshes;
the JAX engine runs on its 2×2×2 mesh and on one device, in the pytest
process while the world runs, over the same tree (``params_from_numpy``)
and the same frames, each case once.
Held: the shards actually split (a rank's q is 1/(tp·fsdp) of the leaf, its
KV cache Hkv/tp heads, the tree unfused), perception at 1e-5 and memory at
1e-4, the two-turn session token for token, batched perception at S 8 (the
streams on dp), batched cognition at K 2 token for token.  fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_streaming import FakeTokenizer
from test_torch_parallel import ShapeOnlyMesh, multichip_world, save_tree, start_world
from streammind_tpu.config import tiny_streammind_config
from streammind_tpu.constants import VIDEO_TOKEN_INDEX
from streammind_tpu.models import mistral as jlm
from streammind_tpu.models.meta import init_streammind_params
from streammind_tpu.parallel import make_mesh
from streammind_tpu.parallel.serving import shard_kv_cache
from streammind_tpu.streaming import StreamMindEngine, StreamSession
from streammind_tpu.streaming.engine import build_turn_plan
from streammind_torch.utils.from_jax import params_from_numpy

SHAPES = ((2, 1, 2), (1, 2, 2))


def _jax_runs(cfg, eng, data, mesh=None):
    """The five cases' JAX results on one engine (``mesh``: its KV cache
    sharded as the engine's)."""
    out = {}
    st = eng.new_stream_state()
    probs = []
    for f in data["frames"][:3]:
        gp, st = eng.perceive_step(jnp.asarray(f), st)
        probs.append(np.asarray(gp))
    out["perceive"] = (probs, np.asarray(st.memory))
    tok = FakeTokenizer()
    s = StreamSession(eng, tok, prompt_ids=[1, 10, 11, VIDEO_TOKEN_INDEX, 12],
                      max_new_tokens=8, gate_threshold=2.0)
    texts = []
    for i, f in enumerate(data["frames"]):
        text = s.process_frame(jnp.asarray(f), force_fire=(i in (1, 3)))
        if text is not None:
            texts.append(text)
    out["session"] = (texts, int(s.cache.length[0]))
    st = eng.new_stream_state(8)
    for _ in range(2):
        gp, st = eng.perceive_step_batch(jnp.asarray(data["pixels8"]), st)
    out["batch"] = (np.asarray(gp), np.asarray(st.memory))
    plans = [build_turn_plan(eng, tok, [0, 1], [1, 5, VIDEO_TOKEN_INDEX, 7], pad_to=32),
             build_turn_plan(eng, tok, [2, 3, 4], [1, 9, VIDEO_TOKEN_INDEX, 8], pad_to=32)]
    cache = jlm.init_kv_cache(cfg.text, 2, 256, jnp.float32)
    if mesh is not None:
        cache = shard_kv_cache(cache, mesh, batch_axis="dp")
    last, cache = eng.prefill_batch(plans, jnp.asarray(data["memory"]), cache)
    out["cognition"] = eng.generate_from_prefill_batch(last, cache, max_new_tokens=8)[0]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's world runs while the JAX engines run the same cases once
    each (one device and the 2×2×2 mesh)."""
    tmp = tmp_path_factory.mktemp("multichip")
    cfg = tiny_streammind_config()
    params = init_streammind_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    data = dict(
        frames=[rng.standard_normal((1, 3, size, size)).astype(np.float32) for _ in range(4)],
        pixels8=rng.standard_normal((8, 3, size, size)).astype(np.float32),
        memory=rng.standard_normal((2, cfg.max_stream_frames, cfg.text.hidden_size)
                                   ).astype(np.float32))
    tree = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    world = start_world(multichip_world, 4, tmp, save_tree(tree, tmp / "tree.pt"), data)
    mesh = make_mesh(dp=2, fsdp=2, tp=2)
    jax_runs = [
        _jax_runs(cfg, StreamMindEngine(params, cfg, eos_token_id=2, prefill_buckets=(32, 64)),
                  data),
        _jax_runs(cfg, StreamMindEngine(params, cfg, eos_token_id=2, prefill_buckets=(32, 64),
                                        mesh=mesh), data, mesh)]
    return cfg, jax_runs, world.result()


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_params_actually_split(setup, shape):
    cfg, _, res = setup
    local, whole, kv_heads, fused = res[("split", shape)]
    assert local == whole // (shape[1] * shape[2])
    assert kv_heads == cfg.text.num_kv_heads // shape[2]
    assert not fused


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_perceive_matches_single_device(setup, shape):
    _, jax_runs, res = setup
    probs, memory, frame_idx = res[("perceive", shape)]
    for run in jax_runs:  # one device, then the 2×2×2 mesh
        jprobs, jmemory = run["perceive"]
        for i in range(3):
            np.testing.assert_allclose(probs[i], jprobs[i], atol=1e-5)
        np.testing.assert_allclose(memory, jmemory, atol=1e-4)
    assert frame_idx == 3


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_stream_session_two_turns(setup, shape):
    _, jax_runs, res = setup
    for run in jax_runs:
        texts, length = run["session"]
        assert len(texts) == 2
        assert res[("session", shape)] == (texts, length)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_batched_perception(setup, shape):
    _, jax_runs, res = setup
    gs_port, mem_port, rows_held = res[("batch", shape)]
    assert rows_held == 8 // shape[0]
    for run in jax_runs:
        gp, memory = run["batch"]
        np.testing.assert_allclose(gs_port, gp, atol=1e-5)
        np.testing.assert_allclose(mem_port, memory, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_batched_cognition(setup, shape):
    cfg, jax_runs, res = setup
    toks, k_shape = res[("cognition", shape)]
    assert k_shape[1] == 2 // shape[0] and k_shape[3] == cfg.text.num_kv_heads // shape[2]
    assert toks == jax_runs[0]["cognition"] == jax_runs[1]["cognition"]


def test_mesh_that_does_not_fit_is_refused():
    """tp must divide the kv heads and the Mamba d_inner: checked first, with
    the JAX package's message."""
    from streammind_torch import config as tconfig
    from streammind_torch.streaming import StreamMindEngine as TEngine

    with pytest.raises(ValueError, match="mesh tp=3 does not divide num_kv_heads=2"):
        TEngine({}, tconfig.tiny_streammind_config(), device="cpu", mesh=ShapeOnlyMesh(tp=3))
