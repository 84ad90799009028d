"""The port's dp / fsdp / tp meshes against the JAX package's, on the CPU.

The JAX package shards over its 8-device CPU mesh in the pytest process;
the port runs its ranks as spawned processes over gloo (``run_world``,
which the other multi-process test files import): one world of 4 for the
whole file, every case inside it, rank 0's results written to tmp_path.
Compared: the mesh shapes and the refusal of a mesh larger than the world;
``spec_for`` equal to JAX's on every leaf path of the tiny, quantized
(``w_int8``, ``w_int4`` + ``scale4``, ``w_int4pc``), LoRA and Mixtral
trees; local shard shapes (1/(tp·fsdp) of a decoder weight); the
per-channel int4 row shard (repacked) against the whole product;
``text_forward`` on (1,1,4) (tp 4 over 2 kv heads), (1,2,2) and (2,1,2)
meshes against JAX's one-device and (1,2,4)-sharded logits at 2e-4, with
``sequence_axis`` too; its gradients against the one-device port's; and
``gather_params`` ∘ ``shard_params`` as the identity, bitwise.
"""
import dataclasses
import os
import pickle
import socket
import sys
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from streammind_torch import config as tconfig
from streammind_torch.parallel import mesh as tmesh
from streammind_torch.parallel import partitioning as tpart
from streammind_torch.utils import dist as tdist

WORLD = 4
MESHES = ((1, 1, 4), (1, 2, 2), (2, 1, 2))


# ---------------------------------------------------------------------------
# the spawn harness
# ---------------------------------------------------------------------------
def _child(rank, world, rdzv, out, fn, args_path):
    # a rank that raises exits at once (spawn then stops the others); a
    # collective that waits on a dead rank gives up after the timeout
    torch.set_num_threads(1)
    # tensorboard's documented switch to its TensorFlow stub: train() writes
    # TensorBoard scalars, and importing TensorFlow takes ~17 s a rank
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("notf"))
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    if rdzv.startswith("env:"):  # a launcher's variables; fn starts the group
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=rdzv[4:])
    else:
        tdist.init_process_group(init_method="file://" + rdzv, world_size=world, rank=rank,
                                 device="cpu", timeout_s=120)
    res = fn(rank, world, *args)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    tdist.barrier()
    tdist.shutdown()


def start_world(fn, world, tmp_path, *args, env: bool = False):
    """Start fn(rank, world, *args) on ``world`` spawned gloo ranks (one
    thread each, a file:// rendezvous under tmp_path); ``.result()`` joins
    them and returns rank 0's return value.  The arguments go through a
    file: a spawn start blocks until each child has read what is piped to
    it, which it does only after its imports.  ``env``: no group is
    started; each rank gets the variables a launcher sets (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR and a free MASTER_PORT on 127.0.0.1) and
    fn starts the group from them."""
    stem = str(tmp_path / f"{fn.__name__}_{world}")
    rdzv, out, args_path = stem + ".rdzv", stem + ".out.pkl", stem + ".args.pkl"
    if env:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            rdzv = f"env:{s.getsockname()[1]}"
    for p in (rdzv, out):
        if os.path.exists(p):
            os.remove(p)
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    ctx = mp.start_processes(_child, args=(world, rdzv, out, fn, args_path), nprocs=world,
                             join=False, start_method="spawn")

    class World:
        @staticmethod
        def result():
            while not ctx.join():
                pass
            with open(out, "rb") as f:
                return pickle.load(f)

    return World


def run_world(fn, world, tmp_path, *args):
    """``start_world`` and wait for it."""
    return start_world(fn, world, tmp_path, *args).result()


def save_tree(tree, path):
    torch.save(tree, path)
    return str(path)


# ---------------------------------------------------------------------------
# the port's world
# ---------------------------------------------------------------------------
def _quantized(text):
    from streammind_torch.utils.quantize import (
        quantize_linear_weight,
        quantize_linear_weight_int4,
        quantize_linear_weight_int4_pc,
    )

    out = {k: v for k, v in text.items()}
    layers = dict(text["layers"])
    layers["q"] = quantize_linear_weight(layers["q"]["weight"])
    layers["k"] = quantize_linear_weight_int4(layers["k"]["weight"], group=16)
    layers["o"] = quantize_linear_weight_int4_pc(layers["o"]["weight"])
    mlp = dict(layers["mlp"])
    mlp["down"] = quantize_linear_weight_int4(mlp["down"]["weight"], group=16)
    mlp["up"] = quantize_linear_weight_int4_pc(mlp["up"]["weight"])
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


def _parallel_world(rank, world, tree_path, ids):
    from streammind_torch.models import mistral as lm
    from streammind_torch.ops import attention as A
    from streammind_torch.parallel import collectives as C

    cfg = tconfig.tiny_streammind_config()
    full = torch.load(tree_path)
    ids = torch.as_tensor(ids)
    res = {"coords": {}, "logits": {}, "seq": {}, "grad_err": {}, "roundtrip": {},
           "shapes": {}}
    try:
        tmesh.make_mesh(2, 2, 2)
    except ValueError as e:
        res["too_large"] = str(e)
    for shape in MESHES:
        mesh = tmesh.make_mesh(*shape)
        res["coords"][shape] = tpart.mesh_coords(mesh)
        local = tpart.shard_params(full, mesh)
        res["shapes"][shape] = tuple(local["text"]["layers"]["q"]["weight"].shape)
        rows = C.axis_rows(ids.shape[0], mesh, "dp")
        with tmesh.set_mesh(mesh):
            logits, _ = lm.text_forward(local["text"], cfg.text, input_ids=ids[rows])
            res["logits"][shape] = C.all_gather_rows(logits, mesh, "dp").numpy()
            seq, _ = lm.text_forward(local["text"], cfg.text, input_ids=ids[rows],
                                     sequence_axis="tp")
            res["seq"][shape] = C.all_gather_rows(seq, mesh, "dp").numpy()
            if shape == (1, 1, 4):  # tp 4 over 2 kv heads: each rank reads one kv head
                calls = A.flash_mha_sharded.calls
                fl, _ = lm.text_forward(local["text"], cfg.text, input_ids=ids,
                                        attn_impl="flash!")
                res["flash"] = (fl.numpy(), A.flash_mha_sharded.calls - calls)
        # gradients of a sharded forward against the one-device port's
        if shape == (1, 2, 2):
            ref = {k: v for k, v in full["text"].items()}
            ref = tpart._walk(ref, lambda p, t: t.clone().requires_grad_(True))
            lg, _ = lm.text_forward(ref, cfg.text, input_ids=ids)
            (lg ** 2).mean().backward()
            loc = tpart._walk(local["text"], lambda p, t: t.clone().requires_grad_(True))
            with tmesh.set_mesh(mesh):
                lg, _ = lm.text_forward(loc, cfg.text, input_ids=ids, sequence_axis="tp")
                (lg ** 2).mean().backward()
            errs = {}
            for (path, r), l in zip(_flat(ref).items(), _flat(loc).values()):
                g = tpart.gather_leaf(l.grad, "text." + path, l.dim(), mesh)
                errs[path] = float((g - r.grad).abs().max() / (r.grad.abs().max() + 1e-12))
            res["grad_err"] = errs
        # gather ∘ shard: the identity, bitwise, also over quantized leaves
        for name, tree in (("tiny", full),
                           ("quantized", {"text": _quantized(full["text"])})):
            back = tpart.gather_params(tpart.shard_params(tree, mesh), mesh)
            res["roundtrip"][(shape, name)] = all(
                torch.equal(a, b) for a, b in zip(_flat(tree).values(), _flat(back).values()))
    return res


def _flat(tree):
    from streammind_torch.train.trainer import named_leaves

    return named_leaves(tree)


# ---------------------------------------------------------------------------
# the JAX side and the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from streammind_tpu.config import tiny_streammind_config
    from streammind_tpu.models.meta import init_streammind_params
    from streammind_torch.utils.from_jax import params_from_numpy

    tmp = tmp_path_factory.mktemp("parallel")
    jp = init_streammind_params(jax.random.PRNGKey(0), tiny_streammind_config())
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int64)
    res = run_world(_parallel_world, WORLD, tmp, save_tree(tree, tmp / "tree.pt"), ids)
    return jp, ids, res


def _jax_logits(jp, ids, mesh_shape=None, sequence_axis=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from streammind_tpu.config import tiny_streammind_config
    from streammind_tpu.models import mistral as jlm
    from streammind_tpu.parallel import make_mesh, shard_params

    cfg = tiny_streammind_config()
    ids = jnp.asarray(ids)
    fwd = jax.jit(lambda p, i: jlm.text_forward(p, cfg.text, input_ids=i,
                                                sequence_axis=sequence_axis)[0])
    if mesh_shape is None:
        return np.asarray(fwd(jp["text"], ids))
    mesh = make_mesh(*mesh_shape)
    with jax.set_mesh(mesh):
        sharded = shard_params(jp, mesh)
        return np.asarray(fwd(sharded["text"], jax.device_put(ids, NamedSharding(mesh, P("dp")))))


def test_mesh_shapes(world):
    _, _, res = world
    mesh = tmesh.make_mesh(1, 1, 1)  # no process group: the local (1,1,1) mesh
    assert tmesh.mesh_shape(mesh) == {"dp": 1, "fsdp": 1, "tp": 1}
    for m in (tmesh.single_device_mesh(), tmesh.default_mesh()):
        assert tmesh.mesh_shape(m) == tmesh.mesh_shape(mesh) and tmesh.is_trivial(m)
    assert tmesh.replicated(mesh) == () and tmesh.AXES == ("dp", "fsdp", "tp")
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        tmesh.make_mesh(dp=2, fsdp=2, tp=2)
    assert res["too_large"] == "mesh 2x2x2 needs 8 devices, have 4"
    assert res["coords"][(2, 1, 2)] == {"dp": 0, "fsdp": 0, "tp": 0}


def _jax_spec(path, ndim):
    from streammind_tpu.parallel import spec_for

    return tuple(spec_for(path, ndim))


def _all_trees():
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.models.mistral import init_text_params
    from streammind_torch.train.lora import init_lora_params
    from streammind_torch.utils.quantize import quantize_text_params

    cfg = tconfig.tiny_streammind_config()
    g = torch.Generator().manual_seed(0)
    tiny = init_streammind_params(g, cfg, device="cpu")
    trees = {"tiny": tiny, "lora": {"lora": init_lora_params(g, tiny["text"], r=4)}}
    for bits, scheme in ((8, "group"), (4, "group"), (4, "pc")):
        trees[f"int{bits}{scheme}"] = {"text": quantize_text_params(tiny["text"], bits=bits,
                                                                    scheme=scheme)}
    mix = dataclasses.replace(cfg.text, num_experts=4, num_experts_per_tok=2)
    trees["mixtral"] = {"text": init_text_params(g, mix, device="cpu")}
    return trees


def test_spec_for_equals_jax_on_every_leaf():
    n = 0
    for name, tree in _all_trees().items():
        for path, leaf in _flat(tree).items():
            assert tpart.spec_for(path, leaf.dim()) == _jax_spec(path, leaf.dim()), (name, path)
            n += 1
    assert n > 100
    assert tpart.spec_for("text.layers.o.w_int4pc", 3) == (None, "fsdp", "tp")
    assert tpart.spec_for("unknown.thing", 2) == ()


def test_param_placement_is_actually_sharded(world):
    """(L, out, in) on (None, tp, fsdp): a (1,2,4) rank holds 1/8 of q."""
    cfg = tconfig.tiny_streammind_config()
    q = torch.zeros(cfg.text.num_layers, cfg.text.q_dim, cfg.text.hidden_size)
    shard = tpart.local_shard(q, tpart.spec_for("text.layers.q.weight", 3),
                              {"dp": 1, "fsdp": 2, "tp": 4}, {"fsdp": 1, "tp": 3})
    assert shard.shape == (q.shape[0], q.shape[1] // 4, q.shape[2] // 2)
    _, _, res = world
    assert res["shapes"][(1, 2, 2)] == (q.shape[0], q.shape[1] // 2, q.shape[2] // 2)
    assert res["shapes"][(1, 1, 4)] == (q.shape[0], q.shape[1] // 4, q.shape[2])


@pytest.mark.parametrize("tp", [2, 4])
def test_int4pc_row_shard_product(tp):
    """A per-channel int4 o (column-halved nibbles) cut on its in dim by tp
    is repacked: each rank's shard is a valid w_int4pc of its in/tp
    columns, and the ranks' products sum to the whole product."""
    from streammind_torch.utils.params import linear
    from streammind_torch.utils.quantize import quantize_linear_weight_int4_pc

    g = torch.Generator().manual_seed(tp)
    w = torch.randn(2, 24, 64, generator=g)
    x = torch.randn(3, 64, generator=g)
    p = quantize_linear_weight_int4_pc(w)
    spec = tpart.spec_for("text.layers.o.w_int4pc", 3)
    pieces, total = [], 0
    for r in range(tp):
        shard = tpart.local_shard(p["w_int4pc"], spec, {"tp": tp}, {"tp": r},
                                  "text.layers.o.w_int4pc")
        assert shard.shape == (2, 24, 64 // tp // 2)
        pieces.append(shard)
        xr = x[:, r * 64 // tp:(r + 1) * 64 // tp]
        total = total + linear(xr, {"w_int4pc": shard[0], "scale": p["scale"][0]})
    full = linear(x, {"w_int4pc": p["w_int4pc"][0], "scale": p["scale"][0]})
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(tpart.join_dim(pieces, 2, "int4pc"), p["w_int4pc"])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_text_forward_matches_jax(world, shape):
    jp, ids, res = world
    single = _jax_logits(jp, ids)
    jsharded = _jax_logits(jp, ids, (1, 2, 4))
    np.testing.assert_allclose(res["logits"][shape], single, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res["logits"][shape], jsharded, rtol=2e-4, atol=2e-4)


def test_flash_past_the_kv_heads_matches_jax(world):
    """(1,1,4) over the tiny decoder's 2 kv heads with impl='flash!' (the
    training dispatch): every layer's attention takes flash_mha_sharded on
    the rank's q head and the one kv head it reads; the logits are JAX's."""
    jp, ids, res = world
    logits, calls = res["flash"]
    assert calls == tconfig.tiny_streammind_config().text.num_layers
    np.testing.assert_allclose(logits, _jax_logits(jp, ids), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits, _jax_logits(jp, ids, (1, 2, 4)), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", MESHES)
def test_sequence_parallel_matches_jax(world, shape):
    jp, ids, res = world
    jseq = _jax_logits(jp, ids, (1, 2, 4), sequence_axis="tp")
    np.testing.assert_allclose(res["seq"][shape], jseq, rtol=2e-4, atol=2e-4)


def test_sharded_gradients_match_one_device(world):
    """Gather-at-use (fsdp), the tp reductions and the S gather/scatter in
    the backward: every leaf's gathered gradient within 1e-4 (relative to
    its largest) of the one-device port's."""
    _, _, res = world
    errs = res["grad_err"]
    assert len(errs) > 10
    assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("shape", MESHES)
def test_gather_params_inverts_shard_params(world, shape):
    _, _, res = world
    assert res["roundtrip"][(shape, "tiny")]
    assert res["roundtrip"][(shape, "quantized")]


# ---------------------------------------------------------------------------
# worlds of the other files (kept here: a spawned rank imports the module of
# its function, and this one imports no JAX)
# ---------------------------------------------------------------------------
_BANKS = ("gate", "up", "down")


def _moe_cfg(experts, top_k):
    return dataclasses.replace(tconfig.tiny_text_config(), num_experts=experts,
                               num_experts_per_tok=top_k)


def _port_sharded(xt, topi, topw, cfg, experts, mesh):
    """The port's sharded dispatch on this rank's shards of one layer's
    banks: the output and the gathered gradients of sum(out²)."""
    from streammind_torch.models import mistral as tlm

    x = torch.from_numpy(xt).requires_grad_(True)
    ex = {n: e.clone().requires_grad_(True) for n, e in experts.items()}
    out = tlm._moe_apply_grouped_sharded(x, ex, cfg, torch.from_numpy(topi),
                                         torch.from_numpy(topw), mesh)
    (out ** 2).sum().backward()
    grads = {n: tpart.gather_leaf(ex[n].grad[None], f"text.layers.experts.{n}", 4, mesh)[0]
             for n in _BANKS}
    return out.detach().numpy(), x.grad.numpy(), {n: g.numpy() for n, g in grads.items()}


def moe_world(rank, world, tree8, tree8k1, data):
    """The sharded cases of tests/test_moe.py (test_torch_moe.py compares)."""
    from streammind_torch.models import mistral as tlm
    from streammind_torch.parallel import collectives as C
    from streammind_torch.train import trainer as ttr

    cfg = _moe_cfg(8, 2)
    cfg1 = _moe_cfg(8, 1)
    full = torch.load(tree8)
    res = {}
    for shape in ((1, 2, 2), (2, 1, 2)):
        mesh = tmesh.make_mesh(*shape)
        local = tpart.shard_params({"text": full}, mesh)["text"]
        ex = {n: local["layers"]["experts"][n][0] for n in _BANKS}
        res[("fwd", shape)] = _port_sharded(data["xt"], data["topi"], data["topw"], cfg, ex, mesh)
        res[("skew", shape)] = _port_sharded(data["xt"], data["topi_skew"], data["topw_skew"],
                                             cfg, ex, mesh)[0]
        res[("resolve", shape)] = tlm._resolve_moe_dispatch(mesh, cfg)[0]
        res[("tight", shape)] = tlm._resolve_moe_dispatch(mesh, _moe_cfg(4, 2))
        # the train step's composition: text_forward with remat under the mesh
        p = tpart._walk(local, lambda path, t: t.clone().requires_grad_(True))
        ids = torch.from_numpy(data["ids"])
        with tmesh.set_mesh(mesh):
            assert tlm._resolve_moe_dispatch(None, cfg)[0] == "sharded_grouped"
            rows = C.axis_rows(ids.shape[0], mesh, "dp")
            logits, _ = tlm.text_forward(p, cfg, input_ids=ids[rows], remat=True)
            loss = (logits.float() ** 2).sum()
            loss.backward()
            loss = C.all_gather_rows(loss[None].detach(), mesh, "dp").sum() / logits.numel() \
                / mesh.size(0)
        gnorm = ttr.sharded_global_norm(
            {f"text.{k}": v.grad for k, v in ttr.named_leaves(p).items() if v.grad is not None},
            mesh)
        res[("remat", shape)] = (float(loss), float(gnorm))
    mesh = tmesh.make_mesh(1, 1, 4)  # tp only
    local = tpart.shard_params({"text": torch.load(tree8k1)}, mesh)["text"]
    ex = {n: local["layers"]["experts"][n][0] for n in _BANKS}
    res["tp_only"] = _port_sharded(data["xt10"], data["topi10"], data["topw10"], cfg1, ex,
                                   mesh)[0]
    return res




class FakeTokenizer:
    """tests/test_streaming.py's tokenizer (that module imports JAX)."""
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


def multichip_world(rank, world, tree_path, data):
    """tests/test_multichip_inference.py's five cases on this rank's engine
    (test_torch_multichip.py compares)."""
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.models import mistral as lm
    from streammind_torch.parallel import collectives as C
    from streammind_torch.parallel.serving import shard_kv_cache
    from streammind_torch.streaming import StreamMindEngine, StreamSession
    from streammind_torch.streaming.engine import build_turn_plan

    cfg = tconfig.tiny_streammind_config()
    params = torch.load(tree_path)
    res = {}
    for shape in ((2, 1, 2), (1, 2, 2)):
        mesh = tmesh.make_mesh(*shape)
        eng = StreamMindEngine(params, cfg, eos_token_id=2, prefill_buckets=(32, 64),
                               device="cpu", mesh=mesh)
        q = eng.params["text"]["layers"]["q"]["weight"]
        k = eng.new_kv_cache().k
        res[("split", shape)] = (q.numel(), params["text"]["layers"]["q"]["weight"].numel(),
                                 k.shape[3], "qkv" in eng.params["text"]["layers"])
        # perceive
        state = eng.new_stream_state()
        probs = []
        for f in data["frames"][:3]:
            gp, state = eng.perceive_step(torch.from_numpy(f), state)
            probs.append(gp.numpy())
        res[("perceive", shape)] = (np.stack(probs), state.memory.numpy(), state.frame_idx)
        # the two-turn session
        tok = FakeTokenizer()
        s = StreamSession(eng, tok, prompt_ids=[1, 10, 11, VIDEO_TOKEN_INDEX, 12],
                          max_new_tokens=8, gate_threshold=2.0)
        texts = [t for i, f in enumerate(data["frames"][:4])
                 if (t := s.process_frame(torch.from_numpy(f), force_fire=i in (1, 3)))
                 is not None]
        res[("session", shape)] = (texts, int(s.cache.length[0]))
        # batched perception, S 8 (streams on dp)
        ss = eng.new_stream_state(8)
        rows_held = ss.memory.shape[0]
        for _ in range(2):
            gs, ss = eng.perceive_step_batch(torch.from_numpy(data["pixels8"]), ss)
        res[("batch", shape)] = (gs.numpy(), C.all_gather_rows(ss.memory, mesh, "dp").numpy(),
                                 rows_held)
        # batched cognition, K 2 (the cache's rows on dp, heads on tp)
        plans = [build_turn_plan(eng, tok, [0, 1], [1, 5, VIDEO_TOKEN_INDEX, 7], pad_to=32),
                 build_turn_plan(eng, tok, [2, 3, 4], [1, 9, VIDEO_TOKEN_INDEX, 8], pad_to=32)]
        cache = shard_kv_cache(lm.init_kv_cache(cfg.text, 2, 256, torch.float32, device="cpu"),
                               mesh, batch_axis="dp")
        last, cache = eng.prefill_batch(plans, torch.from_numpy(data["memory"]), cache)
        toks, _, cache = eng.generate_from_prefill_batch(last, cache, max_new_tokens=8)
        res[("cognition", shape)] = (toks, tuple(cache.k.shape))
    return res


# --- training --------------------------------------------------------------
class ListDataset:
    """Samples made in the parent (test_train_run.FakeScoreDataset's)."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i % len(self.samples)]


def port_train(tree_path, samples, out_dir, max_steps=None, **mesh):
    """The port's train() on the llm stage (4 steps, lr 1e-3, fp32, CPU),
    starting from the tree at ``tree_path``; the logged losses."""
    import json

    from streammind_torch.train import run as trun
    from streammind_torch.train.args import DataArguments, ModelArguments, TrainingArguments

    cfg = tconfig.tiny_streammind_config()
    ma = ModelArguments(train_skip_cls=True)
    da = DataArguments(score_dataset_train_llm=True, num_workers=1)
    ta = TrainingArguments(output_dir=str(out_dir), learning_rate=1e-3, bf16=False,
                           save_steps=2, logging_steps=1, max_steps=4, resume=True,
                           device="cpu", **mesh)
    real = trun.init_streammind_params
    trun.init_streammind_params = lambda *a, **k: torch.load(tree_path)
    try:
        trun.train(ma, da, ta, dataset=ListDataset(samples), cfg=cfg,
                   max_steps_override=max_steps)
    finally:
        trun.init_streammind_params = real
    tdist.barrier()
    with open(os.path.join(str(out_dir), "logs", "metrics.jsonl")) as f:
        return [json.loads(line)["train/loss"] for line in f]


def train_world2(rank, world, tree_path, samples, tmp):
    """fsdp 2, tp 2 and dp 2 runs at a global batch of 2 (a per-device
    batch of 2, of 1 on dp 2; test_torch_dist_train.py compares), started
    from a launcher's variables: the first train() starts the group."""
    import torch.distributed as dist

    res = {"fsdp2": port_train(tree_path, samples, f"{tmp}/fsdp2", fsdp=2,
                               per_device_train_batch_size=2)}
    res["group"] = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
    res["tp2"] = port_train(tree_path, samples, f"{tmp}/tp2", tp=2,
                            per_device_train_batch_size=2)
    res["dp2"] = port_train(tree_path, samples, f"{tmp}/dp2", dp=2)
    return res


def elastic_world4(rank, world, tree_path, samples, tmp):
    """fsdp 4: the first 2 steps of the elastic run (resumed on fsdp 2 by
    elastic_world2) and an unbroken 4-step run; dp2 × tp2."""
    res = {"el_head": port_train(tree_path, samples, f"{tmp}/elastic", max_steps=2, fsdp=4)}
    if rank == 0:  # elastic_world2 resumes it from here
        open(f"{tmp}/elastic/head_done", "w").close()
    res["ref"] = port_train(tree_path, samples, f"{tmp}/fsdp4", fsdp=4)
    res["dp2tp2"] = port_train(tree_path, samples, f"{tmp}/dp2tp2", dp=2, tp=2)
    return res


def elastic_world2(rank, world, tree_path, samples, tmp):
    """The utils/dist helpers, the sharded clip, the sharded checkpoint and
    the elastic resume on fsdp 2 (test_torch_elastic.py compares)."""
    import time

    from streammind_torch.train import trainer as ttr
    from streammind_torch.utils import checkpoint as tckpt

    res = {}
    # the helpers
    res["dist"] = (tdist.size(), tdist.rank(), tdist.is_master(), tdist.allgather_object(
        {"r": rank}), tdist.allreduce_mean(float(rank)), tdist.shard_worklist(list(range(5))),
        tdist.master_only(lambda: "ran")())
    # the clip over shards: norm and one AdamW step against the whole tree's
    full = torch.load(tree_path)["text"]
    g = torch.Generator().manual_seed(0)
    grads = {f"text.{p}": torch.randn(t.shape, generator=g)
             for p, t in ttr.named_leaves(full).items()}
    params = {f"text.{p}": t.clone() for p, t in ttr.named_leaves(full).items()}
    opt = ttr.make_optimizer(1e-2, grad_clip=0.5)
    whole = {k: v.clone() for k, v in params.items()}
    opt.update(grads, opt.init(whole), whole)
    clip = {}
    for shape in ((1, 2, 1), (1, 1, 2)):
        mesh = tmesh.make_mesh(*shape)
        cut = {k: tpart.local_shard(v, tpart.spec_for(k, v.dim()), tmesh.mesh_shape(mesh),
                                    tpart.mesh_coords(mesh), k) for k, v in grads.items()}
        mine = {k: tpart.local_shard(v.clone(), tpart.spec_for(k, v.dim()),
                                     tmesh.mesh_shape(mesh), tpart.mesh_coords(mesh), k)
                for k, v in params.items()}
        sopt = ttr.make_optimizer(1e-2, grad_clip=0.5)
        sopt.mesh = mesh
        sopt.update(cut, sopt.init(mine), mine)
        back = {k: tpart.gather_leaf(v, k, v.dim(), mesh) for k, v in mine.items()}
        clip[shape] = (float(ttr.sharded_global_norm(cut, mesh)),
                       max(float((back[k] - whole[k]).abs().max()) for k in whole),
                       float(ttr.global_norm(cut.values())))
        # the sharded checkpoint: each rank writes and reads its own shards
        local = tpart.shard_params(torch.load(tree_path), mesh)
        tckpt.save_tree_sharded(f"{tmp}/dcp{shape[1]}{shape[2]}", local, mesh)
        blank = tpart._walk(local, lambda p, t: torch.zeros_like(t))
        back = tckpt.load_tree_sharded(f"{tmp}/dcp{shape[1]}{shape[2]}", blank, mesh)
        res[("dcp", shape)] = all(torch.equal(a, b) for a, b in
                                  zip(_flat(local).values(), _flat(back).values()))
    res["clip"] = (float(ttr.global_norm(grads.values())), clip)
    deadline = time.time() + 240  # elastic_world4 runs beside this world
    while not os.path.exists(f"{tmp}/elastic/head_done") and time.time() < deadline:
        time.sleep(0.2)
    res["el_tail"] = port_train(tree_path, samples, f"{tmp}/elastic", fsdp=2)
    return res


def score_samples(n=4):
    """test_train_run.FakeScoreDataset's samples through the port's
    preprocessing (MatchTime-shaped, random pixels, seed 0)."""
    from sp_like_tokenizer import SPLikeTokenizer
    from streammind_torch.data.preprocess import build_score_sample

    cfg, tok = tconfig.tiny_streammind_config(), SPLikeTokenizer()
    rng = np.random.default_rng(0)
    samples = []
    for i in range(n):
        s = build_score_sample("</s>" if i % 2 else "a goal is scored", f"v{i}.mkv", 1,
                               100 + i, tok)
        s["video"] = rng.standard_normal(
            (3 + i, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
        samples.append(s)
    return samples


class ShapeOnlyMesh:
    """A mesh that names its axis sizes and nothing else: for the checks
    made before any collective (a mesh's fit, the flash policy)."""

    mesh_dim_names = tmesh.AXES

    def __init__(self, dp=1, fsdp=1, tp=1):
        self.sizes = (dp, fsdp, tp)

    def size(self, mesh_dim=None):
        return self.sizes[mesh_dim]


def test_flash_mesh_policy():
    """Under any mesh 'flash' and 'flash!' run flash_mha_sharded on the
    rank's local q, k, v (the global shape never sends them to the plain
    path, and nothing warns); local heads that no GQA group pairs raise."""
    import warnings

    from streammind_torch.ops import attention as A

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (4, 2, 2))
    ref = A.mha_reference(q, k, v, causal=True)
    for mesh in (ShapeOnlyMesh(tp=3), ShapeOnlyMesh(tp=4), ShapeOnlyMesh(dp=2, tp=2)):
        for impl in ("flash", "flash!"):
            calls = A.flash_mha_sharded.calls
            with tmesh.set_mesh(mesh), warnings.catch_warnings():
                warnings.simplefilter("error")
                out = A.attention(q, k, v, causal=True, impl=impl)
            assert A.flash_mha_sharded.calls == calls + 1, (mesh.sizes, impl)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    with tmesh.set_mesh(ShapeOnlyMesh(tp=2)):
        for impl in ("flash", "flash!"):
            with pytest.raises(ValueError, match="do not group"):
                A.attention(q[:, :, :3], k, v, causal=True, impl=impl)


def test_trivial_mesh_engine_is_the_meshless_engine():
    """A (1,1,1) mesh (no process group: the local mesh) fuses the ViT's
    q/k/v and the decoder's q/k/v and gate/up as no mesh does, and its
    two-turn session is the meshless engine's, bitwise."""
    from streammind_torch.constants import VIDEO_TOKEN_INDEX
    from streammind_torch.models.meta import init_streammind_params
    from streammind_torch.streaming import StreamMindEngine, StreamSession

    cfg = tconfig.tiny_streammind_config()
    params = init_streammind_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    frames = torch.randn((4, 1, 3, cfg.vision.image_size, cfg.vision.image_size),
                         generator=torch.Generator().manual_seed(4))
    out = {}
    for name, mesh in (("meshless", None), ("mesh", tmesh.make_mesh(1, 1, 1, "cpu"))):
        eng = StreamMindEngine(params, cfg, eos_token_id=2, prefill_buckets=(32, 64),
                               device="cpu", mesh=mesh)
        layers = eng.params["text"]["layers"]
        s = StreamSession(eng, FakeTokenizer(), prompt_ids=[1, 10, 11, VIDEO_TOKEN_INDEX, 12],
                          max_new_tokens=8, gate_threshold=2.0)
        texts = [s.process_frame(f, force_fire=i in (1, 3)) for i, f in enumerate(frames)]
        out[name] = ("qkv" in eng.params["vision"]["layers"], "qkv" in layers,
                     "gateup" in layers["mlp"], texts, s.state.memory, s.cache.k)
    a, b = out["meshless"], out["mesh"]
    assert a[:4] == b[:4] == (True, True, True, a[3]) and any(a[3])
    assert torch.equal(a[4], b[4]) and torch.equal(a[5], b[5])
