"""The port's multi-process training against the JAX package's, on the CPU.

``train()`` on the llm stage (4 steps, fp32) on a spawned world of 2
(``test_torch_parallel.train_world2``) that train() itself starts from a
launcher's variables, as under torchrun: fsdp 2, tp 2 and dp 2, each at a
global batch of 2 (a per-device batch of 2 on fsdp 2 and tp 2, of 1 on dp
2).  Each run's logged losses equal JAX's ``train()`` on its fsdp-2 mesh
at a per-device batch of 2, and the port's one-process run at a
per-device batch of 2, at 1e-4 / 1e-5.  Both packages start from one
tree, drawn by the port from a seed (JAX's ``init_streammind_params`` is
patched to return it).  One JAX run, beside the gloo world: a JAX
``train()`` takes ~35 CPU-seconds cold and ~18 warm, so a run a mesh
shape would put the file over its minute on a loaded worker.  JAX's
TensorBoard sink runs on tensorboard's own TensorFlow stub.  The elastic
resume, dp2 × tp2, the sharded clip, ``utils/dist`` and the sharded
checkpoint are in test_torch_elastic.py.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from sp_like_tokenizer import SPLikeTokenizer
from test_torch_parallel import port_train, save_tree, start_world, train_world2
from test_train_run import FakeScoreDataset, _args
from streammind_torch import config as tconfig
from streammind_torch.models.meta import init_streammind_params

LOSS = dict(rtol=1e-4, atol=1e-5)


def _jax_losses(tmp, tree_path, **mesh):
    """JAX's train() from the tree at ``tree_path``; the logged losses."""
    # tensorboard's documented switch to its TensorFlow stub
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("notf"))
    import jax
    import jax.numpy as jnp

    from streammind_tpu.config import tiny_streammind_config
    from streammind_tpu.train import run as jrun

    cfg = tiny_streammind_config()
    tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), torch.load(tree_path))
    real = jrun.init_streammind_params
    jrun.init_streammind_params = lambda *a, **k: tree
    try:
        ma, da, ta = _args(tmp, "llm")
        jrun.train(ma, da, dataclasses.replace(ta, **mesh),
                   dataset=FakeScoreDataset(SPLikeTokenizer(), cfg), cfg=cfg)
    finally:
        jrun.init_streammind_params = real
    with open(os.path.join(str(tmp), "logs", "metrics.jsonl")) as f:
        return [json.loads(line)["train/loss"] for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    tree = save_tree(init_streammind_params(torch.Generator().manual_seed(42),
                                            tconfig.tiny_streammind_config(), device="cpu"),
                     tmp / "tree.pt")
    samples = FakeScoreDataset(SPLikeTokenizer(), tconfig.tiny_streammind_config()).samples
    w2 = start_world(train_world2, 2, tmp, tree, samples, str(tmp), env=True)
    jax_losses = _jax_losses(tmp / "j_fsdp2", tree, fsdp=2, per_device_train_batch_size=2)
    one = port_train(tree, samples, tmp / "one_b2", per_device_train_batch_size=2)
    return w2.result(), jax_losses, one


@pytest.mark.parametrize("run", ["fsdp2", "tp2", "dp2"])
def test_mesh_training_matches_one_device_and_jax(runs, run):
    """A global batch of 2 a step: each mesh run takes the losses of JAX's
    train() on its fsdp-2 mesh at a per-device batch of 2 (the same mesh
    shape for fsdp 2; for dp 2, the per-device batch its two ranks make)
    and of the one-process port run at a per-device batch of 2."""
    r2, jax_losses, one = runs
    losses = r2[run]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, one, **LOSS)
    np.testing.assert_allclose(losses, jax_losses, **LOSS)


def test_train_starts_the_process_group_from_the_environment(runs):
    """No rank started a group: train() read WORLD_SIZE, RANK, MASTER_ADDR
    and MASTER_PORT (what torchrun sets) and started gloo for the CPU."""
    r2, _, _ = runs
    assert r2["group"] == ("gloo", 2, 0)
