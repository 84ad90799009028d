"""The port's elastic and sharded-state training paths, on the CPU.

Spawned gloo worlds (``test_torch_parallel.elastic_world4`` /
``elastic_world2``, run side by side): the elastic resume of
``tests/test_elastic.py`` (2 steps of ``train()`` on fsdp 4, then a resume
on fsdp 2: steps 3-4 equal the unbroken fsdp-4 run's, params and optimizer
state resharded from the gathered checkpoint); dp2 × tp2 over 4 ranks
against the one-process run at the same global batch; the global-norm
clip over shards against the whole tree's (norm and one AdamW step); the
``utils/dist`` helpers at world 2; and the sharded checkpoint
(``torch.distributed.checkpoint``) read back bitwise on two meshes and at
world size 1.  The port's own tree and samples: these meshes' losses
against JAX's are test_torch_dist_train.py's.
"""
import numpy as np
import pytest
import torch

from test_torch_parallel import (
    _flat,
    elastic_world2,
    elastic_world4,
    port_train,
    save_tree,
    score_samples,
    start_world,
)
from streammind_torch import config as tconfig
from streammind_torch.models.meta import init_streammind_params
from streammind_torch.utils import checkpoint as tckpt

LOSS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    tree = save_tree(init_streammind_params(torch.Generator().manual_seed(42),
                                            tconfig.tiny_streammind_config(), device="cpu"),
                     tmp / "tree.pt")
    samples = score_samples()
    w4 = start_world(elastic_world4, 4, tmp, tree, samples, str(tmp))
    w2 = start_world(elastic_world2, 2, tmp, tree, samples, str(tmp))
    one = port_train(tree, samples, tmp / "one_b2", per_device_train_batch_size=2)
    return w4.result(), w2.result(), (tree, tmp, one)


def test_dp_tp_training_matches_one_device(runs):
    """dp2 × tp2: a global batch of 2, the one-process run's losses."""
    r4, _, (_, _, one) = runs
    assert len(r4["dp2tp2"]) == 4 and np.all(np.isfinite(r4["dp2tp2"]))
    np.testing.assert_allclose(r4["dp2tp2"], one, **LOSS)


def test_resume_on_smaller_mesh(runs):
    """2 steps on fsdp 4, "lose half the slice", resume on fsdp 2: steps 3-4
    equal the unbroken fsdp-4 run's (params and optimizer state resharded
    from the gathered checkpoint)."""
    r4, r2, _ = runs
    assert len(r4["ref"]) == 4 and len(r4["el_head"]) == 2 and len(r2["el_tail"]) == 4
    np.testing.assert_allclose(r2["el_tail"][:2], r4["el_head"], **LOSS)
    np.testing.assert_allclose(r2["el_tail"][-2:], r4["ref"][-2:], **LOSS)


def test_global_norm_clip_across_shards(runs):
    """The clip's norm from the shards equals the whole tree's (a per-rank
    norm does not), and one clipped AdamW step on the shards gathers to the
    whole tree's step."""
    _, r2, _ = runs
    whole, by_mesh = r2["clip"]
    for shape, (norm, step_err, per_rank) in by_mesh.items():
        np.testing.assert_allclose(norm, whole, rtol=1e-6)
        assert per_rank < whole * (1 - 1e-3), shape
        assert step_err < 1e-6, shape


def test_dist_helpers_at_world_2(runs):
    _, r2, _ = runs
    size, rank, master, gathered, mean, work, ran = r2["dist"]
    assert (size, rank, master) == (2, 0, True)
    assert gathered == [{"r": 0}, {"r": 1}] and mean == 0.5
    assert work == [0, 1, 2] and ran == "ran"


def test_sharded_checkpoint_round_trip(runs):
    _, r2, (tree, tmp, _) = runs
    assert r2[("dcp", (1, 2, 1))] and r2[("dcp", (1, 1, 2))]
    whole = torch.load(tree)  # world size 1: the whole tree, no process group
    tckpt.save_tree_sharded(str(tmp / "dcp1"), whole)
    back = tckpt.load_tree_sharded(str(tmp / "dcp1"), torch.load(tree))
    assert all(torch.equal(a, b) for a, b in zip(_flat(whole).values(), _flat(back).values()))
