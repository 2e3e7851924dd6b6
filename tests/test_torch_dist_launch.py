"""Elastic restore and ``launch.train --mesh D,1`` over gloo ranks on the
CPU (``tests/test_dist.py:194-217`` and ``tests/test_system.py``'s training
checks, on the port).

One launch of four ranks writes checkpoints 1 (``save``) and 2
(``save_async``) of a tree of float32 and int32 leaves: rank 0
alone writes, and every rank sees both committed after its barrier.  One
launch of two ranks then reads checkpoint 1 back and drives
``launch.train.main --mesh 2,1 --device cpu``: 20 steps of SGD 0.9 at lr
0.05 on (16, 32) Markov batches, whose loss must fall as
``test_launch_train_loss_falls`` asks; a 6-step run checkpointed every 3
steps; and the same run preempted after step 3's checkpoint.  This process
reads the tree at world 1 and resumes the preempted run under ``--mesh
1,1``, which must end within rtol 1e-5 of the uninterrupted ``--mesh 2,1``
run (float sums over the whole batch against two halves).
"""
import numpy as np
import pytest
import torch

from _torch_dist_ranks import flatten, launch
from repro_torch.launch import train as t_launch
from repro_torch.train.checkpoint import CheckpointManager


def _tree():
    rng = np.random.default_rng(0)
    return {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "h": rng.normal(size=(5, 3)).astype(np.float32),
            "i": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(7,), dtype=np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    inputs = {f"tree/{k}": v for k, v in _tree().items()}
    inputs.update(dir=str(d / "tree"), whole=str(d / "whole"), cut=str(d / "cut"))
    np.savez(d / "inputs.npz", **inputs)
    written = launch(4, "ckpt_write", d / "inputs.npz", d)
    ranks = launch(2, "launch", d / "inputs.npz", d)
    return d, written, ranks


def test_only_rank_zero_writes_and_every_rank_waits_for_it(runs):
    _, written, _ = runs
    for r in written:
        assert list(r["seen_after_save"]) == [1]
        assert list(r["seen_after_close"]) == [1, 2]


@pytest.mark.parametrize("world", [2, 1])
def test_a_tree_written_at_world_4_restores_bit_for_bit(runs, world):
    d, _, ranks = runs
    want = _tree()
    if world == 2:
        got = [{k: r[f"restored/{k}"] for k in want} for r in ranks]
    else:
        target = {k: torch.from_numpy(v).new_empty(0) for k, v in want.items()}
        got = [{k: v.numpy() for k, v in CheckpointManager(str(d / "tree"))
                .restore(1, target).items()}]
    for tree in got:
        for k, v in want.items():
            assert tree[k].dtype == v.dtype
            np.testing.assert_array_equal(tree[k], v)
    step2 = CheckpointManager(str(d / "tree")).restore(
        2, {k: torch.from_numpy(v) for k, v in want.items()})
    np.testing.assert_array_equal(step2["w"].numpy(), want["w"] + 1)


def test_launch_train_mesh_2_1_loss_falls(runs):
    _, _, ranks = runs
    losses = ranks[0]["learn/losses"]
    assert len(losses) == 20 and losses[-1] < losses[0] - 0.15, losses
    np.testing.assert_array_equal(ranks[1]["learn/losses"], losses)
    for k in ranks[0]:
        if k.startswith("learn/params/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_a_mesh_2_1_checkpoint_resumes_under_mesh_1_1(runs, capsys):
    """Preempted after step 3's checkpoint under ``--mesh 2,1``, resumed
    under ``--mesh 1,1``: the final parameters within rtol 1e-5 of the
    uninterrupted ``--mesh 2,1`` run's, and its step-6 checkpoint holds
    them."""
    d, _, ranks = runs
    assert ranks[0]["cut/preempted"] and ranks[1]["cut/preempted"]
    assert CheckpointManager(str(d / "cut")).latest_step() == 3
    args = ["--arch", "smollm-135m-smoke", "--device", "cpu", "--mesh", "1,1",
            "--optimizer", "sgd", "--lr", "0.05", "--steps", "6", "--batch", "4",
            "--seq", "16", "--ckpt-every", "3", "--ckpt-dir", str(d / "cut")]
    resumed = t_launch.main(args)
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert int(resumed["step"]) == 6
    whole = {k[len("whole/params/"):]: v for k, v in ranks[0].items()
             if k.startswith("whole/params/")}
    got = {k: v.numpy() for k, v in flatten(resumed["params"]).items()}
    assert sorted(got) == sorted(whole)
    for k, v in whole.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7)
    saved = flatten(CheckpointManager(str(d / "whole")).restore(6, resumed)["params"])
    for k, v in whole.items():
        np.testing.assert_array_equal(saved[k].numpy(), v)
