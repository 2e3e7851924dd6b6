"""``repro_torch.train.checkpoint.CheckpointManager`` on the four behaviours
of tests/test_system.py:161-227 (exact resume after a simulated preemption,
atomic writes and retention, a dtype cast on restore, the asynchronous
save), plus restore onto another device's tree, a missing leaf, and the
conversion of optimizer states between the packages
(``repro_torch.convert``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import markov_batch_fn
from repro_torch.models.registry import get_config
from repro_torch.nn.module import tree_leaves
from repro_torch.optim import adamw, sgd
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import init_train_state, make_train_step

torch.set_num_threads(2)


def test_checkpoint_restart_exact_resume(tmp_path):
    cfg = get_config("smollm-135m-smoke")
    model, opt = cfg.build(), sgd(momentum=0.9)
    fresh = lambda: init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")  # noqa: E731
    state = fresh()
    step_fn = make_train_step(model, opt, 0.01)
    bf = markov_batch_fn(cfg.vocab, 4, 32, seed=3)
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    losses = []
    for s in range(6):
        state, m = step_fn(state, bf(s))
        losses.append(m["loss"].item())
        if s == 2:
            ckpt.save(3, state)
    state2 = ckpt.restore(3, fresh())
    assert int(state2["step"]) == 3 and state2["step"].dtype == torch.int32
    for s in range(3, 6):
        state2, m2 = step_fn(state2, bf(s))
        assert abs(m2["loss"].item() - losses[s]) < 1e-5, s
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(state2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    ckpt.close()


def test_checkpoint_atomicity_and_retention(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones(3)}, "l": [torch.zeros(2, 2)]}
    for s in (1, 2, 3):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [2, 3]
    os.makedirs(os.path.join(str(tmp_path), "ck", "step_000000009.tmp"))   # a killed writer
    assert ckpt.latest_step() == 3
    restored = ckpt.restore(3, tree)
    assert torch.equal(restored["w"], tree["w"]) and torch.equal(restored["l"][0], tree["l"][0])
    with pytest.raises(KeyError, match="no leaf"):
        ckpt.restore(3, {"w": tree["w"], "missing": torch.zeros(1)})
    ckpt.close()


def test_restore_casts_onto_the_target_dtype_and_device(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(1, {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
                  "h": torch.ones(2, dtype=torch.bfloat16)})
    out = ckpt.restore(1, {"w": torch.empty(4, 4, dtype=torch.bfloat16, device="meta"),
                           "h": torch.empty(2, dtype=torch.float32)})
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(16, dtype=torch.bfloat16).reshape(4, 4))
    assert out["h"].dtype == torch.float32 and torch.equal(out["h"], torch.ones(2))
    step, latest = ckpt.restore_latest({"w": torch.empty(4, 4)})
    assert step == 1 and latest["w"].dtype == torch.float32
    ckpt.close()


def test_async_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    tree = {"w": torch.ones(128, 128)}
    fut = ckpt.save_async(7, tree)
    tree["w"].add_(1.0)                       # the snapshot is taken at the call
    fut.result()
    assert ckpt.latest_step() == 7
    assert torch.equal(ckpt.restore(7, tree)["w"], torch.ones(128, 128))
    ckpt.close()
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest({}) == (None, None)


def test_optimizer_state_converts_between_the_packages():
    """AdamW's {"m", "v", "t"} after one reference update carries across
    leaf for leaf, and params_to_numpy gives the same arrays back."""
    rng = np.random.default_rng(0)
    params = {"k": jnp.asarray(rng.normal(0, 1, (3, 4)), jnp.float32),
              "b": [jnp.zeros(4, jnp.float32)]}
    opt = j_adamw()
    _, jstate = opt.update(jax.tree_util.tree_map(jnp.ones_like, params),
                           opt.init(params), params, 0.1)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = params_from_numpy(np_state, "cpu")
    assert sorted(tstate) == sorted(adamw().init(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")))
    assert tstate["t"].dtype == torch.int32 and int(tstate["t"]) == 1
    back = params_to_numpy(tstate)
    for k in ("m", "v"):
        np.testing.assert_array_equal(back[k]["k"], np_state[k]["k"])
        np.testing.assert_array_equal(back[k]["b"][0], np_state[k]["b"][0])
