"""The port's data-parallel train steps against the reference's, over two
gloo ranks on the CPU.

The reference runs once, in a subprocess with two XLA host devices (the
device count is fixed before jax starts, as ``tests/test_dist.py:21-28``
runs it): smollm-135m-smoke from ``PRNGKey(0)``, SGD momentum 0.9 at lr
0.05, four (16, 32) Markov batches (seed 2):
``make_dp_shardmap_train_step`` over a 2-device ``data`` mesh with
``compress_bits`` 8 and 0, and the single-device ``make_train_step`` on the
whole batch, float and int8 QAT, plus ``make_eval_step`` on batch 0.  Its
parameters, batches, losses and per-step parameters go to an ``.npz``.

One launch of two ranks runs the port from those parameters
(``repro_torch.convert``'s layout, leaf by leaf) on those batches:

* ``make_dp_shardmap_train_step``: the losses at rtol 1e-5 at every step;
  without compression every parameter at rtol 1e-5 (plus 1e-7 absolute,
  for elements near zero); with it, at most ``QAT_FLIP_SHARE`` of the
  elements beyond that, for a code that a sum in another order puts on
  the other side of a grid edge;
* ``make_train_step(mesh=)`` on the data mesh follows the reference's
  *single-device* step on the whole batch (the reference's own 4 x 2 test
  of its sharded step is red): float at rtol 1e-5 for four steps; int8 QAT
  (its activation ranges the group's, as the whole batch's are) at the QAT
  tolerances of ``tests/test_torch_train.py`` for the first step and at
  rtol 1e-5 of the port's own single-device step for all four;
* a batch whose labels are masked unevenly between the ranks (each slice
  weighs by its share of the scored tokens), one float step without and
  with ``microbatch_split=2``, at rtol 1e-5 of the single device's;
* ``make_eval_step(mesh=)``: the whole batch's metrics;
* every step leaves both ranks with the same parameters, bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist_ranks import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
QAT_LOSS_RTOL = 1e-4
QAT_FLIP_SHARE = 1e-3

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.policy import QuantPolicy
from repro.data.pipeline import markov_batch_fn
from repro.models.registry import get_config
from repro.optim import sgd
from repro.train.trainer import make_dp_shardmap_train_step, make_eval_step, make_train_step

def flat(tree, prefix, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {f"{prefix}/{path}": np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix, f"{path}.{k}" if path else str(k)))
    return out

cfg = get_config("smollm-135m-smoke")
model = cfg.build(dtype=jnp.float32, remat="none")
opt = sgd(momentum=0.9)
params = model.init(jax.random.PRNGKey(0))
bf = markov_batch_fn(cfg.vocab, 16, 32, seed=2)
batches = [bf(s) for s in range(STEPS)]
out = flat(params, "params")
for s, b in enumerate(batches):
    out.update({f"batch/{s}/{k}": v for k, v in b.items()})
# labels masked unevenly: rank 0's half of each microbatch scores fewer tokens
masked = {k: v.copy() for k, v in batches[0].items()}
masked["labels"][0, :20] = -1
masked["labels"][1, 3:9] = -1
masked["labels"][9, :31] = -1
out.update({f"masked/{k}": v for k, v in masked.items()})

def fresh():
    return {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}

mesh = jax.make_mesh((2,), ("data",))
runs = {"dp8": make_dp_shardmap_train_step(model, opt, 0.05, mesh, compress_bits=8),
        "dp0": make_dp_shardmap_train_step(model, opt, 0.05, mesh),
        "mesh_float": jax.jit(make_train_step(model, opt, 0.05)),
        "mesh_qat": jax.jit(make_train_step(model, opt, 0.05, policy=QuantPolicy.int8_qat()))}
for name, step in runs.items():
    state = fresh()
    for s, b in enumerate(batches):
        state, m = step(state, b)
        out[f"{name}/{s}/loss"] = np.asarray(m["loss"])
        out[f"{name}/{s}/accuracy"] = np.asarray(m["accuracy"])
        out.update(flat(state["params"], f"{name}/{s}/params"))
for name, step in (("mesh_masked", runs["mesh_float"]),
                   ("mesh_masked_micro",
                    jax.jit(make_train_step(model, opt, 0.05, microbatch_split=2)))):
    state, m = step(fresh(), masked)
    out[f"{name}/0/loss"] = np.asarray(m["loss"])
    out[f"{name}/0/accuracy"] = np.asarray(m["accuracy"])
    out.update(flat(state["params"], f"{name}/0/params"))
ev = jax.jit(make_eval_step(model))(params, batches[0])
out.update({f"eval/{k}": np.asarray(v) for k, v in ev.items()})
np.savez(sys.argv[1], **out)
print("reference ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, the two ranks' results)."""
    d = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = textwrap.dedent(_REFERENCE).replace("STEPS", str(STEPS))
    r = subprocess.run([sys.executable, "-c", code, str(d / "reference.npz")],
                       capture_output=True, text=True, env=env, timeout=420)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = dict(np.load(d / "reference.npz"))
    return ref, launch(2, "dp", d / "reference.npz", d)


def _params(res, prefix):
    """{dotted path: array} of one run's parameters after one step."""
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _param_misses(got, want, rtol=1e-5, atol=1e-7):
    assert sorted(got) == sorted(want)
    misses = sum(int((np.abs(got[k] - want[k]) > atol + rtol * np.abs(want[k])).sum())
                 for k in want)
    return misses, sum(v.size for v in want.values())


@pytest.mark.parametrize("name", ["dp8", "dp0"])
def test_dp_shardmap_step_matches_the_reference(runs, name):
    ref, ranks = runs
    flips = QAT_FLIP_SHARE if name == "dp8" else 0.0
    for s in range(STEPS):
        np.testing.assert_allclose(ranks[0][f"{name}/{s}/loss"], ref[f"{name}/{s}/loss"],
                                   rtol=1e-5)
        misses, total = _param_misses(_params(ranks[0], f"{name}/{s}/params"),
                                      _params(ref, f"{name}/{s}/params"))
        assert misses <= flips * total, f"step {s}: {misses} of {total} parameters differ"


def test_data_mesh_float_step_follows_the_single_device_step(runs):
    """Four float steps at rtol 1e-5 of the reference's single-device step
    on the whole batch (its own 4 x 2 sharded-step test is red, so the
    single device is the yardstick)."""
    ref, ranks = runs
    for s in range(STEPS):
        np.testing.assert_allclose(ranks[0][f"mesh_float/{s}/loss"],
                                   ref[f"mesh_float/{s}/loss"], rtol=1e-5)
        misses, total = _param_misses(_params(ranks[0], f"mesh_float/{s}/params"),
                                      _params(ref, f"mesh_float/{s}/params"))
        assert misses == 0, f"step {s}: {misses} of {total} parameters differ"


@pytest.mark.parametrize("name", ["mesh_masked", "mesh_masked_micro"])
def test_data_mesh_step_weighs_each_slice_by_its_scored_tokens(runs, name):
    """Labels masked unevenly between the ranks' slices (and, with
    ``microbatch_split=2``, between each microbatch's halves): the loss,
    accuracy and parameters of one step still follow the single device's
    step on the whole batch at rtol 1e-5."""
    ref, ranks = runs
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(ranks[0][f"{name}/0/{k}"], ref[f"{name}/0/{k}"], rtol=1e-5)
    misses, total = _param_misses(_params(ranks[0], f"{name}/0/params"),
                                  _params(ref, f"{name}/0/params"))
    assert misses == 0, f"{misses} of {total} parameters differ"


def test_data_mesh_qat_step_follows_the_single_device_step(runs):
    """int8 QAT: the first step at the QAT tolerances of the reference's
    single-device step, and all four at rtol 1e-5 of the port's own
    single-device step on the whole batch (the group's activation ranges
    are the whole batch's).  From the second step on, one device of the
    port and the reference part by their flipped codes alone (38,329 of
    106,816 parameters beyond rtol 1e-5 after step 1 with or without the
    mesh), so the port's single device is the yardstick there."""
    import torch

    from _torch_dist_ranks import flatten, from_flat
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models.registry import get_config
    from repro_torch.optim import sgd
    from repro_torch.train import trainer

    ref, ranks = runs
    np.testing.assert_allclose(ranks[0]["mesh_qat/0/loss"], ref["mesh_qat/0/loss"],
                               rtol=QAT_LOSS_RTOL)
    misses, total = _param_misses(_params(ranks[0], "mesh_qat/0/params"),
                                  _params(ref, "mesh_qat/0/params"))
    assert misses <= QAT_FLIP_SHARE * total, f"{misses} of {total} parameters differ"

    model, opt = get_config("smollm-135m-smoke").build(), sgd(momentum=0.9)
    params = from_flat(ref, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    step = trainer.make_train_step(model, opt, 0.05, policy=QuantPolicy.int8_qat())
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    for s in range(STEPS):
        state, mets = step(state, {f: ref[f"batch/{s}/{f}"] for f in ("tokens", "labels")})
        np.testing.assert_allclose(ranks[0][f"mesh_qat/{s}/loss"], mets["loss"].item(),
                                   rtol=1e-5)
        one = {k: v.numpy() for k, v in flatten(state["params"]).items()}
        misses, total = _param_misses(_params(ranks[0], f"mesh_qat/{s}/params"), one)
        assert misses == 0, f"step {s}: {misses} of {total} parameters differ"


def test_data_mesh_eval_step_gives_the_whole_batchs_metrics(runs):
    ref, ranks = runs
    for k in ("loss", "nll", "aux", "accuracy"):
        for r in ranks:
            np.testing.assert_allclose(r[f"eval/{k}"], ref[f"eval/{k}"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["dp8", "dp0", "mesh_float", "mesh_qat", "mesh_masked",
                                  "mesh_masked_micro"])
def test_every_step_leaves_the_ranks_identical(runs, name):
    _, (r0, r1) = runs
    for s in range(1 if name.startswith("mesh_masked") else STEPS):
        a, b = _params(r0, f"{name}/{s}/params"), _params(r1, f"{name}/{s}/params")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert r0[f"{name}/{s}/loss"] == r1[f"{name}/{s}/loss"]


def test_compressed_step_keeps_each_ranks_own_residual(runs):
    """The error-feedback residual is per-rank state: the two ranks' slices
    leave different residuals, and the exact step keeps none."""
    _, (r0, r1) = runs
    e0, e1 = _params(r0, "dp8/err"), _params(r1, "dp8/err")
    assert e0 and sorted(e0) == sorted(e1)
    assert any(not np.array_equal(e0[k], e1[k]) for k in e0)
    assert not any(k.startswith("dp0/err") for k in r0)
