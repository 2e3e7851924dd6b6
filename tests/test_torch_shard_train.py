"""The port's sharded train step (parameters over ``data`` and ``model``)
against the reference's single-device step, over gloo ranks on the CPU.

The reference's own sharded test
(``tests/test_dist.py::test_sharded_train_step_matches_single_device``) is
red under the installed jax 0.9.0: its ``Embedding.apply`` raises
``ShardingTypeError`` in ``jnp.take`` (``src/repro/nn/layers.py:352``) on
a table sharded over ``data`` and ``model``.  So the yardstick here is the
target that test names, the reference's single-device ``make_train_step``
on the whole batch.  It runs once in a subprocess: smollm-135m-smoke from
``PRNGKey(0)``, SGD momentum 0.9 at lr 0.05, four (16, 32) Markov batches
(seed 2, those of ``tests/test_torch_dist_train.py``),
float, int8 QAT and ``int8_weight_gather``, and ``fake_int8_weights`` of
the initial parameters.

One launch of four ranks (mesh (2, 2)) and one of two (mesh (1, 2)) run
the port from those parameters, cut by ``param_pspecs``:

* float: the loss and every parameter at rtol 1e-5 (atol 1e-7) after every
  step; ``int8_weight_gather`` likewise;
* int8 QAT: step 0 at the QAT tolerances of ``tests/test_torch_train.py``
  against the reference, every step at those tolerances against the
  port's own single-device step (from step 1 on, one device of the port
  and the reference part by flipped codes alone);
* the int8 codes of ``int8_weight_gather``, gathered and dequantized, bit
  for bit the reference's ``fake_int8_weights``;
* every rank's shards are the blocks the reference's ``param_pspecs``
  gives it of the whole leaf, and a replicated leaf is identical on every
  rank;
* phi3.5-moe-smoke at (2, 2), two float steps, against the port's single
  process with two routing groups (each data rank routes its own rows as
  one group) at rtol 1e-5;
* elastic: ``launch.train.main --mesh 2,2`` checkpointed at step 3 resumes
  under ``--mesh 1,2`` (two ranks) and ``--mesh 1,1`` (this process) and
  ends within rtol 1e-5 of the uninterrupted run;
* glm4-9b-smoke with nonzero QKV biases at (2, 2) (a stacked bias is cut
  over ``data`` and ``model`` like a kernel, and ``Dense`` gathers its
  columns): two float steps against the port's single process at rtol
  1e-5, and ``ServeEngine(mesh=).generate`` (int8 weights and KV) giving
  the single process's tokens.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dist_ranks import biased_model, flatten, from_flat, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
QAT_LOSS_RTOL = 1e-4
QAT_FLIP_SHARE = 1e-3
WORLDS = {4: (2, 2), 2: (1, 2)}

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.integerize import fake_int8_weights
from repro.core.policy import QuantPolicy
from repro.data.pipeline import markov_batch_fn
from repro.models.registry import get_config
from repro.optim import sgd
from repro.train.trainer import make_train_step

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
out.update(flat(jax.jit(fake_int8_weights)(params), "i8codes"))
for s, b in enumerate(batches):
    out.update({f"batch/{s}/{k}": v for k, v in b.items()})
for name, kw in (("float", {}), ("qat", {"policy": QuantPolicy.int8_qat()}),
                 ("i8", {"int8_weight_gather": True})):
    step = jax.jit(make_train_step(model, opt, 0.05, **kw))
    state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    for s, b in enumerate(batches):
        state, m = step(state, b)
        out[f"{name}/{s}/loss"] = np.asarray(m["loss"])
        out.update(flat(state["params"], f"{name}/{s}/params"))
np.savez(sys.argv[1], **out)
print("reference ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, {world: the ranks' results}, the directory)."""
    d = tmp_path_factory.mktemp("shard")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = textwrap.dedent(_REFERENCE).replace("STEPS", str(STEPS))
    r = subprocess.run([sys.executable, "-c", code, str(d / "reference.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = dict(np.load(d / "reference.npz"))
    inputs = {k: v for k, v in ref.items() if k.startswith(("params/", "batch/"))}
    inputs.update(whole=str(d / "whole"), cut=str(d / "cut"), cut2=str(d / "cut2"))
    np.savez(d / "inputs.npz", **inputs)
    ranks = {world: launch(world, "shard", d / "inputs.npz", d) for world in (4, 2)}
    return ref, ranks, d


def _params(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _misses(got, want, rtol=1e-5, atol=1e-7):
    assert sorted(got) == sorted(want)
    misses = sum(int((np.abs(got[k] - want[k]) > atol + rtol * np.abs(want[k])).sum())
                 for k in want)
    return misses, sum(v.size for v in want.values())


def _specs(world):
    """The reference's spec of every parameter leaf at this world's mesh,
    keyed by the dotted path."""
    import jax

    from repro.dist import sharding as shd
    from repro.dist.compat import abstract_mesh
    from repro.models.registry import get_config

    mesh = abstract_mesh(WORLDS[world], ("data", "model"))
    model = get_config("smollm-135m-smoke").build(remat="none")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = shd.param_pspecs(shapes, mesh, shd.make_axis_rules(mesh))
    return {k: tuple(v.spec) for k, v in flatten(specs).items()}


def _assemble(ranks, prefix, world):
    """The whole leaves from every rank's shards, each rank's block placed
    where the reference's spec puts it; blocks that the spec replicates
    must be equal."""
    dm, mm = WORLDS[world]
    sizes = {"data": dm, "model": mm}
    out = {}
    for key, spec in _specs(world).items():
        blocks = [r[f"{prefix}/{key}"] for r in ranks]
        shape = list(blocks[0].shape)
        for d, e in enumerate(spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shape[d] *= sizes[a]
        whole = np.full(shape, np.nan, dtype=blocks[0].dtype)
        seen = {}
        for rank, block in enumerate(blocks):
            coord = {"data": rank // mm, "model": rank % mm}
            index = []
            for d, e in enumerate(spec):
                idx = 0
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    idx = idx * sizes[a] + coord[a]
                n = block.shape[d]
                index.append(slice(idx * n, (idx + 1) * n))
            index = tuple(index) + (slice(None),) * (block.ndim - len(index))
            where = tuple((s.start, s.stop) for s in index)
            if where in seen:
                np.testing.assert_array_equal(block, seen[where],
                                              err_msg=f"{key}: replicated blocks differ")
            seen[where] = block
            whole[index] = block
        assert not np.isnan(whole).any(), f"{key}: the ranks' blocks do not cover the leaf"
        out[key] = whole
    return out


@pytest.mark.parametrize("world", [4, 2])
def test_every_rank_holds_its_specs_blocks(runs, world):
    """Each rank's shard of every leaf is the block of the whole leaf that
    the reference's ``param_pspecs`` gives its mesh coordinate: the ranks'
    blocks tile the single-device parameters of step 0 and replicated
    blocks agree bit for bit."""
    ref, ranks, _ = runs
    whole = _assemble(ranks[world], "float/0/params", world)
    misses, total = _misses(whole, _params(ref, "float/0/params"))
    assert misses == 0, f"{misses} of {total} parameters differ"


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("name", ["float", "i8"])
def test_sharded_step_follows_the_single_device_step(runs, world, name):
    ref, ranks, _ = runs
    for s in range(STEPS):
        for r in ranks[world]:
            np.testing.assert_allclose(r[f"{name}/{s}/loss"], ref[f"{name}/{s}/loss"], rtol=1e-5)
        misses, total = _misses(_assemble(ranks[world], f"{name}/{s}/params", world),
                                _params(ref, f"{name}/{s}/params"))
        assert misses == 0, f"step {s}: {misses} of {total} parameters differ"


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_qat_step_follows_the_single_device_step(runs, world):
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models.registry import get_config
    from repro_torch.optim import sgd
    from repro_torch.train import trainer

    ref, ranks, _ = runs
    np.testing.assert_allclose(ranks[world][0]["qat/0/loss"], ref["qat/0/loss"],
                               rtol=QAT_LOSS_RTOL)
    misses, total = _misses(_assemble(ranks[world], "qat/0/params", world),
                            _params(ref, "qat/0/params"))
    assert misses <= QAT_FLIP_SHARE * total, f"{misses} of {total} parameters differ"

    model, opt = get_config("smollm-135m-smoke").build(), sgd(momentum=0.9)
    params = from_flat(ref, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    step = trainer.make_train_step(model, opt, 0.05, policy=QuantPolicy.int8_qat())
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    for s in range(STEPS):
        state, mets = step(state, {f: ref[f"batch/{s}/{f}"] for f in ("tokens", "labels")})
        np.testing.assert_allclose(ranks[world][0][f"qat/{s}/loss"], mets["loss"].item(),
                                   rtol=QAT_LOSS_RTOL)
        one = {k: v.numpy() for k, v in flatten(state["params"]).items()}
        misses, total = _misses(_assemble(ranks[world], f"qat/{s}/params", world), one)
        assert misses <= QAT_FLIP_SHARE * total, f"step {s}: {misses} of {total} differ"


@pytest.mark.parametrize("world", [4, 2])
def test_sharded_eval_step_gives_the_whole_batchs_metrics(runs, world):
    """``make_eval_step(mesh=, axis_rules=)`` on the cut parameters: every
    rank the port's one-device metrics on the whole batch 0."""
    from repro_torch.models.registry import get_config
    from repro_torch.train import trainer

    ref, ranks, _ = runs
    model = get_config("smollm-135m-smoke").build()
    params = from_flat(ref, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    want = trainer.make_eval_step(model)(params, {f: ref[f"batch/0/{f}"]
                                                  for f in ("tokens", "labels")})
    for r in ranks[world]:
        for k, v in want.items():
            np.testing.assert_allclose(r[f"eval/{k}"], v.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", [4, 2])
def test_int8_weight_gather_codes_are_the_single_devices(runs, world):
    """The int8 codes cross the wire and are dequantized after the
    gather: bit for bit the reference's ``fake_int8_weights`` on one
    device (each exponent from the max over every rank of its reduction)."""
    ref, ranks, _ = runs
    want = _params(ref, "i8codes")
    for r in ranks[world]:
        got = _params(r, "i8codes")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_moe_routing_groups_follow_the_single_process(runs):
    """phi3.5-moe-smoke at (2, 2): each data rank routes its rows as one
    group, experts cut over ``model``; two float steps at rtol 1e-5 of the
    port's single process with two routing groups."""
    _, ranks, _ = runs
    r0 = ranks[4][0]
    for s in range(2):
        np.testing.assert_allclose(r0[f"phi/{s}/loss"], r0[f"phi_one/{s}/loss"], rtol=1e-5)
    misses, total = _misses(_params(r0, "phi/params"), _params(r0, "phi_one/params"))
    assert misses == 0, f"{misses} of {total} parameters differ"


@pytest.mark.parametrize("resume", ["1,2", "1,1"])
def test_a_2x2_checkpoint_resumes_under_another_mesh(runs, resume):
    _, ranks, d = runs
    whole = _params(ranks[4][0], "whole/params")
    assert bool(ranks[4][0]["cut/preempted"])
    if resume == "1,2":
        got = _params(ranks[2][0], "resume12/params")
    else:
        from repro_torch.launch import train as t_launch

        state = t_launch.main(["--arch", "smollm-135m-smoke", "--device", "cpu", "--mesh", "1,1",
                               "--optimizer", "sgd", "--lr", "0.05", "--steps", "6", "--batch",
                               "8", "--seq", "16", "--ckpt-every", "3",
                               "--ckpt-dir", str(d / "cut2")])
        got = {k: v.numpy() for k, v in flatten(state["params"]).items()}
    misses, total = _misses(got, whole)
    assert misses == 0, f"{misses} of {total} parameters differ"


def test_qkv_biases_train_and_serve_under_a_model_axis(tmp_path):
    from repro_torch.optim import sgd
    from repro_torch.serve import ServeEngine
    from repro_torch.train import trainer

    rng = np.random.default_rng(5)
    model, params = biased_model()
    vocab = 503
    toks = rng.integers(0, vocab, (2, 8, 16)).astype(np.int32)
    inputs = {"tokens": toks, "labels": np.roll(toks, -1, axis=2),
              "prompts": rng.integers(0, vocab, (4, 8)).astype(np.int32)}
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = launch(4, "bias", tmp_path / "inputs.npz", tmp_path)
    opt = sgd(momentum=0.9)
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step_fn = trainer.make_train_step(model, opt, 0.05)
    for s in range(2):
        state, mets = step_fn(state, {"tokens": toks[s], "labels": inputs["labels"][s]})
        for r in ranks:
            np.testing.assert_allclose(r[f"loss/{s}"], mets["loss"].numpy(), rtol=1e-5)
    want = flatten(state["params"])
    for r in ranks:
        got = {k[len("params/"):]: v for k, v in r.items() if k.startswith("params/")}
        misses, total = _misses(got, {k: v.numpy() for k, v in want.items()})
        assert misses == 0, f"{misses} of {total}"
    engine = ServeEngine(model, biased_model()[1], max_len=24, batch_slots=4, device="cpu",
                         quantized_kv=True, weight_quant=True)
    tokens = engine.generate(torch.from_numpy(inputs["prompts"]), 6).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["generate"], tokens)
