"""Activation rematerialization (``Stack(remat=)``, ``build(remat=)``)
against ``remat="off"`` and against the reference.

* Every policy (``none``, ``dots``, ``full``) gives the loss, the auxiliary
  losses and every gradient of ``remat="off"`` bit for bit on the CPU, float
  and int8 QAT, for a dense arch (smollm-135m-smoke), an MoE arch (the
  load-balance loss counted once: phi3.5-moe-42b-a6.6b-smoke) and a
  recurrent one (mamba-130m-smoke): a recompute replays the same ops.
  So each policy's step against the reference's is the float step's of
  ``tests/test_torch_train.py``, ``test_torch_moe.py`` and
  ``test_torch_ssm_archs.py``.
* ``dots`` keeps the non-batched matmuls' outputs: its backward makes no
  second ``aten.mm``, where ``full`` recomputes them.
* One SGD step of smollm-135m-smoke under ``remat="none"`` (what both
  packages' ``launch.train`` builds) against the reference's under it:
  the loss at rtol 1e-5, the momentum (the gradient) and the parameters at
  the tolerances of ``tests/test_torch_train.py``.
* ``launch.train`` builds with ``remat="none"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.data.pipeline import markov_batch_fn
from repro.models.registry import get_config as j_get_config
from repro.optim import sgd as j_sgd
from repro.train import trainer as j_trainer
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import train as t_launch
from repro_torch.models.registry import get_config
from repro_torch.nn.module import Context, tree_leaves
from repro_torch.nn.transformer import Stack
from repro_torch.optim import sgd
from repro_torch.train import trainer

torch.set_num_threads(2)
ARCHS = ["smollm-135m-smoke", "phi3.5-moe-42b-a6.6b-smoke", "mamba-130m-smoke"]
POLICIES = ["none", "dots", "full"]
MODES = {"float": QuantPolicy.float32, "qat": QuantPolicy.int8_qat}


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
            for k in ("tokens", "labels")}


_results = {}


def _loss_and_grads(arch, remat, mode):
    """(loss, metrics, gradient leaves) of one loss under ``remat``, memoized."""
    key = (arch, remat, mode)
    if key not in _results:
        cfg = get_config(arch)
        model = cfg.build(remat=remat)
        params = model.init(torch.Generator().manual_seed(0), "cpu")

        def loss_fn(p, b):
            ctx = Context(policy=MODES[mode](), train=True,
                          rng=torch.Generator().manual_seed(3))
            return model.loss(p, b, ctx)

        (loss, aux), grads = trainer.value_and_grad(loss_fn, params, _batch(cfg))
        _results[key] = (loss, aux, tree_leaves(grads))
    return _results[key]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_policy_gives_the_gradients_of_off_bit_for_bit(arch, policy, mode):
    loss, aux, grads = _loss_and_grads(arch, policy, mode)
    want_loss, want_aux, want = _loss_and_grads(arch, "off", mode)
    assert torch.equal(loss, want_loss)
    assert aux.keys() == want_aux.keys()
    for k in aux:
        assert torch.equal(aux[k], want_aux[k]), k
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    if "moe" in arch:
        # the load-balance loss comes out of each layer's checkpoint once
        assert aux["aux"] > 0


def _backward_mm_flops(remat):
    cfg = get_config("smollm-135m-smoke")
    model = cfg.build(remat=remat)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    live = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss(params, _batch(cfg, s=32), Context(train=True))
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(loss, live)
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_dots_keeps_the_matmuls_and_full_recomputes_them():
    off, dots, full = (_backward_mm_flops(r) for r in ("off", "dots", "full"))
    assert dots["aten.mm"] == off["aten.mm"] < full["aten.mm"]
    assert dots["aten.bmm"] == full["aten.bmm"] > off["aten.bmm"]


def test_an_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat"):
        Stack(body=(), n_periods=1, remat="everything")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_the_launch_train_policy_step_matches_the_reference():
    """One SGD step of smollm-135m-smoke at ``remat="none"`` in both
    packages from the reference's parameters and batch."""
    arch = "smollm-135m-smoke"
    jm = j_get_config(arch).build(dtype=jnp.float32, remat="none")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = markov_batch_fn(503, 4, 32, seed=3)(0)
    lr = 0.01
    jopt, topt = j_sgd(momentum=0.9), sgd(momentum=0.9)
    jnew, jmet = jax.jit(j_trainer.make_train_step(jm, jopt, lr))(
        {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}, batch)
    tparams = params_from_numpy(_to_numpy(jp), "cpu")
    tstep = trainer.make_train_step(get_config(arch).build(remat="none"), topt, lr)
    tnew, tmet = tstep({"params": tparams, "opt": topt.init(tparams),
                        "step": torch.zeros((), dtype=torch.int32)}, batch)
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    for g, w in zip(_leaves(params_to_numpy(tnew["opt"]["m"])), _leaves(jnew["opt"]["m"])):
        atol = 1e-6 * np.abs(w).max() if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)
    for a, b, g in zip(_leaves(params_to_numpy(tnew["params"])), _leaves(jnew["params"]),
                       _leaves(jnew["opt"]["m"])):
        tol = 1e-5 * np.abs(b) + lr * (1e-4 * np.abs(g) + 1e-6 * np.abs(g).max())
        assert (np.abs(a - b) <= tol).all()


def test_launch_train_builds_with_remat_none(monkeypatch, capsys):
    seen = []
    build = ArchConfig.build

    def spy(self, **kw):
        seen.append(kw.get("remat", "full"))
        return build(self, **kw)

    monkeypatch.setattr(ArchConfig, "build", spy)
    t_launch.main(["--arch", "smollm-135m-smoke", "--steps", "1", "--batch", "2", "--seq",
                   "16", "--device", "cpu", "--log-every", "1"])
    assert seen and set(seen) == {"none"}
