"""The training slice against repro, from the same numpy inputs and the
reference's parameters carried over by ``repro_torch.convert``:

* the optimizers (three updates of SGD at momentum 0 and 0.9, Nesterov,
  weight decay, and AdamW) and ``multistep_lr`` across milestones and warmup;
* every straight-through quantizer: the forward bit for bit, the gradient
  equal to ``jax.grad`` of the reference's, clipped elements included;
* ``LayerNorm``, ``dropout`` (rate 0, ``train=False``, the mask's kept
  share and scaling), ``Context.fold_rng`` and ``train_context``;
* ``CausalLM.loss`` with masked labels and an auxiliary loss;
* one ``make_train_step`` step of smollm-135m-smoke (2 stacked layers):
  float and int8 QAT, SGD and AdamW, ``microbatch_split=2``,
  ``loss_scale=4`` and ``int8_weight_gather``;
* five ``train_resnet`` iterations at filters 12, float and QAT, against
  ``benchmarks/common.py``'s;
* ``make_eval_step``, ``calibrate_model`` and ``calibrate_tokens`` (equal
  qstate keys and exponents);
* ``launch.train.main`` on the CPU: the loss falls, a restart resumes
  exactly, ``--mesh 2,1`` is refused.

Tolerances: a float step's loss at rtol 1e-5 and every gradient leaf at
rtol 1e-4 plus 1e-6 x the leaf's max |grad| (f32 sums in another order);
SGD's parameters at rtol 1e-5; AdamW's parameters at an absolute 1e-3 x lr
(its step is g / (|g| + eps), so an element with |g| near 1e-10 may take
another sign).  A QAT step recomputes every exponent from the live tensor
and truncates, so a value a sum puts on the other side of a grid edge moves
by one code; the QAT tests count the gradient elements outside the float
tolerance and cap their share (``QAT_FLIP_SHARE``) and hold the loss at
``QAT_LOSS_RTOL``.  An EVAL forward on frozen grids spreads such a flip
through the residual stream and its norms: its loss is held at
``EVAL_LOSS_RTOL`` and its accuracy within two tokens.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import observers as j_obs
from repro.core import quantizers as j_q
from repro.core.policy import Granularity as JG
from repro.core.policy import QMode as JM
from repro.core.policy import QuantPolicy as JP
from repro.data.pipeline import markov_batch_fn
from repro.models.registry import get_config as j_get_config
from repro.nn.layers import LayerNorm as JLayerNorm
from repro.nn.layers import dropout as j_dropout
from repro.nn.module import Context as JContext
from repro.optim import adamw as j_adamw
from repro.optim import multistep_lr as j_multistep_lr
from repro.optim import sgd as j_sgd
from repro.train import trainer as j_trainer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import observers, quantizers
from repro_torch.core.policy import Granularity, QMode, QuantPolicy
from repro_torch.launch import train as t_launch
from repro_torch.models.registry import get_config
from repro_torch.nn.layers import LayerNorm, dropout
from repro_torch.nn.module import Context, train_context, tree_leaves
from repro_torch.optim import adamw, multistep_lr, sgd
from repro_torch.train import trainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
QAT_LOSS_RTOL = 1e-4
QAT_FLIP_SHARE = 1e-3
EVAL_LOSS_RTOL = 1e-3


def to_numpy(tree):
    """The reference's tree as numpy leaves."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def leaves(tree):
    """Leaves in sorted-key order (jax's trees sort their dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def grad_misses(got, want, rtol=1e-4, atol_share=1e-6) -> int:
    """Elements outside rtol plus atol_share x max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_share * np.abs(want).max() if want.size else 0.0
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


def assert_grads(got_tree, want_tree, *, flip_share=0.0):
    """Every gradient leaf within the float tolerance; with ``flip_share``,
    at most that share of all elements outside it (QAT's flipped codes)."""
    got, want = leaves(params_to_numpy(got_tree)), leaves(want_tree)
    assert len(got) == len(want)
    misses = sum(grad_misses(g, w) for g, w in zip(got, want))
    total = sum(w.size for w in want)
    assert misses <= flip_share * total, f"{misses} of {total} gradient elements differ"


# --------------------------------------------------------------------------
# Optimizers and the schedule
# --------------------------------------------------------------------------

def _tree(rng):
    return {"a": {"kernel": rng.normal(0, 1, (5, 3)).astype(np.float32),
                  "bias": rng.normal(0, 1, (3,)).astype(np.float32)},
            "b": [rng.normal(0, 1, (2, 3, 2)).astype(np.float32)]}


OPTIMIZERS = [("sgd", dict(momentum=0.0)), ("sgd", dict(momentum=0.9)),
              ("sgd", dict(momentum=0.9, nesterov=True)),
              ("sgd", dict(momentum=0.9, weight_decay=5e-4)),
              ("sgd", dict(momentum=0.0, weight_decay=0.01)),
              ("adamw", {}), ("adamw", dict(weight_decay=0.01))]


@pytest.mark.parametrize("kind,kw", OPTIMIZERS)
def test_optimizer_three_updates_match_reference(kind, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jopt = (j_sgd if kind == "sgd" else j_adamw)(**kw)
    topt = (sgd if kind == "sgd" else adamw)(**kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert sorted(ts) == sorted(js)
    lr = 0.05
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp, lr)
    if kind == "sgd":
        for a, b in zip(leaves(params_to_numpy(tp)), leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        if "m" in js:
            assert_grads(ts["m"], js["m"])
    else:
        for a, b in zip(leaves(params_to_numpy(tp)), leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * lr)
        assert_grads(ts["m"], js["m"])
        assert_grads(ts["v"], js["v"])
        assert int(ts["t"]) == int(js["t"]) == 3 and ts["t"].dtype == torch.int32


@pytest.mark.parametrize("warmup", [0, 4])
def test_multistep_lr_matches_reference_on_ints_and_tensors(warmup):
    jsched = j_multistep_lr(0.02, milestones=(5, 12), gamma=0.13, warmup_steps=warmup)
    tsched = multistep_lr(0.02, milestones=(5, 12), gamma=0.13, warmup_steps=warmup)
    steps = np.arange(20)
    want = np.asarray([jsched(int(s)) for s in steps])
    got = tsched(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal([float(tsched(int(s))) for s in steps], want)


# --------------------------------------------------------------------------
# Straight-through quantizers
# --------------------------------------------------------------------------

def _fwd_and_grad(jfn, tfn, x, up):
    """(port forward, reference forward, port grad, reference grad) of
    sum(f(x) * up)."""
    jx, tx = jnp.asarray(x), torch.from_numpy(x).requires_grad_(True)
    jy = jfn(jx)
    jg = jax.grad(lambda a: jnp.sum(jfn(a) * jnp.asarray(up)))(jx)
    ty = tfn(tx)
    (tg,) = torch.autograd.grad(torch.sum(ty * torch.from_numpy(up)), tx)
    return ty.detach().numpy(), np.asarray(jy), tg.numpy(), np.asarray(jg)


STE_CASES = {
    "fake_quant n=5 w8": (lambda x: j_q.fake_quant(x, jnp.int32(5), 8),
                          lambda x: quantizers.fake_quant(x, torch.tensor(5, dtype=torch.int32), 8)),
    "fake_quant n=-2 w16": (lambda x: j_q.fake_quant(x, jnp.int32(-2), 16),
                            lambda x: quantizers.fake_quant(x, -2, 16)),
    "fake_quant_affine": (
        lambda x: j_q.fake_quant_affine(x, jnp.float32(0.03), jnp.float32(-7.0), 8),
        lambda x: quantizers.fake_quant_affine(x, torch.tensor(0.03), torch.tensor(-7.0), 8)),
    "ste_int8_weight 2-D": (lambda x: j_q.ste_int8_weight(x, (1,)),
                            lambda x: quantizers.ste_int8_weight(x, (1,))),
    "fake_quant_blocked w4 b4": (lambda x: j_q.fake_quant_blocked(x, 4, 4, -2),
                                 lambda x: quantizers.fake_quant_blocked(x, 4, 4, -2)),
    "fake_quant_blocked w2 b3 axis 0": (lambda x: j_q.fake_quant_blocked(x, 2, 3, 0),
                                        lambda x: quantizers.fake_quant_blocked(x, 2, 3, 0)),
}


@pytest.mark.parametrize("case", sorted(STE_CASES))
def test_ste_forward_bit_identical_and_gradient_is_the_references(case):
    """Values of several magnitudes, some past the grid (clipped): the
    forward equals the reference bit for bit and the gradient is the
    upstream gradient everywhere, as jax.grad of the reference's."""
    jfn, tfn = STE_CASES[case]
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 1, (10, 6)) * rng.choice([0.01, 1.0, 40.0], (10, 6))).astype(np.float32)
    up = rng.normal(0, 1, x.shape).astype(np.float32)
    ty, jy, tg, jg = _fwd_and_grad(jfn, tfn, x, up)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg, up)


def test_ste_int8_weight_on_stacked_kernels_dequantizes_with_the_reference_exp2():
    """Per layer and channel (keep (0, -1)) on a (2, 7, 5) stack whose
    ranges put exponents past 12, where the reference's exp2 is not 2^n."""
    rng = np.random.default_rng(2)
    x = (rng.normal(0, 1, (2, 7, 5)) * np.array([1e-5, 3.0])[:, None, None]).astype(np.float32)
    up = rng.normal(0, 1, x.shape).astype(np.float32)
    ty, jy, tg, jg = _fwd_and_grad(lambda a: j_q.ste_int8_weight(a, (0, 2)),
                                   lambda a: quantizers.ste_int8_weight(a, (0, 2)), x, up)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


POLICIES = {
    "qat per-layer": dict(mode="QAT"),
    "qat per-channel": dict(mode="QAT", granularity="PER_CHANNEL"),
    "qat per-network Q7.9": dict(mode="QAT", weight_bits=16, act_bits=16,
                                 granularity="PER_NETWORK", network_frac_bits=9),
    "qat affine asymmetric": dict(mode="QAT", symmetric=False),
    "qat affine non-pow2": dict(mode="QAT", power_of_two=False),
}


def _policies(kw):
    jkw, tkw = dict(kw), dict(kw)
    for k, enum_j, enum_t in (("mode", JM, QMode), ("granularity", JG, Granularity)):
        if k in kw:
            jkw[k], tkw[k] = enum_j[kw[k]], enum_t[kw[k]]
    return JP(**jkw), QuantPolicy(**tkw)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_quantize_value_under_qat_policies(name):
    jpol, tpol = _policies(POLICIES[name])
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (6, 9)).astype(np.float32)
    up = rng.normal(0, 1, x.shape).astype(np.float32)
    ty, jy, tg, jg = _fwd_and_grad(
        lambda a: j_q.quantize_value(a, jpol, 8, channel_axis=-1),
        lambda a: quantizers.quantize_value(a, tpol, 8, channel_axis=-1), x, up)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)
    n = quantizers.dynamic_frac_bits(torch.from_numpy(x), 8, channel_axis=-1)
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_q.dynamic_frac_bits(
        jnp.asarray(x), 8, channel_axis=-1)))


# --------------------------------------------------------------------------
# LayerNorm, dropout, the training context
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_bias,use_scale", [(True, True), (False, True), (True, False)])
def test_layernorm_matches_reference(use_bias, use_scale):
    rng = np.random.default_rng(4)
    x = rng.normal(1, 3, (3, 5, 24)).astype(np.float32)
    p = {}
    if use_scale:
        p["scale"] = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    if use_bias:
        p["bias"] = rng.normal(0, 1, 24).astype(np.float32)
    want = JLayerNorm(24, use_bias=use_bias, use_scale=use_scale).apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), JContext())
    ln = LayerNorm(24, use_bias=use_bias, use_scale=use_scale)
    assert sorted(ln.init(None, "cpu")) == sorted(p)
    got = ln.apply(params_from_numpy(p, "cpu"), torch.from_numpy(x), Context())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dropout_is_the_identity_where_the_reference_is():
    x = np.random.default_rng(5).normal(0, 1, (4, 8)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for rate, train in ((0.0, True), (0.5, False)):
        want = j_dropout(jnp.asarray(x), rate, JContext(train=train, rng=jax.random.PRNGKey(0)))
        got = dropout(torch.from_numpy(x), rate, Context(train=train, rng=gen))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # no rng in the context: the identity, as in the reference
    np.testing.assert_array_equal(dropout(torch.from_numpy(x), 0.5, Context(train=True)).numpy(),
                                  x)


def test_dropout_mask_keeps_its_share_and_scales_by_one_over_keep():
    x = torch.full((400, 500), 3.0)
    ctx = train_context(rng=torch.Generator().manual_seed(7)).scope("blk")
    y = dropout(x, 0.25, ctx)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 3.0 / 0.75))
    assert torch.equal(dropout(x, 0.25, ctx), y)                      # same site, same mask
    assert not torch.equal(dropout(x, 0.25, ctx, name="other") != 0, kept)


def test_context_fold_rng_and_auxiliary_losses():
    ctx = train_context(QuantPolicy.int8_qat(), rng=torch.Generator().manual_seed(3))
    assert ctx.train and ctx.policy.mode is QMode.QAT
    a, b = ctx.scope("l0"), ctx.scope("l1")
    draw = lambda c: torch.rand(4, generator=c.fold_rng("dropout"))  # noqa: E731
    assert torch.equal(draw(a), draw(a)) and not torch.equal(draw(a), draw(b))
    assert Context().fold_rng("x") is None
    a.add_loss("lb", torch.tensor(0.5))
    b.add_loss("lb", torch.tensor(0.25))
    assert ctx.losses["lb"].item() == 0.75


# --------------------------------------------------------------------------
# The smoke LM: loss, train steps, evaluation, calibration
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """smollm-135m-smoke (2 stacked layers) from the reference's init,
    converted for the port, and a batch of the reference's Markov stream
    with some labels masked."""
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="none")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = markov_batch_fn(503, 4, 32, seed=3)(0)
    batch["labels"][0, :5] = -1
    return dict(jm=jm, jp=jp, tm=get_config("smollm-135m-smoke").build(), batch=batch,
                np_params=to_numpy(jp))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("aux", [0.0, 0.375])
def test_causal_lm_loss_matches_reference(lm, aux):
    @jax.jit
    def j_loss(p, b):
        jctx = JContext()
        if aux:
            jctx.add_loss("lb", jnp.float32(aux))
        return lm["jm"].loss(p, b, jctx)

    tctx = Context()
    if aux:
        tctx.add_loss("lb", torch.tensor(aux))
    jl, jm = j_loss(lm["jp"], lm["batch"])
    tl, tm = lm["tm"].loss(params_from_numpy(lm["np_params"], "cpu"), _tbatch(lm["batch"]), tctx)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["nll"].item(), float(jm["nll"]), rtol=1e-5)
    assert tm["aux"].item() == float(jm["aux"]) == aux
    assert tm["accuracy"].item() == float(jm["accuracy"])


STEPS = {
    "float sgd": dict(opt=("sgd", dict(momentum=0.9))),
    "float adamw": dict(opt=("adamw", dict(weight_decay=0.01))),
    "qat sgd": dict(opt=("sgd", dict(momentum=0.9)), qat=True),
    "qat adamw": dict(opt=("adamw", dict(weight_decay=0.01)), qat=True),
    "float sgd microbatch 2": dict(opt=("sgd", dict(momentum=0.9)), microbatch_split=2),
    "float sgd loss_scale 4": dict(opt=("sgd", dict(momentum=0.9)), loss_scale=4.0),
    "float sgd int8_weight_gather": dict(opt=("sgd", dict(momentum=0.9)),
                                         int8_weight_gather=True),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_matches_reference(lm, name):
    """One step from the same parameters and batch.  SGD's momentum after
    one step from zero is the gradient itself, AdamW's first moment (1 -
    b1) x the gradient: both are held at the gradient tolerance."""
    spec = dict(STEPS[name])
    kind, okw = spec.pop("opt")
    qat = spec.pop("qat", False)
    lr = 0.01
    jpol, tpol = (JP.int8_qat(), QuantPolicy.int8_qat()) if qat else (None, None)
    jopt = (j_sgd if kind == "sgd" else j_adamw)(**okw)
    topt = (sgd if kind == "sgd" else adamw)(**okw)
    jstate = {"params": lm["jp"], "opt": jopt.init(lm["jp"]), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(j_trainer.make_train_step(lm["jm"], jopt, lr, policy=jpol, **spec))
    jnew, jmet = jstep(jstate, lm["batch"])
    tparams = params_from_numpy(lm["np_params"], "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    tstep = trainer.make_train_step(lm["tm"], topt, lr, policy=tpol, **spec)
    tnew, tmet = tstep(tstate, lm["batch"])
    assert int(tnew["step"]) == 1 and sorted(tmet) == sorted(jmet)
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=QAT_LOSS_RTOL if qat else 1e-5)
    assert tmet["lr"].item() == float(jmet["lr"])
    flips = QAT_FLIP_SHARE if qat else 0.0
    if kind == "sgd":
        assert_grads(tnew["opt"]["m"], jnew["opt"]["m"], flip_share=flips)
        # p - lr * g: rtol 1e-5 of p, plus lr x the gradient's tolerance
        misses = 0
        for a, b, g in zip(leaves(params_to_numpy(tnew["params"])), leaves(jnew["params"]),
                           leaves(jnew["opt"]["m"])):
            tol = 1e-5 * np.abs(b) + lr * (1e-4 * np.abs(g) + 1e-6 * np.abs(g).max())
            misses += int((np.abs(a - b) > tol).sum())
        total = sum(x.size for x in leaves(jnew["params"]))
        assert misses <= flips * total, f"{misses} of {total} parameters differ"
    else:
        assert_grads(tnew["opt"]["m"], jnew["opt"]["m"], flip_share=flips)
        assert_grads(tnew["opt"]["v"], jnew["opt"]["v"], flip_share=flips)
        assert int(tnew["opt"]["t"]) == int(jnew["opt"]["t"]) == 1
        for a, b in zip(leaves(params_to_numpy(tnew["params"])), leaves(jnew["params"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * lr)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tnew["params"]))


def test_stacked_layers_gradients_land_in_their_own_index(lm, monkeypatch):
    """Depth 2: each layer's gradient lands in its own index of the stacked
    leaf, and splitting the stack once (``tree_unstack``, unbind) gives the
    gradients that indexing it layer by layer (``tree_layer``) gives."""
    from repro_torch.nn import module, transformer

    tparams = params_from_numpy(lm["np_params"], "cpu")
    loss_fn = lambda p, b: lm["tm"].loss(p, b, Context(train=True))  # noqa: E731
    (_, _), grads = trainer.value_and_grad(loss_fn, tparams, _tbatch(lm["batch"]))
    wq = grads["stack"]["body"][0]["mixer"]["wq"]["kernel"]
    assert wq.shape[0] == 2 and bool((wq[0] != 0).any()) and bool((wq[1] != 0).any())
    assert not torch.equal(wq[0], wq[1])
    monkeypatch.setattr(transformer, "tree_unstack",
                        lambda tree, n: [module.tree_layer(tree, i) for i in range(n)])
    (_, _), indexed = trainer.value_and_grad(loss_fn, tparams, _tbatch(lm["batch"]))
    for a, b in zip(tree_leaves(grads), tree_leaves(indexed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("qat", [False, True])
def test_eval_step_and_calibrate_model_match_reference(lm, qat):
    pol = (JP(mode=JM.EVAL, weight_bits=8, act_bits=8), QuantPolicy(
        mode=QMode.EVAL, weight_bits=8, act_bits=8)) if qat else (None, None)
    tparams = params_from_numpy(lm["np_params"], "cpu")
    batches = [markov_batch_fn(503, 2, 16, seed=5)(s) for s in range(2)]
    jq = tq = None
    if qat:
        jq = j_trainer.calibrate_model(lm["jm"], lm["jp"], batches, pol[0])
        tq = trainer.calibrate_model(lm["tm"], tparams, batches, pol[1])
        assert sorted(tq) == sorted(jq)
        for k in jq:
            assert int(tq[k]) == int(jq[k]), k
    jm = j_trainer.make_eval_step(lm["jm"], policy=pol[0], qstate=jq)(lm["jp"], lm["batch"])
    tm = trainer.make_eval_step(lm["tm"], policy=pol[1], qstate=tq)(tparams, lm["batch"])
    assert sorted(tm) == sorted(jm)
    # EVAL truncates on frozen grids: one code of a projection's output that
    # a sum in another order puts across an edge moves a residual element by
    # 2^-n, which the next norms spread (0.35e-3 of the loss measured here)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=EVAL_LOSS_RTOL if qat else 1e-5)
    labels = (lm["batch"]["labels"] >= 0).sum()
    assert abs(tm["accuracy"].item() - float(jm["accuracy"])) <= (2 if qat else 0) / labels


@pytest.mark.parametrize("observer", ["minmax", "ema"])
def test_calibrate_tokens_matches_reference(lm, observer):
    toks = [np.asarray(markov_batch_fn(503, 2, 16, seed=6)(s)["tokens"]) for s in range(3)]
    pol = (JP(mode=JM.EVAL, weight_bits=8, act_bits=8),
           QuantPolicy(mode=QMode.EVAL, weight_bits=8, act_bits=8))
    want = j_obs.calibrate_tokens(lm["jm"], lm["jp"], toks, pol[0], observer=observer)
    got = observers.calibrate_tokens(lm["tm"], params_from_numpy(lm["np_params"], "cpu"),
                                     toks, pol[1], observer=observer)
    assert sorted(got) == sorted(want) and any("/p0/" in k for k in got)
    for k in want:
        assert int(got[k]) == int(want[k]), k


def test_qat_gradient_makes_no_tensor_from_host_data(lm):
    """On a card a tensor made from host data is a copy and a sync, and a
    value read back is a sync: a QAT forward and backward (every exponent
    reassessed through qformat's log2 emulation) makes neither."""
    from torch.profiler import ProfilerActivity, profile

    tparams = params_from_numpy(lm["np_params"], "cpu")
    loss_fn = lambda p, b: lm["tm"].loss(  # noqa: E731
        p, b, Context(policy=QuantPolicy.int8_qat(), train=True))
    batch = _tbatch(lm["batch"])
    trainer.value_and_grad(loss_fn, tparams, batch)     # exp2's table: once per device
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.value_and_grad(loss_fn, tparams, batch)
    names = [e.name for e in prof.events()]
    assert names.count("aten::lift_fresh") == 0
    assert names.count("aten::_local_scalar_dense") == 0
    assert names.count("aten::mul") > 100          # the profiler saw the step


def test_train_step_refuses_a_mesh(lm):
    with pytest.raises(NotImplementedError, match="distribution slice"):
        trainer.make_train_step(lm["tm"], sgd(), 0.01, mesh=object())


# --------------------------------------------------------------------------
# ResNetv1-6 through benchmarks/common.py's loop
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def j_common():
    spec = importlib.util.spec_from_file_location("_bench_common", ROOT / "benchmarks/common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("qat", [False, True])
def test_train_resnet_five_iterations_match_reference(j_common, qat):
    from repro_torch.bench import common

    jpol, tpol = (JP.int8_qat(), QuantPolicy.int8_qat()) if qat else (None, None)
    jmodel = j_common.build_resnet("uci-har", filters=12)
    jp0 = jmodel.init(jax.random.PRNGKey(0))
    _, jp, jtest = j_common.train_resnet("uci-har", 12, iters=5, policy=jpol, init_params=jp0)
    tmodel, tp, ttest = common.train_resnet("uci-har", 12, iters=5, policy=tpol, device="cpu",
                                            init_params=params_from_numpy(to_numpy(jp0), "cpu"))
    np.testing.assert_array_equal(ttest[0], jtest[0])
    flips = QAT_FLIP_SHARE if qat else 0.0
    got, want = leaves(params_to_numpy(tp)), leaves(jp)
    misses = sum(grad_misses(a, b, rtol=1e-4, atol_share=1e-5) for a, b in zip(got, want))
    total = sum(w.size for w in want)
    assert misses <= flips * total, f"{misses} of {total} parameters differ"
    acc = common.accuracy(tmodel, tp, ttest)
    assert acc == pytest.approx(j_common.accuracy(jmodel, jp, jtest), abs=2 / len(ttest[1]))


# --------------------------------------------------------------------------
# The entry point on the CPU
# --------------------------------------------------------------------------

def _main(*extra, **kw):
    losses = []
    state = t_launch.main(["--arch", "smollm-135m-smoke", "--device", "cpu", *extra],
                          on_step=lambda s, m, dt: losses.append(m["loss"]), **kw)
    return state, losses


def test_launch_train_loss_falls(capsys):
    """As tests/test_system.py:273-296 asks of the reference's step: SGD
    0.9 at lr 0.05 over 20 steps of a (16, 32) Markov batch."""
    _, losses = _main("--steps", "20", "--batch", "16", "--seq", "32", "--optimizer", "sgd",
                      "--lr", "0.05", "--log-every", "5")
    assert len(losses) == 20 and losses[-1] < losses[0] - 0.15, losses
    assert "done" in capsys.readouterr().out


def test_int8_weight_gather_training_learns():
    """tests/test_system.py:273-296 on the port: materialized-int8 weights
    (STE, float master) learn, and the master stays float."""
    cfg = get_config("smollm-135m-smoke")
    model, opt = cfg.build(), sgd(momentum=0.9)
    state = trainer.init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    step = trainer.make_train_step(model, opt, 0.05, int8_weight_gather=True)
    bf = markov_batch_fn(cfg.vocab, 16, 32, seed=2)
    losses = []
    for s in range(20):
        state, m = step(state, bf(s))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.15, losses
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["params"]))


class _Preempted(Exception):
    pass


def test_launch_train_restart_resumes_exactly(tmp_path, capsys):
    """A run killed after step 3's checkpoint and launched again with the
    same flags resumes at step 3 and ends where an uninterrupted run ends."""
    args = ["--steps", "6", "--batch", "4", "--seq", "16", "--ckpt-every", "3", "--qat"]
    whole, _ = _main("--ckpt-dir", str(tmp_path / "a"), *args)

    def preempt(step, metrics, dt):
        if step == 3:
            raise _Preempted

    with pytest.raises(_Preempted):
        t_launch.main(["--arch", "smollm-135m-smoke", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "b"), *args], on_step=preempt)
    resumed, losses = _main("--ckpt-dir", str(tmp_path / "b"), *args)
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert len(losses) == 3 and int(resumed["step"]) == 6
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)


def test_launch_train_refuses_a_mesh():
    with pytest.raises(SystemExit, match="distribution slice"):
        _main("--mesh", "2,1")
