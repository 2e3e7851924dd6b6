"""Train, eval and calibration steps (``repro/train/trainer.py``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)`` where
state = {params, opt, step}:

* the :class:`Context` carries the active ``QuantPolicy`` (OFF: float
  training; QAT: fake-quant forward, straight-through backward and ranges
  reassessed every step, paper Sec. 4.3);
* the gradients are ``torch.autograd.grad`` over the tree's leaves
  (:func:`value_and_grad`); ``microbatch_split > 1`` sums them over
  microbatches in a loop and divides, as the reference's scan does;
* the batch moves to the parameters' device here (pinned and asynchronous
  on a card), and the step reads nothing back: ``state["step"]`` and every
  metric stay device tensors;
* under a data mesh (``mesh=``, a ``DeviceMesh`` whose axes other than
  ``data`` are of size 1) every rank holds the whole parameter tree, takes
  its slice of the batch and all-reduces the gradients: the numbers are
  those of one device on the whole batch (the loss and gradients weighted
  by each slice's share of the scored tokens, the QAT activation ranges
  the group's);
* with ``axis_rules=`` as well (``dist.sharding.make_axis_rules``) the
  parameters and the optimizer moments are sharded by ``param_pspecs``
  over ``data`` (FSDP) and ``model`` (tensor and expert parallel;
  :func:`shard_state` lays a whole state out): the layers gather what
  they use (``nn/layers.py``, ``nn/moe.py``), the gradient of a leaf cut
  over ``data`` arrives summed by the gathers' reduce-scatter, and the
  others are all-reduced over ``data`` as on a data mesh.  The numbers
  are still one device's on the whole batch.

``make_dp_shardmap_train_step`` is the explicit-collective data-parallel
step of the int8 gradient compression (``dist/compress.py``): each rank's
loss over its own slice, activation ranges its own, the gradients'
mean equal-weighted.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.policy import QMode, QuantPolicy
from repro_torch.dist import axis_group, sharding
from repro_torch.dist.compress import compressed_grad_allreduce, grad_allreduce_mean
from repro_torch.nn.module import Context, tree_device, tree_leaves, tree_map, tree_unflatten

TrainState = Dict[str, Any]  # {"params": tree, "opt": tree, "step": int32 0-d tensor}


def init_train_state(model, optimizer, gen: torch.Generator, device=None) -> TrainState:
    """Parameters from ``model.init(gen, device)``, the optimizer's state and step 0."""
    params = model.init(gen, device)
    dev = tree_device(params)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``; to a
    card through pinned memory and an asynchronous copy, so no sync."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss, aux)``,
    as ``jax.value_and_grad(has_aux=True)`` gives them: the gradient of every
    leaf (zeros for a leaf the loss does not reach), ``loss`` and ``aux``
    detached."""
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
            tree_unflatten(params, grads))


class _HostStep:
    """The step count on the host, for seeding the step's generator without
    reading ``state["step"]`` back: read once, then advanced beside the
    device counter the step returns; a state from elsewhere (a restore) is
    read again."""

    def __init__(self):
        self._tensor: Optional[torch.Tensor] = None
        self._value = 0

    def value(self, step: torch.Tensor) -> int:
        if step is not self._tensor:
            # a meta step (the dry run's account) holds no value: it counts from 0
            self._value = 0 if step.is_meta else int(step)
        return self._value

    def advance(self, new_step: torch.Tensor) -> None:
        self._tensor, self._value = new_step, self._value + 1


def _step_generator(step: torch.Tensor, seed: int) -> torch.Generator:
    """The step's generator, on the step's device (the CPU's for a meta
    step, which draws nothing)."""
    device = "cpu" if step.is_meta else step.device
    return torch.Generator(device=device).manual_seed(seed)


def _data_group(mesh, axis_rules, policy: QuantPolicy, where: str):
    """The data-parallel group of ``mesh`` (None without one).  Rules
    naming an axis the mesh lacks raise ``KeyError``, as the reference's
    ``Context._axis_size`` does."""
    if axis_rules is not None and mesh is not None:
        ctx = Context(mesh=sharding.mesh_shape(mesh), axis_rules=axis_rules)
        ctx.dp_size, ctx.tp_size        # noqa: B018 -- KeyError for an axis the mesh lacks
    if mesh is None:
        return None
    if policy.enabled and not (policy.power_of_two and policy.symmetric):
        raise NotImplementedError(f"{where}: an affine policy's live ranges under a mesh "
                                  "are not executed (ROADMAP.md queue 2)")
    return axis_group(mesh, "data")


def _like(a, b) -> bool:
    """Whether two trees have one structure and one shape per leaf."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_like(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_like, a, b))
    return not isinstance(b, (dict, list, tuple)) and getattr(a, "shape", None) == \
        getattr(b, "shape", ())


def check_shardable(model, where: str) -> None:
    """A sharded mesh runs the causal attention family (dense or MoE
    FFNs), whose every cut weight goes through ``Dense``, ``Embedding`` or
    ``MoE``; Mamba, RWKV-6, cross-attention and the encoder-decoder use
    their weights directly and are refused (``ROADMAP.md`` queue 2)."""
    from repro_torch.models.lm import CausalLM

    blocks = getattr(getattr(model, "stack", None), "blocks", ())
    if not isinstance(model, CausalLM) or any(
            b.mixer != "attn" or b.cross or b.ffn == "rwkv" for b in blocks):
        raise NotImplementedError(f"{where}: parameters sharded over a mesh run the causal "
                                  "attention family only (ROADMAP.md queue 2)")


def state_pspecs(state: TrainState, mesh, axis_rules) -> Dict[str, Any]:
    """The spec tree of a whole train state: the parameters by
    ``param_pspecs``, each optimizer moment shaped like them by the same
    specs, the rest replicated."""
    pspecs = sharding.param_pspecs(state["params"], mesh, axis_rules)
    out = {k: tree_map(lambda _: (), v) for k, v in state.items()}
    out["params"] = pspecs
    out["opt"] = {k: pspecs if _like(v, state["params"]) else tree_map(lambda _: (), v)
                  for k, v in state["opt"].items()}
    return out


def meta_state(model, optimizer) -> TrainState:
    """A train state of ``model`` on the ``meta`` device: the whole shapes,
    no storage."""
    params = model.init(torch.Generator(), "meta")
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def shard_state(state: TrainState, mesh, axis_rules) -> TrainState:
    """A whole train state (every rank the same) cut to this rank's shards."""
    return sharding.shard_tree(state, state_pspecs(state, mesh, axis_rules), mesh)


def gather_data_dims(params, specs, mesh):
    """Every leaf cut over ``data`` gathered over it, one collective a leaf
    (a stacked leaf's layers at once), with the FSDP backward (the
    gradient's reduce-scatter): the step's weight gathers in a few large
    calls, where a call over gloo costs milliseconds whatever its size.
    The cost is memory: every layer's whole rows at once (the columns stay
    cut over ``model``); the layers gather a leaf that arrives cut."""
    from repro_torch.dist import shard_ops

    def whole_rows(leaf, spec):
        for d, e in enumerate(spec):
            if sharding._axes(e) == ("data",) and isinstance(leaf, torch.Tensor):
                leaf = shard_ops.gather_fsdp(leaf, d, mesh, "data")
        return leaf

    return tree_unflatten(params, [whole_rows(leaf, spec) for leaf, spec in
                                   sharding.leaves_with_specs(params, specs)])


def _data_sharded(params, specs) -> list:
    """Per leaf (``tree_leaves`` order): whether its spec names ``data``."""
    return ["data" in sharding.spec_axes(sp)
            for _, sp in sharding.leaves_with_specs(params, specs)]


def _reduce_grads(grads, cut: list, group):
    """The data mean of every gradient: a leaf cut over ``data`` arrives
    summed by the reduce-scatter of its gather, so it is divided by the
    data degree; the rest are all-reduced over ``data``."""
    leaves = tree_leaves(grads)
    world = dist.get_world_size(group)
    rest = [g for g, c in zip(leaves, cut) if not c]
    rest = iter(tree_leaves(grad_allreduce_mean(rest, group)) if rest else [])
    return tree_unflatten(grads, [g / world if c else next(rest) for g, c in zip(leaves, cut)])


def _slices(batch: Dict[str, Any], group, split: int = 1):
    """This rank's part of a global batch and its weight in each of the
    ``split`` microbatches: the rows of microbatch i that fall to this rank
    (the reference's layout: microbatch i is split over the data axis), and
    this rank's share of microbatch i's scored tokens (labels >= 0) times
    the world size, so that the mean over ranks of the weighted slice
    losses is microbatch i's loss (exactly 1.0 where the shares are
    equal).  Without labels every slice weighs 1."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = next(iter(batch.values())).shape[0]
    if rows % (world * split):
        raise ValueError(f"a batch of {rows} rows does not split over {world} ranks x "
                         f"{split} microbatches")
    per = rows // (world * split)

    def part(v):
        return v.reshape(split, world, per, *v.shape[1:])[:, rank].reshape(split * per,
                                                                           *v.shape[1:])
    local = {k: part(v) for k, v in batch.items()}
    labels = batch.get("labels")
    if labels is None:
        return local, [None] * split
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.ascontiguousarray(labels))
    counts = (labels >= 0).reshape(split, world, -1).sum(-1).to(torch.float32)
    shares = counts[:, rank] * world / torch.clamp(counts.sum(-1), min=1.0)
    return local, list(shares)


def _weighted(loss, mets, weight):
    """``loss`` and every metric times ``weight`` (a 0-d tensor that may lie
    on the CPU, where a card's kernel takes it as a scalar: no copy)."""
    if weight is None:
        return loss, mets
    return loss * weight, {k: v * weight for k, v in mets.items()}


def _group_mean(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The mean of each 0-d metric over ``group``: one all-reduce."""
    stacked = torch.stack(list(values.values())).to(torch.float32)
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    stacked = stacked / dist.get_world_size(group)
    return dict(zip(values, stacked.unbind()))


def _f32(lr, device) -> torch.Tensor:
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32)
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def make_train_step(model, optimizer, lr_schedule, *,
                    policy: Optional[QuantPolicy] = None,
                    mesh=None, axis_rules=None,
                    microbatch_split: int = 1,
                    int8_weight_gather: bool = False,
                    loss_scale: float = 1.0) -> Callable:
    """One optimizer step of ``model.loss`` under ``policy``.
    ``int8_weight_gather``: every GEMM weight goes through materialized
    int8 codes inside the step (STE backward; the float master is
    untouched).  ``loss_scale`` multiplies the loss before the backward and
    divides the gradients after it.  ``mesh``: a data mesh
    (``launch.mesh.make_host_mesh(D, 1)``); every rank passes the same
    global batch and ends the step with the same parameters."""
    policy = policy or QuantPolicy.float32()
    group = _data_group(mesh, axis_rules, policy, "make_train_step")
    host_step = _HostStep()
    shard_mesh = mesh if axis_rules is not None else None
    # per leaf: whether it arrives cut over data (its gradient then summed)
    pspecs = cut = None
    if shard_mesh is not None:
        check_shardable(model, "make_train_step")
        whole = model.init(torch.Generator(), "meta")
        pspecs = sharding.param_pspecs(whole, mesh, axis_rules)
        cut = _data_sharded(whole, pspecs)

    def loss_fn(params, batch, rng, weight):
        if int8_weight_gather:
            from repro_torch.core.integerize import fake_int8_weights

            params = fake_int8_weights(params, mesh=shard_mesh, rules=axis_rules,
                                       specs=pspecs)
        elif shard_mesh is not None:
            params = gather_data_dims(params, pspecs, shard_mesh)
        ctx = Context(policy=policy, train=True, rng=rng, group=group, mesh=shard_mesh,
                      axis_rules=axis_rules)
        loss, mets = _weighted(*model.loss(params, batch, ctx), weight)
        return loss * loss_scale, mets

    def train_step(state: TrainState, batch) -> tuple:
        params, opt, step = state["params"], state["opt"], state["step"]
        weights = [None] * microbatch_split
        if group is not None:
            batch, weights = _slices(batch, group, microbatch_split)
        batch = to_device(batch, step.device)
        rng = _step_generator(step, host_step.value(step))
        if microbatch_split > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), device=step.device)
            acc = torch.zeros((), device=step.device)
            for i in range(microbatch_split):
                mb = {k: v.reshape(microbatch_split, v.shape[0] // microbatch_split,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                (l, mets), g = value_and_grad(loss_fn, params, mb, rng, weights[i])
                grads = tree_map(torch.add, grads, g)
                loss, acc = loss + l, acc + mets["accuracy"]
            grads = tree_map(lambda g: g / microbatch_split, grads)
            loss, acc = loss / microbatch_split, acc / microbatch_split
            mets = {"accuracy": acc}
        else:
            (loss, mets), grads = value_and_grad(loss_fn, params, batch, rng, weights[0])
        if loss_scale != 1.0:
            grads = tree_map(lambda g: g / loss_scale, grads)
            loss = loss / loss_scale
        if group is not None:
            grads = (grad_allreduce_mean(grads, group) if cut is None
                     else _reduce_grads(grads, cut, group))
            mean = _group_mean({"loss": loss, **mets}, group)
            loss, mets = mean.pop("loss"), mean
        lr = lr_schedule(step) if callable(lr_schedule) else lr_schedule
        new_params, new_opt = optimizer.update(grads, opt, params, lr)
        new_step = step + 1
        host_step.advance(new_step)
        metrics = {"loss": loss, "lr": _f32(lr, step.device), **mets}
        return {"params": new_params, "opt": new_opt, "step": new_step}, metrics

    return train_step


def make_eval_step(model, *, policy: Optional[QuantPolicy] = None,
                   qstate=None, mesh=None, axis_rules=None) -> Callable:
    """``(params, batch) -> {"loss", "nll", "aux", "accuracy"}`` without
    gradients; under a data mesh each rank scores its slice and the
    metrics are the whole batch's."""
    policy = policy or QuantPolicy.float32()
    group = _data_group(mesh, axis_rules, policy, "make_eval_step")
    shard_mesh = mesh if axis_rules is not None else None
    if shard_mesh is not None:
        check_shardable(model, "make_eval_step")
        pspecs = sharding.param_pspecs(model.init(torch.Generator(), "meta"), mesh, axis_rules)

    def eval_step(params, batch):
        weight = None
        if group is not None:
            batch, (weight,) = _slices(batch, group)
        batch = to_device(batch, tree_device(params))
        with torch.no_grad():
            if shard_mesh is not None:
                params = gather_data_dims(params, pspecs, shard_mesh)
            ctx = Context(policy=policy, train=False, qstate=qstate, group=group,
                          mesh=shard_mesh, axis_rules=axis_rules)
            loss, mets = _weighted(*model.loss(params, batch, ctx), weight)
        if group is not None:
            return _group_mean({"loss": loss, **mets}, group)
        return {"loss": loss, **mets}

    return eval_step


def make_calib_fn(model, policy: QuantPolicy) -> Callable:
    """``apply_fn`` for ``repro_torch.core.ptq.calibrate``: records activation ranges."""
    del policy

    def apply_fn(params, batch, ctx):
        return model.loss(params, batch, ctx)

    return apply_fn


def calibrate_model(model, params, batches, policy: QuantPolicy) -> Dict[str, torch.Tensor]:
    """CALIB forwards of ``model.loss`` over ``batches``; the frozen exponents."""
    from repro_torch.core import ptq

    calib_policy = policy.with_mode(QMode.CALIB)
    device = tree_device(params)
    acc: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for batch in batches:
            ctx = Context(policy=calib_policy, train=False)
            model.loss(params, to_device(batch, device), ctx)
            for k, v in ctx.stats.items():
                acc[k] = torch.maximum(acc[k], v) if k in acc else v
    return ptq.ranges_to_qstate(acc, policy)


# --------------------------------------------------------------------------
# Explicit data-parallel step with int8 gradient compression
# --------------------------------------------------------------------------


def make_dp_shardmap_train_step(model, optimizer, lr_schedule, mesh, *,
                                policy: Optional[QuantPolicy] = None,
                                compress_bits: int = 0,
                                axis_name: str = "data") -> Callable:
    """Pure data parallelism over ``mesh[axis_name]`` with explicit
    collectives, the reference's ``shard_map`` step: every rank holds the
    whole parameter tree and optimizer state, passes the same global batch
    and takes its slice along dim 0; its loss, gradients and QAT ranges are
    its slice's.  The gradients are all-reduce-averaged, or with
    ``compress_bits`` go through :func:`compressed_grad_allreduce`, and the
    state then gains ``err``, this rank's own error-feedback residual (a
    tree like the parameters).  ``loss`` and ``accuracy`` are the group's
    means; every rank ends the step with the same parameters and optimizer
    state."""
    group = axis_group(mesh, axis_name)
    policy = policy or QuantPolicy.float32()
    host_step = _HostStep()

    def loss_fn(params, batch, rng):
        return model.loss(params, batch, Context(policy=policy, train=True, rng=rng))

    def train_step(state: TrainState, batch) -> tuple:
        params, opt, step = state["params"], state["opt"], state["step"]
        batch, _ = _slices(batch, group)
        batch = to_device(batch, step.device)
        rng = _step_generator(step, host_step.value(step))
        (loss, mets), grads = value_and_grad(loss_fn, params, batch, rng)
        new_err = None
        if compress_bits:
            err = state.get("err")
            if err is None:
                err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
            grads, new_err = compressed_grad_allreduce(grads, group, bits=compress_bits,
                                                       error_state=err)
        else:
            grads = grad_allreduce_mean(grads, group)
        metrics = _group_mean({"loss": loss, "accuracy": mets["accuracy"]}, group)
        lr = lr_schedule(step) if callable(lr_schedule) else lr_schedule
        new_params, new_opt = optimizer.update(grads, opt, params, lr)
        new_step = step + 1
        host_step.advance(new_step)
        out = {"params": new_params, "opt": new_opt, "step": new_step}
        if new_err is not None:
            out["err"] = new_err
        return out, metrics

    return train_step
