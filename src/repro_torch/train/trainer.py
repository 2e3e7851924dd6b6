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
  metric stay device tensors.

The explicit-collective data-parallel step (``make_dp_shardmap_train_step``)
waits for the distribution slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.policy import QMode, QuantPolicy
from repro_torch.nn.module import Context, tree_device, tree_leaves, tree_map, tree_unflatten

TrainState = Dict[str, Any]  # {"params": tree, "opt": tree, "step": int32 0-d tensor}

_MESH_LATER = ("a mesh (mesh=/axis_rules=) waits for the port's distribution slice "
               "(ROADMAP.md queue 1)")


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
            self._value = int(step)
        return self._value

    def advance(self, new_step: torch.Tensor) -> None:
        self._tensor, self._value = new_step, self._value + 1


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
    divides the gradients after it."""
    if mesh is not None or axis_rules is not None:
        raise NotImplementedError(f"make_train_step: {_MESH_LATER}")
    policy = policy or QuantPolicy.float32()
    host_step = _HostStep()

    def loss_fn(params, batch, rng):
        if int8_weight_gather:
            from repro_torch.core.integerize import fake_int8_weights

            params = fake_int8_weights(params)
        ctx = Context(policy=policy, train=True, rng=rng)
        loss, mets = model.loss(params, batch, ctx)
        return loss * loss_scale, mets

    def train_step(state: TrainState, batch) -> tuple:
        params, opt, step = state["params"], state["opt"], state["step"]
        batch = to_device(batch, step.device)
        rng = torch.Generator(device=step.device).manual_seed(host_step.value(step))
        if microbatch_split > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), device=step.device)
            acc = torch.zeros((), device=step.device)
            for i in range(microbatch_split):
                mb = {k: v.reshape(microbatch_split, v.shape[0] // microbatch_split,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                (l, mets), g = value_and_grad(loss_fn, params, mb, rng)
                grads = tree_map(torch.add, grads, g)
                loss, acc = loss + l, acc + mets["accuracy"]
            grads = tree_map(lambda g: g / microbatch_split, grads)
            loss, acc = loss / microbatch_split, acc / microbatch_split
            mets = {"accuracy": acc}
        else:
            (loss, mets), grads = value_and_grad(loss_fn, params, batch, rng)
        if loss_scale != 1.0:
            grads = tree_map(lambda g: g / loss_scale, grads)
            loss = loss / loss_scale
        lr = lr_schedule(step) if callable(lr_schedule) else lr_schedule
        new_params, new_opt = optimizer.update(grads, opt, params, lr)
        new_step = step + 1
        host_step.advance(new_step)
        metrics = {"loss": loss, "lr": _f32(lr, step.device), **mets}
        return {"params": new_params, "opt": new_opt, "step": new_step}, metrics

    return train_step


def make_eval_step(model, *, policy: Optional[QuantPolicy] = None,
                   qstate=None, mesh=None, axis_rules=None) -> Callable:
    """``(params, batch) -> {"loss", "nll", "aux", "accuracy"}`` without gradients."""
    if mesh is not None or axis_rules is not None:
        raise NotImplementedError(f"make_eval_step: {_MESH_LATER}")
    policy = policy or QuantPolicy.float32()

    def eval_step(params, batch):
        batch = to_device(batch, tree_device(params))
        with torch.no_grad():
            ctx = Context(policy=policy, train=False, qstate=qstate)
            loss, mets = model.loss(params, batch, ctx)
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
