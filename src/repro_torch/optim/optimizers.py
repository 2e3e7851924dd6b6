"""Optimizers as pure (init, update) pairs on nested-dict parameter trees
(``repro/optim/optimizers.py``).

SGD with momentum and weight decay is the paper's choice (Sec. 6), AdamW
the LM examples'.  The state trees are the reference's: ``{"m"}`` for SGD
with momentum, ``{}`` without, ``{"m", "v", "t"}`` for AdamW, so a state
converts across (``repro_torch.convert``) and checkpoints.  The arithmetic
is the reference's, in its float32 order.  :class:`multistep_lr` mirrors
the paper's schedules (e.g. UCI-HAR: x0.13 at epochs 100/200/250).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.nn.module import tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state)


def _lr(lr, like: torch.Tensor) -> torch.Tensor:
    """The learning rate as a float32 tensor on the parameters' device (a
    fill for a Python number, so nothing is copied from the host)."""
    if isinstance(lr, torch.Tensor):
        return lr.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(lr), dtype=torch.float32, device=like.device)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD; the decay is added to the gradient before the momentum."""
    def init(params):
        return {} if momentum == 0.0 else {"m": tree_map(_zeros, params)}

    def update(grads, state, params, lr):
        lr = _lr(lr, tree_leaves(params)[0])

        def leaf(g, p, m=None):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            if m is None:
                step, new_m = g, None
            else:
                new_m = momentum * m + g
                step = g + momentum * new_m if nesterov else new_m
            return (p.to(torch.float32) - lr * step).to(p.dtype), new_m

        if momentum == 0.0:
            return tree_map(lambda g, p: leaf(g, p)[0], grads, params), {}
        outs = [leaf(*a) for a in zip(tree_leaves(grads), tree_leaves(params),
                                      tree_leaves(state["m"]), strict=True)]
        return (tree_unflatten(params, [o[0] for o in outs]),
                {"m": tree_unflatten(params, [o[1] for o in outs])})

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW: bias-corrected (m/c1)/(sqrt(v/c2)+eps), the decay added to the
    step after the normalization."""
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        lr = _lr(lr, state["t"])
        t = state["t"] + 1
        tf = t.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, tf)
        c2 = 1.0 - torch.pow(b2, tf)

        def leaf(g, p, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

        outs = [leaf(*a) for a in zip(tree_leaves(grads), tree_leaves(params),
                                      tree_leaves(state["m"]), tree_leaves(state["v"]),
                                      strict=True)]
        unf = lambda i: tree_unflatten(params, [o[i] for o in outs])  # noqa: E731
        return unf(0), {"m": unf(1), "v": unf(2), "t": t}

    return Optimizer(init, update)


@dataclasses.dataclass(frozen=True)
class multistep_lr:
    """Paper-style schedule: base_lr x gamma^(milestones passed), with an
    optional linear warmup.  A step tensor gives a float32 tensor on its
    device, computed there (``torch.where``; nothing is read back); a Python
    int gives a CPU tensor."""

    base_lr: float
    milestones: Sequence[int] = ()
    gamma: float = 0.1
    warmup_steps: int = 0

    def __call__(self, step) -> torch.Tensor:
        if isinstance(step, torch.Tensor):
            step = step.to(torch.float32)
        else:
            step = torch.full((), float(step), dtype=torch.float32)
        lr = torch.full_like(step, self.base_lr)
        for m in self.milestones:
            lr = torch.where(step >= m, lr * self.gamma, lr)
        if self.warmup_steps:
            lr = lr * torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        return lr
