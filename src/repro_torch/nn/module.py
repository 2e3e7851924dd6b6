"""Minimal module substrate (``repro/nn/module.py``) plus device selection.

Parameters are nested dicts/lists of tensors (or :class:`QTensor` and
:class:`PackedQTensor` leaves once a model is integerized), laid out exactly
as the JAX package lays them out, so converted JAX parameters drive the port
unchanged.  Stacked layers keep their leading layer axis; :func:`tree_layer`
takes one layer's views.  A :class:`Context` carries the quantization
policy, the frozen activation exponents (``qstate``) and the range
statistics a CALIB or QAT forward records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.policy import QMode, QuantPolicy
from repro_torch.core.qformat import PackedQTensor, QTensor

Params = Dict[str, Any]


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Without a card and without an explicit choice this
    raises; nothing falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU by "
                "default; pass device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} asked for, but no CUDA device is visible")
    return dev


@dataclasses.dataclass
class Context:
    """Per-call state threaded through every module: the quantization
    policy, the train flag, frozen activation exponents ``{site: n}``, the
    range statistics ``{site: max|x|}`` recorded this call, and the scope
    path (names line up with the reference's quant sites)."""

    policy: QuantPolicy = dataclasses.field(default_factory=QuantPolicy.float32)
    train: bool = False
    qstate: Optional[Dict[str, torch.Tensor]] = None
    stats: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    path: str = ""

    def scope(self, name: str) -> "Context":
        """Child context with ``name`` appended to the naming path; it shares
        the parent's ``stats``."""
        return dataclasses.replace(self, path=f"{self.path}/{name}" if self.path else name)

    def key(self, name: str) -> str:
        """Fully scoped name of a quant site under the current path."""
        return f"{self.path}/{name}" if self.path else name

    @property
    def collecting(self) -> bool:
        """Whether range statistics are gathered (CALIB and QAT modes)."""
        return self.policy.mode in (QMode.CALIB, QMode.QAT)

    def record(self, name: str, value: torch.Tensor) -> None:
        """Fold max|value| (float32, on the value's device) into the site's
        statistic."""
        k = self.key(name)
        v = torch.amax(torch.abs(value.detach())).to(torch.float32)
        self.stats[k] = torch.maximum(self.stats[k], v) if k in self.stats else v

    def frozen(self, name: str) -> Optional[torch.Tensor]:
        """The site's frozen activation exponent, if calibrated."""
        if self.qstate is None:
            return None
        return self.qstate.get(self.key(name))


def eval_context(policy: Optional[QuantPolicy] = None, **kw) -> Context:
    """A non-training :class:`Context` (float32 policy unless given)."""
    return Context(policy=policy or QuantPolicy.float32(), train=False, **kw)


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf (tensors and quantized leaves) of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a dict/list tree in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param_count(params) -> int:
    """Scalar parameters in a tree (a quantized leaf counts its codes and
    exponents)."""
    return sum(t.numel() for t in _storage(params))


def param_bytes(params) -> int:
    """Storage bytes of a tree (int8 counts 1)."""
    return sum(t.numel() * t.element_size() for t in _storage(params))


def _storage(params) -> list:
    out = []
    for leaf in tree_leaves(params):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            out += [leaf.q, leaf.n]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def tree_layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views into the stacked storage)."""
    def take(leaf):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            return leaf.layer(i)
        if isinstance(leaf, torch.Tensor):
            return leaf[i]
        return leaf
    return tree_map(take, tree)


def tree_to(tree, device):
    """Move every tensor leaf to ``device`` (no copy where already there)."""
    def move(leaf):
        if isinstance(leaf, (torch.Tensor, QTensor, PackedQTensor)):
            return leaf.to(device)
        return leaf
    return tree_map(move, tree)
