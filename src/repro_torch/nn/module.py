"""Minimal module substrate (``repro/nn/module.py``) plus device selection.

Parameters are nested dicts/lists of tensors (or :class:`QTensor` and
:class:`PackedQTensor` leaves once a model is integerized), laid out exactly
as the JAX package lays them out, so converted JAX parameters drive the port
unchanged.  Stacked layers keep their leading layer axis; :func:`tree_layer`
takes one layer's views and :func:`tree_unstack` all of them at once.  A :class:`Context` carries the quantization
policy, the frozen activation exponents (``qstate``) and the range
statistics a CALIB or QAT forward records; a training context also carries
an explicit ``torch.Generator`` and the auxiliary losses the layers add.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.policy import QMode, QuantPolicy
from repro_torch.core.qformat import PackedQTensor, QTensor

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DataRows:
    """Where a serving forward's token rows sit in the one-device batch
    under a data split (``Context.rows``): the forwards whose token set is
    not each data rank's own rows (a chunk or a one-shot prompt that one
    data rank's slot owns, a ragged tick's flat batch).  ``select`` (N,)
    int64: the N one-device tokens, as indices into the tokens of every
    data rank gathered over ``data`` (data-rank-major); ``take`` (n,)
    int64: this rank's n tokens, as indices into those N.  The
    weight-stationary MoE routes the N tokens as the one device does
    (``nn/moe.py``); the other layers keep this rank's rows."""

    select: torch.Tensor
    take: torch.Tensor


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
    policy, the train flag, the random generator (``rng``, a
    ``torch.Generator``; torch's streams are not jax's), frozen activation
    exponents ``{site: n}``, the range statistics ``{site: max|x|}`` and the
    auxiliary losses recorded this call, the scope path (names line up
    with the reference's quant sites) and the data-parallel ``group``."""

    policy: QuantPolicy = dataclasses.field(default_factory=QuantPolicy.float32)
    train: bool = False
    rng: Optional[torch.Generator] = None
    qstate: Optional[Dict[str, torch.Tensor]] = None
    stats: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # Auxiliary losses accumulated additively (summed across sites and layers).
    losses: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    path: str = ""
    # The data-parallel process group whose ranks hold slices of one batch:
    # a live activation range is the group's (the reference's max over the
    # whole batch under a data mesh).  None on one rank.
    group: Any = None
    # The sharded execution: a (data, model) DeviceMesh and the axis rules
    # (``dist.sharding.make_axis_rules``).  Each rank holds its shards of
    # the parameters and its rows of the batch; activations are replicated
    # over ``model``.  The reference's ``constrain`` (a layout directive to
    # its partitioner) has no counterpart: the layers state their
    # collectives (``dist.shard_ops``) where they use a sharded weight.
    mesh: Any = None
    axis_rules: Optional[Dict[str, Any]] = None
    # Under a mesh, a serving forward whose tokens are not this rank's own
    # rows of the batch (:class:`DataRows`); None: its own rows.
    rows: Optional[DataRows] = None
    # Under a mesh, a decode over a paged pool split into one block a data
    # rank: where this rank reads the one device's pool page 0
    # (``nn/attention.py`` ``PageZero``); None: its own page 0.
    page_zero: Any = None

    def _axis_size(self, logical: str) -> int:
        """The mesh size of a logical axis (1 without a mesh or rules); a
        rule naming an axis the mesh lacks raises ``KeyError``, as the
        reference's does."""
        if self.mesh is None or self.axis_rules is None:
            return 1
        ax = self.axis_rules.get(logical)
        if ax is None:
            return 1
        from repro_torch.dist.sharding import mesh_shape

        sizes = mesh_shape(self.mesh)
        size = 1
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            size *= int(sizes[a])
        return size

    @property
    def dp_size(self) -> int:
        """The data-parallel degree (the MoE routing groups)."""
        return self._axis_size("batch")

    @property
    def tp_size(self) -> int:
        """The tensor-parallel degree (the ``model`` rule's size)."""
        return self._axis_size("model")

    def rule(self, logical: str) -> Optional[str]:
        """The one mesh axis of a logical axis under a mesh, else None."""
        if self.mesh is None or self.axis_rules is None:
            return None
        ax = self.axis_rules.get(logical)
        if isinstance(ax, (tuple, list)):
            if len(ax) != 1:
                raise NotImplementedError(f"the rule {logical!r} -> {ax}: a weight dim on "
                                          "composed mesh axes is not executed")
            ax = ax[0]
        return ax

    def scope(self, name: str) -> "Context":
        """Child context with ``name`` appended to the naming path; it shares
        the parent's ``stats`` and ``losses``."""
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

    def add_loss(self, name: str, value: torch.Tensor) -> None:
        """Accumulate an auxiliary loss term (summed across sites and layers)."""
        self.losses[name] = self.losses[name] + value if name in self.losses else value

    def fold_rng(self, name: str) -> Optional[torch.Generator]:
        """A new generator on ``rng``'s device, seeded from ``rng``'s seed
        (the step, in a training step) and the crc32 of the scoped name, so
        every site draws its own deterministic stream."""
        if self.rng is None:
            return None
        digest = zlib.crc32(self.key(name).encode()) & 0x7FFFFFFF
        gen = torch.Generator(device=self.rng.device)
        return gen.manual_seed((self.rng.initial_seed() * 1_000_003 + digest) & 0x7FFF_FFFF_FFFF)


def eval_context(policy: Optional[QuantPolicy] = None, **kw) -> Context:
    """A non-training :class:`Context` (float32 policy unless given)."""
    return Context(policy=policy or QuantPolicy.float32(), train=False, **kw)


def train_context(policy: Optional[QuantPolicy] = None, rng: Optional[torch.Generator] = None,
                  **kw) -> Context:
    """A training :class:`Context` carrying ``rng`` for dropout."""
    return Context(policy=policy or QuantPolicy.float32(), train=True, rng=rng, **kw)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply ``fn`` to every leaf (tensors and quantized leaves) of a
    dict/list tree, or leaf by leaf to several trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest, strict=True)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a dict/list tree in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_device(tree) -> torch.device:
    """The device of a tree's first tensor (a quantized leaf's codes)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            return leaf.q.device
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("tree_device: the tree holds no tensor")


def tree_unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


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


def tree_unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of views into the
    stacked storage.  A tensor leaf is split once with ``unbind``, whose
    backward stacks the layers' gradients into one tensor; indexing it per
    layer would make every layer's gradient a zero-filled copy of the whole
    stack, added up n times."""
    def split(leaf):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            return [leaf.layer(i) for i in range(n)]
        if isinstance(leaf, torch.Tensor):
            return leaf.unbind(0)
        return [leaf] * n
    leaves = [split(leaf) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [parts[i] for parts in leaves]) for i in range(n)]


def tree_to(tree, device):
    """Move every tensor leaf to ``device`` (no copy where already there)."""
    def move(leaf):
        if isinstance(leaf, (torch.Tensor, QTensor, PackedQTensor)):
            return leaf.to(device)
        return leaf
    return tree_map(move, tree)
