"""The dry-run account's arithmetic (``repro/launch/analysis.py``): bytes a
device, FLOPs and collective wire bytes.

The reference parses XLA's optimized HLO; the port runs its step eagerly
on ``meta`` tensors and counts what the step does:

* :func:`tree_bytes` and :func:`memory_stats`: argument, output and alias
  bytes a device, summed from the meta trees (each leaf already cut to this
  rank's shard);
* :func:`count_flops` and :func:`cost_stats`: ``FlopCounterMode`` over the
  step.  On ``meta`` the kernels' entry points (``kernels/ops.py``) take
  their plain versions, so a kernel's products are counted as the plain
  version's matmuls; only matmuls, convolutions and attention are counted,
  where XLA's figure counts elementwise work too;
* :func:`counting_collectives`: every ``torch.distributed`` collective the
  step makes, as the reference's ``{op: {count, result_bytes,
  wire_bytes}}``, by the reference's ring rules (:func:`wire_bytes`), per
  mesh axis and summed.  It counts at the ``torch.distributed`` calls,
  where ``dist.shard_ops.collective_counts()`` sees only the layers'
  collectives (not the gradient all-reduce of ``dist/compress.py``, the
  metrics' mean or QAT's range MAX) and the bytes this rank hands them;
  the reference counts the result: an all-gather's is its input times the
  group, a reduce-scatter's its input over the group.

No temp or peak bytes are claimed: no compiler plans them here; the card
measures them (``chip_smoke.py`` ``[account]``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator

import torch

from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.nn.module import tree_leaves

# the torch.distributed calls the steps make -> the HLO collective each is,
# with the argument that holds its result
_CALLS = {"all_reduce": ("all-reduce", "tensor"),
          "all_gather_into_tensor": ("all-gather", "output_tensor"),
          "reduce_scatter_tensor": ("reduce-scatter", "output"),
          "broadcast": ("broadcast", "tensor")}


def wire_bytes(op: str, result_bytes: float, group: int) -> float:
    """Bytes one participant puts on the wire for a collective of
    ``result_bytes`` over ``group`` ranks (the reference's ring rules,
    its ``max(n - 1, 1)`` at a group of 1 included)."""
    if op == "all-reduce":
        return 2 * result_bytes * max(group - 1, 1) / max(group, 1)
    if op == "reduce-scatter":
        return result_bytes * max(group - 1, 1)
    if op == "collective-permute":
        return result_bytes
    if op in ("all-gather", "all-to-all"):
        return result_bytes * max(group - 1, 1) / max(group, 1)
    raise ValueError(f"unknown collective {op!r}")


@contextlib.contextmanager
def counting_collectives(mesh) -> Iterator[Dict[str, Any]]:
    """Count every collective the code inside makes through
    ``torch.distributed`` (the layers' ``dist.shard_ops``, the gradient
    all-reduce of ``dist/compress.py``, the metrics' mean, QAT's range MAX):
    yields ``{"by_axis": {axis: {op: {count, result_bytes, wire_bytes}}},
    "total": {op: ...}}``, filled as the calls are made.  A group is named
    by the mesh axis it spans (``"world"`` for the default group)."""
    import inspect

    import torch.distributed as dist

    axes = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names} \
        if mesh is not None else {}
    out: Dict[str, Any] = {"by_axis": {}, "total": {}}
    saved = {name: getattr(dist, name) for name in _CALLS}

    def counted(name):
        fn, (op, result_arg) = saved[name], _CALLS[name]
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            group = bound.get("group")
            t = bound[result_arg]
            rb = t.numel() * t.element_size()
            n = dist.get_world_size(group)
            axis = "world" if group is None else axes.get(group.group_name, group.group_name)
            wire = wire_bytes("all-gather" if op == "broadcast" else op, rb, n)
            for d in (out["by_axis"].setdefault(axis, {}).setdefault(op, _zero()),
                      out["total"].setdefault(op, _zero())):
                d["count"] += 1
                d["result_bytes"] += rb
                d["wire_bytes"] += wire
            return fn(*args, **kwargs)
        return call

    try:
        for name in _CALLS:
            setattr(dist, name, counted(name))
        yield out
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _zero() -> Dict[str, float]:
    return {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}


def total_wire_bytes(collectives: Dict[str, Dict[str, float]]) -> float:
    return sum(d["wire_bytes"] for d in collectives.values())


def _tensors(tree) -> list:
    """Every tensor a tree holds (a quantized leaf's codes, exponents and
    scales); host ints and None hold no device bytes."""
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            out += [t for t in (leaf.q, leaf.n, leaf.scale) if isinstance(t, torch.Tensor)]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (its storage as laid out: one
    device's shards)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def scale_bytes(tree) -> int:
    """Bytes of the quantized leaves' ``scale`` tensors: 2^-n, which the
    port keeps beside each exponent and the reference computes when used."""
    return sum(leaf.scale.numel() * leaf.scale.element_size() for leaf in tree_leaves(tree)
               if isinstance(leaf, (QTensor, PackedQTensor))
               and isinstance(leaf.scale, torch.Tensor))


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


def memory_stats(args, outputs) -> Dict[str, int]:
    """Argument and output bytes a device, and the bytes of outputs that
    share an argument's storage (the port's in-place cache writes: the
    reference's donated, aliased buffers)."""
    held = _storages(args)
    alias = sum(t.numel() * t.element_size() for t in _tensors(outputs)
                if t.untyped_storage()._cdata in held)
    return {"argument_size_in_bytes": tree_bytes(args),
            "output_size_in_bytes": tree_bytes(outputs),
            "alias_size_in_bytes": alias}


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops, {op: flops})`` under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(k): int(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return out, int(counter.get_total_flops()), by_op


def cost_stats(flops: int, by_op: Dict[str, int]) -> Dict[str, Any]:
    return {"flops": float(flops), "flops_by_op": by_op,
            "counted": "matmul, convolution and attention ops of the step on meta (the "
                       "kernels' plain versions); elementwise work is not counted"}
