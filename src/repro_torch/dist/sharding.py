"""Mesh-axis rules: logical axes -> mesh axes -> per-leaf specs
(``repro/dist/sharding.py``).

1. :func:`make_axis_rules` gives the logical -> mesh mapping (keys
   ``batch``, ``seq``, ``heads``, ``kv_heads``, ``ff``, ``expert``,
   ``fsdp``, ``model``, ``kv_seq``, ``stage``); a value is a mesh-axis
   name, a tuple of names (composed axes) or None (replicated).
2. :func:`param_pspecs`, :func:`batch_pspecs` and :func:`cache_pspecs`
   turn the rules into a spec per leaf, by path (router and norm leaves
   stay replicated) and by shape (an axis whose size does not divide the
   dimension is dropped, never padded).

A spec is a tuple with one entry per sharded-or-not tensor dim (a name, a
tuple of names, or None), ``()`` for a replicated leaf: the reference's
``PartitionSpec`` as a plain tuple.  ``mesh`` is a ``DeviceMesh`` or an
``{axis: size}`` mapping, so specs need no process group.

Layouts, as the reference's: dense kernels ``(..., D_in, D_out)`` put
``D_in`` on ``data`` (FSDP) and ``D_out`` on ``model``; stacked leading
dims replicate; expert stacks ``(..., E, A, B)`` put E on ``model`` and the
FSDP axis on B in training, on A when serving (the weight-stationary
decode); a :class:`QTensor`'s codes shard like the float kernel and its
per-channel exponents ride the channel dim.

:func:`placements` names a spec's DTensor placements, and
:func:`shard_tree` / :func:`gather_tree` move a whole tree to this rank's
shards and back.  A dim on two axes ``("data", "model")`` is laid out
data-major: rank (d, m) holds block ``d * M + m``, which is also what
``Shard`` on both mesh dims gives.  The reference's AOT helpers
``named`` and ``with_shardings`` serve its TPU dry run and are not here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.qformat import QTensor

AxisEntry = Any      # str | tuple[str, ...] | None
Spec = Tuple[AxisEntry, ...]

# Param-path segments whose leaves stay replicated: tiny and/or
# precision-sensitive (router decision boundary, norm scales, ssm internals).
_REPLICATED_SUBSTR = ("router", "ln", "rms", "norm", "bn",
                      "a_log", "dt_", "decay")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def make_axis_rules(mesh, *, seq_shard: bool = False, decode_kv_shard: bool = True,
                    dp_only: bool = False) -> Dict[str, AxisEntry]:
    """Logical -> mesh axis rules for ``mesh``.

    ``dp_only``: every mesh axis serves data parallelism (the batch rule is
    ``("data", "model", "pod")``; parameters replicate).  ``seq_shard``:
    sequence-parallel activations (``seq`` -> ``model``).
    ``decode_kv_shard``: the KV cache's sequence dim on ``model``.
    """
    names = tuple(mesh_shape(mesh))

    def have(a):
        return a in names

    if dp_only:
        batch = tuple(a for a in ("data", "model", "pod") if have(a))
        tensor = None
        fsdp = None
    else:
        batch = tuple(a for a in ("data", "pod") if have(a))
        tensor = "model" if have("model") else None
        fsdp = "data" if have("data") else None
    return {
        "batch": batch or None,
        "fsdp": fsdp,
        "model": tensor,
        "ff": tensor,
        "heads": tensor,
        "kv_heads": tensor,
        "expert": tensor,
        "seq": tensor if seq_shard else None,
        "kv_seq": tensor if decode_kv_shard else None,
        "stage": "pod" if have("pod") else None,
    }


def _fit(mesh, axes: AxisEntry, dim: int) -> Optional[Tuple[str, ...]]:
    """The longest prefix of ``axes`` whose mesh size divides ``dim`` (and
    is above 1), or None (replicate)."""
    if axes is None or dim <= 0:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    for k in range(len(axes), 0, -1):
        size = 1
        for a in axes[:k]:
            size *= int(sizes[a])
        if size > 1 and dim % size == 0:
            return tuple(axes[:k])
    return None


def _entry(fit: Optional[Tuple[str, ...]]) -> AxisEntry:
    if fit is None:
        return None
    return fit[0] if len(fit) == 1 else tuple(fit)


def _dedupe(entries: Tuple[AxisEntry, ...]) -> Tuple[AxisEntry, ...]:
    """Drop a mesh axis that an earlier dim already uses (an axis may shard
    one dim only); a later use replicates instead."""
    used = set()
    out = []
    for e in entries:
        if e is None:
            out.append(None)
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        kept = tuple(a for a in names if a not in used)
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(kept)
    return tuple(out)


def _spec_for_path(path: str, shape, rules: Dict[str, AxisEntry], mesh,
                   serve: bool = False) -> Spec:
    """The spec of one parameter leaf, from its tree path and shape."""
    parts = path.lower().split("/")
    if any(any(s in seg for s in _REPLICATED_SUBSTR) for seg in parts):
        return ()
    ndim = len(shape)
    if ndim < 2:
        return ()
    entries: list = [None] * ndim
    if "experts" in parts and ndim >= 3:
        # (..., E, A, B): EP on E; FSDP on B (train) or A (serve)
        entries[ndim - 3] = _entry(_fit(mesh, rules.get("expert"), shape[ndim - 3]))
        fdim = ndim - 2 if serve else ndim - 1
        entries[fdim] = _entry(_fit(mesh, rules.get("fsdp"), shape[fdim]))
    else:
        # (..., D_in, D_out): FSDP on D_in, TP on D_out; stacked dims replicate
        entries[ndim - 2] = _entry(_fit(mesh, rules.get("fsdp"), shape[ndim - 2]))
        entries[ndim - 1] = _entry(_fit(mesh, rules.get("model"), shape[ndim - 1]))
    return _dedupe(tuple(entries))


def _exponent_spec(qspec: Spec, qt: QTensor) -> Spec:
    """A QTensor exponent's spec: per-channel ``n`` rides the mesh axis of
    the codes' channel dim; a scalar replicates."""
    n_ndim = getattr(qt.n, "ndim", 0)
    if n_ndim == 0:
        return ()
    q_shape = tuple(qt.q.shape)
    entries = list(qspec) + [None] * (len(q_shape) - len(qspec))
    if qt.channel_axis is not None and n_ndim == 1:
        return (entries[qt.channel_axis],)
    if n_ndim == len(q_shape):
        # broadcast-shaped exponents (per-(layer, channel) stacked kernels)
        return tuple(entries[d] if qt.n.shape[d] == q_shape[d] and qt.n.shape[d] > 1 else None
                     for d in range(n_ndim))
    return ()


def _spec_qtensor(qt: QTensor, qspec: Spec, nspec: Spec) -> QTensor:
    # a QTensor of specs: ``scale`` holds the exponent's spec too, so no
    # exponent is evaluated
    return QTensor(q=qspec, n=nspec, width=qt.width, channel_axis=qt.channel_axis, scale=nspec)


def _map_with_path(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(params, mesh, rules: Dict[str, AxisEntry], *, serve: bool = False):
    """The spec tree of a parameter (or optimizer-moment) tree.  A
    :class:`QTensor` leaf gives a QTensor whose ``q`` and ``n`` are the
    codes' and the exponents' specs."""

    def leaf_spec(path, leaf):
        if isinstance(leaf, QTensor):
            qspec = _spec_for_path(path, tuple(leaf.q.shape), rules, mesh, serve=serve)
            return _spec_qtensor(leaf, qspec, _exponent_spec(qspec, leaf))
        return _spec_for_path(path, tuple(getattr(leaf, "shape", ())), rules, mesh, serve=serve)

    return _map_with_path(leaf_spec, params)


def batch_pspecs(batch, mesh, rules: Dict[str, AxisEntry]):
    """Dim 0 of every batch leaf on the (composed) batch axes; a batch that
    does not divide takes the longest divisible prefix."""

    def leaf(_, x):
        ndim = getattr(x, "ndim", 0)
        if ndim == 0:
            return ()
        return (_entry(_fit(mesh, rules.get("batch"), x.shape[0])),) + (None,) * (ndim - 1)

    return _map_with_path(leaf, batch)


def cache_pspecs(cache, mesh, rules: Dict[str, AxisEntry]):
    """The spec tree of a decode cache: KV leaves ``k``/``v`` ``(...,
    batch, seq, heads, head_dim)`` put batch on the batch axes, seq on
    ``kv_seq`` and heads on what is left; everything else replicates."""

    def leaf_spec(path, x):
        ndim = getattr(x, "ndim", 0)
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v") and ndim >= 4:
            entries: list = [None] * ndim
            entries[ndim - 4] = _entry(_fit(mesh, rules.get("batch"), x.shape[ndim - 4]))
            entries[ndim - 3] = _entry(_fit(mesh, rules.get("kv_seq"), x.shape[ndim - 3]))
            entries[ndim - 2] = _entry(_fit(mesh, rules.get("kv_heads"), x.shape[ndim - 2]))
            return _dedupe(tuple(entries))
        return ()

    return _map_with_path(leaf_spec, cache)


def cache_rows_pspecs(cache, mesh, rules: Dict[str, AxisEntry]):
    """The cache layout the port executes: each data rank holds its batch
    rows, whole in sequence and heads (the reference's ``kv_seq`` and
    ``kv_heads`` split of :func:`cache_pspecs` is a layout the port does
    not take; ``ROADMAP.md`` queue 2)."""
    return cache_pspecs(cache, mesh, dict(rules, kv_seq=None, kv_heads=None))


# --------------------------------------------------------------------------
# Specs as placements, and whole trees to shards and back
# --------------------------------------------------------------------------

def _axes(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh axis shards tensor dim d, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def block_index(entry: AxisEntry, mesh, coord: Mapping[str, int]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim on ``entry``'s
    axes, data-major over a tuple of axes."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in _axes(entry):
        idx, n = idx * sizes[a] + int(coord[a]), n * sizes[a]
    return idx, n


def mesh_coord(mesh) -> Dict[str, int]:
    """This rank's ``{axis: index}`` on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_slice(t: torch.Tensor, spec: Spec, mesh, coord: Optional[Mapping[str, int]] = None):
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view)."""
    coord = mesh_coord(mesh) if coord is None else coord
    for d, e in enumerate(spec):
        idx, n = block_index(e, mesh, coord)
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size)
    return t


def leaves_with_specs(tree, specs) -> list:
    """[(leaf, spec)] in ``tree_leaves`` order (a spec is a tuple, so the
    spec tree is walked by the value tree's structure)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for a, b in zip(tree, specs, strict=True) for x in leaves_with_specs(a, b)]
    return [(tree, specs)]


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec (or a QTensor of specs) names."""
    if isinstance(spec, QTensor):
        return spec_axes(spec.q)
    return tuple(a for e in spec for a in _axes(e))


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, a, b) for a, b in zip(tree, specs, strict=True)]
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q, specs.q), fn(tree.n, specs.n), tree.width, tree.channel_axis)
    if not isinstance(tree, torch.Tensor):
        return tree
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, coord: Optional[Mapping[str, int]] = None):
    """Every leaf of a whole tree cut to this rank's block (contiguous
    copies, so the whole leaves can be freed)."""
    coord = mesh_coord(mesh) if coord is None else coord
    return _map_specs(lambda t, s: local_slice(t, s, mesh, coord).contiguous()
                      if any(_axes(e) for e in s) else t, tree, specs)


def gather_tree(tree, specs, mesh):
    """Every leaf of a tree of shards made whole again (collectives on
    every rank; counted as ``gather_tree`` in
    :func:`repro_torch.dist.shard_ops.collective_counts`)."""
    from repro_torch.dist import shard_ops

    def whole(t, spec):
        for d, e in enumerate(spec):
            for a in reversed(_axes(e)):
                t = shard_ops.all_gather(t, d, mesh, a, kind="gather_tree")
        return t

    return _map_specs(whole, tree, specs)


def gather_serving(params, specs, mesh):
    """A serving step's weights, gathered once a call (``serve/engine.py``):
    every leaf cut over ``data`` gathered over it (a stacked leaf's layers
    in one collective; a :class:`QTensor`'s int8 codes as codes), the
    embedding table gathered whole (it is looked up and, tied, multiplied
    whole), the expert stacks left as they are (the weight-stationary MoE
    multiplies its slices of their contracting dims).  The columns cut over
    ``model`` stay cut: ``Dense`` multiplies its block of them.  ``specs``:
    the whole tree's, float or QTensor specs (``param_pspecs``).  Each call
    is counted as kind ``"gather"`` (:func:`repro_torch.dist.shard_ops.
    collective_counts`); a gloo call costs milliseconds whatever its size,
    so this makes a step's few large calls of what the layers would gather
    call by call."""
    from repro_torch.dist import shard_ops

    def whole(t, spec, axes):
        for d, e in enumerate(spec):
            for a in reversed(_axes(e)):
                if a in axes:
                    # contiguous: the kernels take a layer's codes as they lie
                    t = shard_ops.all_gather(t, d, mesh, a).contiguous()
        return t

    def walk(node, spec, path):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, sp, f"{path}/{i}")
                    for i, (v, sp) in enumerate(zip(node, spec, strict=True))]
        if "experts" in path.split("/"):
            return node
        axes = ("data", "model") if path == "embed/table" else ("data",)
        if isinstance(node, QTensor):
            qspec = spec.q if isinstance(spec, QTensor) else spec
            nspec = _exponent_spec(qspec, node)
            return QTensor(whole(node.q, qspec, axes), whole(node.n, nspec, axes), node.width,
                           node.channel_axis, whole(node.scale, nspec, axes))
        if isinstance(node, torch.Tensor):
            return whole(node, spec, axes)
        return node

    return walk(params, specs, "")


def sharded(spec) -> bool:
    """Whether a spec (or a QTensor of specs) names any mesh axis."""
    if isinstance(spec, QTensor):
        return sharded(spec.q)
    return any(_axes(e) for e in spec)
