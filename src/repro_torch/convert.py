"""Carry parameter trees across from the JAX package as numpy arrays, and
back.

The port never imports ``repro``: a caller flattens the reference's tree
into nested dicts/lists of numpy arrays (stacked layers keep their leading
axis) and hands it here.  Optimizer states and whole training states
convert the same way: the optimizers keep the reference's state trees
(``{"m"}``, ``{"m", "v", "t"}`` with ``t`` a 0-d int32 array), so
:func:`params_from_numpy` carries ``m``, ``v`` and ``t`` across as they
are.  :func:`params_to_numpy` gives the port's tree back as numpy arrays.  A quantized leaf arrives as any object with
``q``/``n``/``width`` attributes (the reference's ``QTensor`` itself will
do) or as a dict with those keys, optionally with ``channel_axis``; one
that also has ``k`` and ``block_size`` (the reference's ``PackedQTensor``)
is a packed sub-int8 leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qformat import PackedQTensor, QTensor

_QKEYS = {"q", "n", "width"}
_PACKED_KEYS = _QKEYS | {"k", "block_size"}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf(get, keys, device):
    q, n = _tensor(get("q"), device), _tensor(get("n"), device).to(torch.int32)
    if _PACKED_KEYS <= keys:
        bs = get("block_size")
        return PackedQTensor(q, n, int(get("width")), int(get("k")),
                             None if bs is None else int(bs))
    ca = get("channel_axis") if "channel_axis" in keys else None
    return QTensor(q, n, int(get("width")), None if ca is None else int(ca))


def params_from_numpy(tree, device):
    """The port's parameter tree for a numpy tree from the reference."""
    if isinstance(tree, dict):
        if _QKEYS <= set(tree):
            return _leaf(tree.get, set(tree), device)
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    keys = {a for a in _PACKED_KEYS | {"channel_axis"} if hasattr(tree, a)}
    if _QKEYS <= keys:
        return _leaf(lambda a: getattr(tree, a), keys, device)
    return _tensor(tree, device)


def params_to_numpy(tree):
    """The port's tree as nested dicts/lists of numpy arrays; a quantized
    leaf becomes a dict of its fields (the form :func:`params_from_numpy`
    reads back)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, PackedQTensor):
        return {"q": tree.q.cpu().numpy(), "n": tree.n.cpu().numpy(), "width": tree.width,
                "k": tree.k, "block_size": tree.block_size}
    if isinstance(tree, QTensor):
        return {"q": tree.q.cpu().numpy(), "n": tree.n.cpu().numpy(), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
