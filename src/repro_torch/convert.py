"""Carry parameter trees across from the JAX package as numpy arrays.

The port never imports ``repro``: a caller flattens the reference's tree
into nested dicts/lists of numpy arrays (stacked layers keep their leading
axis) and hands it here.  A quantized leaf arrives as any object with
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
