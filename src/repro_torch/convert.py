"""Carry parameter trees across from the JAX package as numpy arrays.

The port never imports ``repro``: a caller flattens the reference's tree
into nested dicts/lists of numpy arrays (stacked layers keep their leading
axis) and hands it here.  A quantized leaf arrives as any object with
``q``/``n``/``width`` attributes (the reference's ``QTensor`` itself will
do) or as a dict with those keys, optionally with ``channel_axis``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qformat import QTensor

_QKEYS = {"q", "n", "width"}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _qtensor(q, n, width, channel_axis, device) -> QTensor:
    return QTensor(_tensor(q, device), _tensor(n, device).to(torch.int32), int(width),
                   None if channel_axis is None else int(channel_axis))


def params_from_numpy(tree, device):
    """The port's parameter tree for a numpy tree from the reference."""
    if isinstance(tree, dict):
        if _QKEYS <= set(tree):
            return _qtensor(tree["q"], tree["n"], tree["width"],
                            tree.get("channel_axis"), device)
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if all(hasattr(tree, a) for a in _QKEYS):
        return _qtensor(tree.q, tree.n, tree.width, getattr(tree, "channel_axis", None),
                        device)
    return _tensor(tree, device)
