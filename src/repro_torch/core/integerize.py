"""Weight-only integerization for serving (``repro/core/integerize.py``).

GEMM ``kernel`` and embedding ``table`` leaves become int8 :class:`QTensor`
leaves with per-channel pow2 exponents; norms and everything else stay
float.  Packed int4/int2 weights wait for the sub-int8 slice of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import QuantPolicy

_WEIGHT_LEAVES = ("kernel", "table")
# Path segments whose leaves stay float (norms, router, ssm internals).
_SKIP_SUBSTR = ("ln", "rms", "norm", "router", "ssm", "bn", "a_log", "dt_", "decay")


def _is_skipped(path: str, policy: QuantPolicy) -> bool:
    parts = path.lower().split("/")
    return any(any(s in seg for s in _SKIP_SUBSTR) for seg in parts[:-1]) or any(
        k in parts for k in policy.skip_kinds)


def integerize_weights_only(params, *, bits: int = 8, per_channel: bool = True) -> Dict:
    """Weight-only int8 conversion (embeddings included).

    ``per_channel``: one exponent per output channel; stacked leaves (the
    layer axis in front) keep every leading index distinct, so each layer
    gets its own Qm.n grid.
    """
    if bits != 8:
        raise NotImplementedError(
            f"bits={bits}: packed sub-int8 weights arrive with the int4 slice "
            "of the port (ROADMAP.md queue 1)")
    policy = QuantPolicy.serve_int8()

    def rec(node, path):
        if isinstance(node, (list, tuple)):
            return [rec(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            child_path = f"{path}/{k}" if path else k
            if isinstance(v, (dict, list, tuple)):
                out[k] = rec(v, child_path)
            elif (k in _WEIGHT_LEAVES and isinstance(v, torch.Tensor) and v.ndim >= 2
                  and not _is_skipped(child_path, policy)):
                if per_channel:
                    ca = (tuple(range(v.ndim - 2)) + (v.ndim - 1,)
                          if v.ndim > 2 else v.ndim - 1)
                else:
                    ca = None
                out[k] = qformat.quantize_tensor(v, bits, channel_axis=ca)
            else:
                out[k] = v
        return out

    return rec(params, "")
