"""Weight-only integerization for serving (``repro/core/integerize.py``).

GEMM ``kernel`` and embedding ``table`` leaves become :class:`QTensor`
leaves with per-channel pow2 exponents (8, 9 or 16 bits), or, at 4 and 2
bits, GEMM kernels pack into :class:`PackedQTensor` leaves; norms and
everything else stay float.
"""
from __future__ import annotations

from typing import Dict, Optional

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


def integerize_weights_only(params, *, bits: int = 8, per_channel: bool = True,
                            block_size: Optional[int] = None) -> Dict:
    """Weight-only integer conversion (embeddings included).

    ``bits`` 8/9/16 give :class:`QTensor` leaves.  ``bits`` 4/2 pack GEMM
    ``kernel`` leaves along K into :class:`PackedQTensor` containers, with
    per-channel scales or, given ``block_size``, per-block ones; embedding
    ``table`` leaves stay unpacked :class:`QTensor` at the logical width
    (the gather and tied-logits paths index their rows).
    ``per_channel``: one exponent per output channel; stacked leaves (the
    layer axis in front) keep every leading index distinct, so each layer
    gets its own Qm.n grid.
    """
    packed = bits in (2, 4)
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
                if packed and k == "kernel":
                    out[k] = qformat.quantize_tensor_packed(
                        v, bits, block_size=block_size, per_channel=per_channel)
                    continue
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
