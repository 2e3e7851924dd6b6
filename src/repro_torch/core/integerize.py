"""Conversion of a float parameter tree to deployed integer form
(``repro/core/integerize.py``).

* :func:`integerize`: the paper's full integer engine (Sec. 5.8): kernels
  and biases to int8/int16 :class:`QTensor` leaves with pow2 exponents, and
  each quantized layer's calibrated output exponent baked beside it as
  ``n_out``; activations then flow as :class:`QTensor`.
* :func:`integerize_weights_only`: serving: GEMM ``kernel`` and embedding
  ``table`` leaves become :class:`QTensor` leaves with per-channel pow2
  exponents (8, 9 or 16 bits), or, at 4 and 2 bits, GEMM kernels pack into
  :class:`PackedQTensor` leaves; norms and everything else stay float.
* :func:`fake_int8_weights`: int8-gather training: the same leaves through
  the STE quantizer ``ste_int8_weight`` inside a training step.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import Granularity, QuantPolicy
from repro_torch.core.qformat import PackedQTensor, QTensor

_WEIGHT_LEAVES = ("kernel", "table")
_BIAS_LEAVES = ("bias",)
# Path segments whose leaves stay float (norms, router, ssm internals).
_SKIP_SUBSTR = ("ln", "rms", "norm", "router", "ssm", "bn", "a_log", "dt_", "decay")


def _is_skipped(path: str, policy: QuantPolicy) -> bool:
    parts = path.lower().split("/")
    return any(any(s in seg for s in _SKIP_SUBSTR) for seg in parts[:-1]) or any(
        k in parts for k in policy.skip_kinds)


def integerize(params, policy: QuantPolicy, qstate: Optional[Dict] = None, *,
               param_path_to_site: Optional[Dict[str, str]] = None) -> Dict:
    """Full integer conversion (the paper's deployment, Sec. 5.8).

    ``qstate`` maps quant-site paths to frozen output exponents.  A layer
    dict with a quantized kernel gains ``n_out``: the per-network exponent,
    or its site ``<layer path>/out`` (remapped by ``param_path_to_site``),
    else the first ``qstate`` key that ends with it.
    """
    wb = policy.weight_bits
    n_net = policy.network_frac_bits if policy.granularity is Granularity.PER_NETWORK else None
    per_ch = policy.granularity is Granularity.PER_CHANNEL
    qstate = qstate or {}

    def site_for(layer_path: str, device):
        key = f"{layer_path}/out" if layer_path else "out"
        if param_path_to_site and layer_path in param_path_to_site:
            key = param_path_to_site[layer_path]
        found = qstate.get(key)
        if found is None:
            found = next((v for k, v in qstate.items() if k.endswith(key)), None)
        return None if found is None else qformat.on_device(found, device)

    def rec(node, path):
        if isinstance(node, (list, tuple)):
            return [rec(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {}
        has_weight = any(k in node for k in _WEIGHT_LEAVES)
        for k, v in node.items():
            child_path = f"{path}/{k}" if path else k
            if isinstance(v, (dict, list, tuple)):
                out[k] = rec(v, child_path)
            elif k in _WEIGHT_LEAVES and not _is_skipped(child_path, policy):
                out[k] = qformat.quantize_tensor(v, wb, channel_axis=v.ndim - 1 if per_ch else None,
                                                 n_override=n_net)
            elif k in _BIAS_LEAVES and has_weight and not _is_skipped(child_path, policy):
                # operand width with its own exponent, aligned into the int32
                # accumulator at run time (paper Sec. 5.8)
                out[k] = qformat.quantize_tensor(v, wb, n_override=n_net)
            else:
                out[k] = v
        quantized = [x for x in out.values() if isinstance(x, QTensor)]
        if has_weight and quantized:
            dev = quantized[0].q.device
            n_out = (torch.full((), n_net, dtype=torch.int32, device=dev) if n_net is not None
                     else site_for(path, dev))
            if n_out is not None:
                out["n_out"] = n_out
        return out

    return rec(params, "")


def fake_int8_weights(params, *, mesh=None, rules=None) -> Dict:
    """int8-gather training: every GEMM ``kernel`` and embedding ``table``
    leaf that :func:`integerize_weights_only` would quantize passes through
    :func:`repro_torch.core.quantizers.ste_int8_weight` (materialized int8
    codes, one exponent per output channel and per stacked index; STE
    backward).  The float master parameters stay untouched.  The reference
    also pins the int8 codes to a mesh's sharding; ``mesh``/``rules`` wait
    for the distribution slice."""
    from repro_torch.core.quantizers import ste_int8_weight

    if mesh is not None or rules is not None:
        raise NotImplementedError("fake_int8_weights on a mesh waits for the port's "
                                  "distribution slice (ROADMAP.md queue 1)")
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
            elif (k in _WEIGHT_LEAVES and not _is_skipped(child_path, policy)
                  and isinstance(v, torch.Tensor) and v.ndim >= 2):
                out[k] = ste_int8_weight(v, tuple(range(v.ndim - 2)) + (v.ndim - 1,))
            else:
                out[k] = v
        return out

    return rec(params, "")


def quantize_input(x: torch.Tensor, qstate: Dict, site: str, width: int) -> QTensor:
    """The entry-point conversion the engine expects from its caller
    (Sec. 5.6: ``x_fixed = clamp(x_float << INPUT_SCALE_FACTOR)``)."""
    n = qformat.on_device(qstate[site], x.device)
    return QTensor(qformat.quantize(x, n, width), n, width)


def model_rom_bytes(params) -> int:
    """Deployed model size at logical widths (paper Table A3): quantized
    leaves count their logical payload plus 4 bytes per exponent, float
    leaves their storage."""
    from repro_torch.nn.module import tree_leaves

    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, (QTensor, PackedQTensor)):
            total += leaf.nbytes_model + 4 * leaf.n.numel()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


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
