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


def fake_int8_weights(params, *, mesh=None, rules=None, specs=None) -> Dict:
    """int8-gather training: every GEMM ``kernel`` and embedding ``table``
    leaf that :func:`integerize_weights_only` would quantize passes through
    :func:`repro_torch.core.quantizers.ste_int8_weight` (materialized int8
    codes, one exponent per output channel and per stacked index; STE
    backward).  The float master parameters stay untouched.

    Under a mesh (``mesh``, ``rules``, and ``specs``: ``param_pspecs`` of
    the whole tree, which the shards' shapes cannot tell) ``params`` holds
    this rank's shards and the quantizer crosses the wire in int8, as the
    reference pins its codes to the master's sharding: each exponent from
    the max over every rank that holds part of its reduction (an
    all-reduce MAX), the local codes quantized with it, the **int8 codes**
    gathered over ``data`` (a table, used whole, over every axis) and
    dequantized after the gather.  The backward is the gathers' own (the
    gradient's reduce-scatter over ``data``, this rank's block over
    ``model``).  The codes equal one device's bit for bit."""
    from repro_torch.core.quantizers import ste_int8_weight

    if (mesh is None) != (rules is None) or (mesh is not None and specs is None):
        raise ValueError("fake_int8_weights under a mesh takes mesh, rules and specs")
    policy = QuantPolicy.serve_int8()

    def rec(node, spec, path):
        if isinstance(node, (list, tuple)):
            return [rec(v, None if spec is None else spec[i], f"{path}/{i}")
                    for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            child_path = f"{path}/{k}" if path else k
            child = None if spec is None else spec[k]
            if isinstance(v, (dict, list, tuple)):
                out[k] = rec(v, child, child_path)
            elif (k in _WEIGHT_LEAVES and not _is_skipped(child_path, policy)
                  and isinstance(v, torch.Tensor) and v.ndim >= 2):
                keep = tuple(range(v.ndim - 2)) + (v.ndim - 1,)
                if child:
                    out[k] = _gathered_int8(v, keep, child, mesh, whole=k == "table")
                else:
                    out[k] = ste_int8_weight(v, keep)
            else:
                out[k] = v
        return out

    return rec(params, specs, "")


class _GatheredSTE(torch.autograd.Function):
    """The dequantized gathered codes forward; the gathers' backward."""

    @staticmethod
    def forward(ctx, x, deq, mesh, plan):
        ctx.args = (mesh, plan)
        return deq

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist import shard_ops

        mesh, plan = ctx.args
        for dim, axis, fsdp in reversed(plan):
            g = (shard_ops.reduce_scatter(g, dim, mesh, axis) if fsdp
                 else shard_ops.own_block(g, dim, mesh, axis).contiguous())
        return g, None, None, None


def _gathered_int8(v: torch.Tensor, keep: tuple, spec, mesh, whole: bool) -> torch.Tensor:
    """One leaf of :func:`fake_int8_weights` under a mesh (see there)."""
    from repro_torch.dist import shard_ops
    from repro_torch.dist.sharding import _axes

    reduced = tuple(a for a in range(v.ndim) if a not in keep)
    entries = list(spec) + [None] * (v.ndim - len(spec))
    m = qformat.max_abs(v.detach(), reduced, keepdim=True).to(torch.float32)
    m = shard_ops.pmax(m, mesh, [a for d in reduced for a in _axes(entries[d])])
    n = qformat.frac_bits_for(m, 8)
    q, plan = qformat.quantize(v.detach(), n, 8), []
    for d, e in enumerate(entries):
        for axis in reversed(_axes(e)):
            if axis != "data" and not whole:
                continue
            q = shard_ops.all_gather(q, d, mesh, axis, kind="int8_gather")
            if n.shape[d] > 1:
                n = shard_ops.all_gather(n, d, mesh, axis, kind="int8_gather")
            plan.append((d, axis, axis == "data"))
    deq = (q.to(torch.float32) * qformat.exp2(-n)).to(v.dtype)
    return _GatheredSTE.apply(v, deq, mesh, plan)


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


# Elements of a float leaf quantized at once: a 2-D leaf goes a slab of rows
# at a time, a stacked one a layer slice (or a slab of them) at a time, so the
# quantizer's float temporaries stay small beside the model (command-r's tied
# table alone is 12.6 GB of float32).
_SLAB_ELEMENTS = 1 << 26


def _quantize_by_slabs(v: torch.Tensor, bits: int, per_channel: bool) -> QTensor:
    """``qformat.quantize_tensor`` with the weight-only channel axes, over
    slabs of ``v``'s leading axis: the exponents come from the slabs' maxima
    (a max is exact in any order) and every slab is quantized with its part
    of them, so the codes and exponents equal the whole leaf's bit for bit."""
    rows = max(1, _SLAB_ELEMENTS // max(1, v[0].numel()))
    stacked = per_channel and v.ndim > 2
    if stacked:                 # exponents per leading index: reduce K only
        m = torch.cat([qformat.max_abs(v[i:i + rows], v.ndim - 2, keepdim=True)
                       for i in range(0, v.shape[0], rows)])
    else:                       # the reduction spans the slabs: their maxima's max
        axes = tuple(range(v.ndim - 1)) if per_channel else None
        m = None
        for i in range(0, v.shape[0], rows):
            part = qformat.max_abs(v[i:i + rows], axes)
            m = part if m is None else torch.maximum(m, part)
    n = qformat.frac_bits_for(m, bits)
    q = torch.empty(v.shape, dtype=qformat.storage_dtype(bits), device=v.device)
    for i in range(0, v.shape[0], rows):
        nb = n[i:i + rows] if stacked else n
        q[i:i + rows] = qformat.quantize(v[i:i + rows], nb, bits)
    return QTensor(q, n, bits, v.ndim - 1 if per_channel and not stacked else None)


def integerize_weights_only(params, *, bits: int = 8, per_channel: bool = True,
                            block_size: Optional[int] = None, release: bool = False) -> Dict:
    """Weight-only integer conversion (embeddings included).

    ``bits`` 8/9/16 give :class:`QTensor` leaves.  ``bits`` 4/2 pack GEMM
    ``kernel`` leaves along K into :class:`PackedQTensor` containers, with
    per-channel scales or, given ``block_size``, per-block ones; embedding
    ``table`` leaves stay unpacked :class:`QTensor` at the logical width
    (the gather and tied-logits paths index their rows).
    ``per_channel``: one exponent per output channel; stacked leaves (the
    layer axis in front, and the expert axis of an MoE stack: (L, E, K, N)
    or (E, K, N)) keep every leading index distinct, so each layer and
    expert gets its own Qm.n grid.  The MoE router stays float.  Norm parameters and biases (the QKV biases,
    LayerNorm's ``bias``) stay float, as in the reference.
    ``release``: each quantized leaf also replaces its float leaf in
    ``params`` itself as its codes appear, so a model that cannot be held
    twice (glm4-9b: 35 GB of float32) frees its float copy leaf by leaf;
    the caller's tree is changed.
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
                else:
                    out[k] = _quantize_by_slabs(v, bits, per_channel)
                if release:
                    node[k] = out[k]
            else:
                out[k] = v
        return out

    return rec(params, "")
