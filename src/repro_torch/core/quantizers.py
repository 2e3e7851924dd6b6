"""Fake-quantization ops with straight-through gradients
(``repro/core/quantizers.py``).

Paper Sec. 4.3: the QAT and EVAL forward constrain inputs, weights and
biases to the Qm.n value grid while staying in float; the backward flows
through the non-quantized values.  That is a straight-through estimator,
here a ``torch.autograd.Function`` per quantizer (``torch.trunc`` alone has
a zero gradient, so QAT would train nothing).  Like the reference,
:func:`fake_quant` is ``qformat.quantize_dequantize`` in plain tensor ops;
it does not route through the ``fake_quant`` kernel.  The TFLite-style
affine quantizer the paper compares against is here too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import Granularity, QuantPolicy


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, width):
        return qformat.quantize_dequantize(x, n, width)

    @staticmethod
    def backward(ctx, g):
        # STE: the gradient passes to x unchanged, clipped elements too; the
        # exponent gets none
        return g, None, None


def fake_quant(x: torch.Tensor, n: qformat.Exponent, width: int) -> torch.Tensor:
    """Quantize-dequantize on the pow2 grid 2^-n; identity gradient (STE)."""
    return _FakeQuant.apply(x, n, width)


class _FakeQuantAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero, width):
        q = torch.clamp(torch.round(x / scale) + zero, qformat.qmin(width), qformat.qmax(width))
        return (q - zero) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant_affine(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                      width: int) -> torch.Tensor:
    """TFLite-style affine fake-quant: round(x/scale) + zero, clip,
    dequantize; gradients for ``x`` only (STE)."""
    return _FakeQuantAffine.apply(x, scale, zero, width)


class _SteInt8Weight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep_axes):
        t = qformat.quantize_tensor(x, 8, channel_axis=tuple(keep_axes) or None)
        return (t.q.to(torch.float32) * qformat.exp2(-t.n)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_int8_weight(x: torch.Tensor, keep_axes: tuple) -> torch.Tensor:
    """Weight fake-quant that materializes the int8 form: the forward emits
    int8 codes (``quantize_tensor``, one exponent per index of ``keep_axes``,
    e.g. (0, -1) on stacked kernels = per layer and channel) and dequantizes
    them with the reference's ``exp2`` (``qformat.exp2``, not 2.0**-n); the
    backward is the STE."""
    return _SteInt8Weight.apply(x, keep_axes)


class _FakeQuantBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, width, block_size, axis):
        ax = axis % x.ndim
        n = qformat.block_frac_bits(x, width, block_size, axis=ax)
        nb = torch.repeat_interleave(n, block_size, dim=ax).narrow(ax, 0, x.shape[ax])
        return qformat.quantize_dequantize(x, nb, width)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant_blocked(x: torch.Tensor, width: int, block_size: int,
                       axis: int = -2) -> torch.Tensor:
    """Sub-int8 fake-quant on a per-block (MX-style) pow2 grid; STE backward.
    Each ``block_size`` run of ``axis`` gets its own Eq. 1-2 exponent from
    the live values (``qformat.block_frac_bits``), the value set of
    ``qformat.quantize_tensor_packed``."""
    return _FakeQuantBlocked.apply(x, width, block_size, axis)


def dynamic_frac_bits(x: torch.Tensor, width: int, *,
                      channel_axis: Optional[int] = None) -> torch.Tensor:
    """Eq. 1-2 on the live tensor (QAT range reassessment); the exponent is
    not differentiated (it parameterizes the grid, not the function)."""
    x = x.detach()
    if channel_axis is None:
        return qformat.frac_bits_for(qformat.max_abs(x), width)
    axes = tuple(a for a in range(x.ndim) if a != channel_axis % x.ndim)
    return qformat.frac_bits_for(qformat.max_abs(x, axes), width)


def shared_frac_bits(x: torch.Tensor, width: int, group) -> torch.Tensor:
    """:func:`dynamic_frac_bits` of a tensor whose slices lie on the ranks
    of ``group``: Eq. 1-2 on the all-reduce MAX of the ranks' max|x|, so
    every rank takes the exponent of the whole tensor (a group of one
    rank holds the whole tensor and makes no collective)."""
    import torch.distributed as dist

    ma = qformat.max_abs(x.detach()).to(torch.float32)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(ma, op=dist.ReduceOp.MAX, group=group)
    return qformat.frac_bits_for(ma, width)


def _broadcast_n(n: qformat.Exponent, x: torch.Tensor, channel_axis: Optional[int]):
    if channel_axis is None or not isinstance(n, torch.Tensor) or n.ndim == 0:
        return n
    shape = [1] * x.ndim
    shape[channel_axis % x.ndim] = -1
    return n.reshape(shape)


def quantize_value(x: torch.Tensor, policy: QuantPolicy, width: int, *,
                   channel_axis: Optional[int] = None,
                   frozen_n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The policy's fake-quantization of a float tensor.

    Per-network granularity takes ``policy.network_frac_bits`` (e.g. Q7.9);
    otherwise the exponent is ``frozen_n`` (EVAL/PTQ) or reassessed from
    the live tensor (QAT).  Asymmetric or non-pow2 policies take the affine
    quantizer.
    """
    if not policy.enabled:
        return x
    if not policy.power_of_two or not policy.symmetric:
        sg = x.detach()
        if channel_axis is None:
            hi, lo = torch.amax(sg), torch.amin(sg)
        else:
            axes = tuple(a for a in range(x.ndim) if a != channel_axis % x.ndim)
            hi = torch.amax(sg, dim=axes, keepdim=True)
            lo = torch.amin(sg, dim=axes, keepdim=True)
        if policy.symmetric:
            amax = torch.maximum(torch.abs(hi), torch.abs(lo))
            scale = torch.clamp(amax, min=1e-12) / qformat.qmax(width)
            zero = torch.zeros_like(scale)
        else:
            scale = torch.clamp(hi - lo, min=1e-12) / (qformat.qmax(width) - qformat.qmin(width))
            zero = torch.round(-lo / scale) + qformat.qmin(width)
        return fake_quant_affine(x, scale, zero, width)

    ca = channel_axis if policy.granularity is Granularity.PER_CHANNEL else None
    if policy.granularity is Granularity.PER_NETWORK and policy.network_frac_bits is not None:
        return fake_quant(x, int(policy.network_frac_bits), width)
    n = frozen_n if frozen_n is not None else dynamic_frac_bits(x, width, channel_axis=ca)
    return fake_quant(x, _broadcast_n(n, x, ca), width)


def quantize_weight(x: torch.Tensor, policy: QuantPolicy, *, channel_axis=None,
                    frozen_n=None) -> torch.Tensor:
    return quantize_value(x, policy, policy.weight_bits, channel_axis=channel_axis,
                          frozen_n=frozen_n)


def quantize_activation(x: torch.Tensor, policy: QuantPolicy, *, frozen_n=None) -> torch.Tensor:
    # Activations are per-tensor (per-layer), as in the paper: per-channel
    # activation scales would break the single-shift requantization.
    return quantize_value(x, policy, policy.act_bits, channel_axis=None, frozen_n=frozen_n)
