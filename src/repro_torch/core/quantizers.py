"""Fake-quantization forwards (``repro/core/quantizers.py``).

Paper Sec. 4.3: the QAT and EVAL forward constrain inputs, weights and
biases to the Qm.n value grid while staying in float.  Like the reference,
:func:`fake_quant` is ``qformat.quantize_dequantize`` in plain tensor ops;
it does not route through the ``fake_quant`` kernel.  The TFLite-style
affine quantizer the paper compares against is here too.  The
straight-through gradients come with the training slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import Granularity, QuantPolicy


def fake_quant(x: torch.Tensor, n: qformat.Exponent, width: int) -> torch.Tensor:
    """Quantize-dequantize on the pow2 grid 2^-n."""
    return qformat.quantize_dequantize(x, n, width)


def fake_quant_affine(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                      width: int) -> torch.Tensor:
    """TFLite-style affine fake-quant: round(x/scale) + zero, clip, dequantize."""
    q = torch.clamp(torch.round(x / scale) + zero, qformat.qmin(width), qformat.qmax(width))
    return (q - zero) * scale


def dynamic_frac_bits(x: torch.Tensor, width: int, *,
                      channel_axis: Optional[int] = None) -> torch.Tensor:
    """Eq. 1-2 on the live tensor (QAT range reassessment)."""
    x = x.detach()
    if channel_axis is None:
        return qformat.frac_bits_for(qformat.max_abs(x), width)
    axes = tuple(a for a in range(x.ndim) if a != channel_axis % x.ndim)
    return qformat.frac_bits_for(qformat.max_abs(x, axes), width)


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
