"""Qm.n fixed-point format math (the paper's Sec. 4.1), in PyTorch.

    m = 1 + floor(log2(max_i |x_i|))          (Eq. 1)  integer bits
    n = w - m - 1                             (Eq. 2)  fractional bits
    x_fixed = trunc(x * 2^n)                  (Eq. 3)
    s = 2^-n                                  (Eq. 4)  scale factor

Counterpart of ``repro/core/qformat.py``.  Exponents are int32 tensors (or
Python ints), granularity is the shape of ``n`` (scalar per-tensor, a vector
per-channel, broadcast-shaped per-layer-per-channel for stacked leaves).
Sub-int8 packing (``PackedQTensor``) belongs to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

# Clamp for the fractional-bit exponent (|n| > 30 never occurs for sane data
# and the clamp also covers all-zero tensors).
N_MIN = -30
N_MAX = 30

_INT_DTYPES = {8: torch.int8, 9: torch.int16, 16: torch.int16, 32: torch.int32}

Exponent = Union[int, torch.Tensor]

# float32 coefficients of the Cephes/Eigen polynomial logarithm that XLA's CPU
# backend evaluates for f32 ``log``.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524
_MIN_NORMAL = 1.17549435e-38


def storage_dtype(width: int) -> torch.dtype:
    """Smallest integer dtype that holds a ``width``-bit value (int9 -> int16)."""
    return _INT_DTYPES[width]


def qmin(width: int) -> int:
    return -(2 ** (width - 1))


def qmax(width: int) -> int:
    return 2 ** (width - 1) - 1


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, step for step as XLA's CPU backend computes it.

    Every mul and add rounds to float32 on its own (no fused multiply-add).
    The reference's ``floor(log2(.))`` flips at powers of two exactly where
    this polynomial rounds, so an exact log would disagree with it there.
    """
    x = torch.clamp(x.to(torch.float32), min=_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F + 1).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _SQRTHF
    one = _f32(1.0, x)
    xm = (m - one) + torch.where(small, m, torch.zeros_like(m))
    e = e - torch.where(small, one, torch.zeros_like(one))
    x2 = xm * xm
    x3 = x2 * xm
    p = [_f32(c, x) for c in _LOG_P]
    y = p[0] * xm + p[1]
    y1 = p[3] * xm + p[4]
    y2 = p[6] * xm + p[7]
    y = y * xm + p[2]
    y1 = y1 * xm + p[5]
    y2 = y2 * xm + p[8]
    y = y * x3 + y1
    y = y * x3 + y2
    y = y * x3
    y = y + e * _f32(_LOG_Q1, x)
    out = xm - x2 * _f32(0.5, x)
    out = out + y
    return out + e * _f32(_LOG_Q2, x)


def _log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(x) * (1 / log(2))`` in float32, the way ``jnp.log2`` lowers."""
    ln2 = _log_f32(torch.full((1,), 2.0, dtype=torch.float32, device=x.device))
    return _log_f32(x) * (_f32(1.0, x) / ln2)


def integer_bits(max_abs: torch.Tensor) -> torch.Tensor:
    """Eq. 1: m = 1 + floor(log2(max|x|)), as int32 (zero maps far negative)."""
    max_abs = torch.as_tensor(max_abs, dtype=torch.float32)
    safe = torch.clamp(max_abs, min=2.0 ** (-(N_MAX + 1)))
    return 1 + torch.floor(_log2_f32(safe)).to(torch.int32)


def frac_bits_for(max_abs: torch.Tensor, width: int) -> torch.Tensor:
    """Eq. 2: n = w - m - 1, clamped to [N_MIN, N_MAX]."""
    n = width - integer_bits(max_abs) - 1
    return torch.clamp(n, N_MIN, N_MAX).to(torch.int32)


def max_abs(x: torch.Tensor, axis=None, keepdim: bool = False) -> torch.Tensor:
    """The paper's range statistic max|x| (optionally over ``axis``)."""
    a = torch.abs(x)
    if axis is None:
        return torch.amax(a)
    return torch.amax(a, dim=axis, keepdim=keepdim)


def exp2(n: Exponent) -> Union[float, torch.Tensor]:
    """2^n as float32 (a Python float for an int exponent: exact either way)."""
    if isinstance(n, int):
        return math.ldexp(1.0, n)
    return torch.exp2(n.to(torch.float32))


def quantize(x: torch.Tensor, n: Exponent, width: int) -> torch.Tensor:
    """Eq. 3 + saturation: sat(trunc(x * 2^n)) in the storage dtype.

    The product is taken in float32, truncated toward zero, then clipped —
    bit for bit the reference's order of operations.
    """
    xf = x.to(torch.float32) * exp2(n)
    xq = torch.clamp(torch.trunc(xf), qmin(width), qmax(width))
    return xq.to(storage_dtype(width))


def dequantize(xq: torch.Tensor, n: Exponent) -> torch.Tensor:
    """x = x_q * 2^-n, as float32."""
    return xq.to(torch.float32) * exp2(-n)


@dataclasses.dataclass(frozen=True)
class QTensor:
    """An integerized tensor: storage integers + fractional-bit exponent(s).

    ``n`` is an int32 scalar (per-tensor), a vector along ``channel_axis``
    (per-channel), or broadcast-shaped against ``q`` (per-layer-per-channel
    for stacked leaves, ``channel_axis=None``).  ``scale`` caches 2^-n as
    float32 in the shape of ``n`` so the serving path never recomputes it.
    """

    q: torch.Tensor
    n: torch.Tensor
    width: int
    channel_axis: Optional[int] = None
    scale: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.scale is None:
            object.__setattr__(self, "scale", exp2(-self.n))

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        if self.channel_axis is not None and t.ndim == 1:
            shape = [1] * self.q.ndim
            shape[self.channel_axis] = -1
            return t.reshape(shape)
        return t

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self._broadcast(self.scale)

    def layer(self, i: int) -> "QTensor":
        """Slice ``i`` of a stacked leaf (views, no copy)."""
        stacked = self.n.ndim == self.q.ndim
        return QTensor(self.q[i], self.n[i] if stacked else self.n, self.width,
                       None if self.channel_axis is None else self.channel_axis - 1,
                       self.scale[i] if stacked else self.scale)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.n.to(device), self.width,
                       self.channel_axis, self.scale.to(device))


def quantize_tensor(x: torch.Tensor, width: int, *,
                    channel_axis: Union[None, int, Tuple[int, ...]] = None,
                    ) -> QTensor:
    """Quantize a float tensor on the paper's pow2 grid (Sec. 4.1.4).

    ``channel_axis=None``: per-tensor; ``k``: per-channel along axis k;
    a tuple: one exponent per index of the kept axes (stacked leaves),
    stored broadcast-shaped with ``channel_axis=None``.
    """
    if channel_axis is None:
        n = frac_bits_for(max_abs(x), width)
        return QTensor(quantize(x, n, width), n, width, None)
    if isinstance(channel_axis, tuple):
        keep = tuple(a % x.ndim for a in channel_axis)
        axes = tuple(a for a in range(x.ndim) if a not in keep)
        n = frac_bits_for(max_abs(x, axes, keepdim=True), width)
        return QTensor(quantize(x, n, width), n, width, None)
    ax = channel_axis % x.ndim
    axes = tuple(a for a in range(x.ndim) if a != ax)
    n = frac_bits_for(max_abs(x, axes), width)
    shape = [1] * x.ndim
    shape[ax] = -1
    return QTensor(quantize(x, n.reshape(shape), width), n, width, ax)
