"""Qm.n fixed-point format math (the paper's Sec. 4.1), in PyTorch.

    m = 1 + floor(log2(max_i |x_i|))          (Eq. 1)  integer bits
    n = w - m - 1                             (Eq. 2)  fractional bits
    x_fixed = trunc(x * 2^n)                  (Eq. 3)
    s = 2^-n                                  (Eq. 4)  scale factor

Counterpart of ``repro/core/qformat.py``.  Exponents are int32 tensors (or
Python ints), granularity is the shape of ``n`` (scalar per-tensor, a vector
per-channel, broadcast-shaped per-layer-per-channel for stacked leaves).
Sub-int8 weights pack two (int4) or four (int2) lanes per int8 byte along
the contraction axis (:class:`PackedQTensor`).

Powers of two follow the reference's arithmetic, not exact math: on XLA's
CPU backend ``jnp.exp2(n)`` is ``exp(0.693147182 * n)`` in float32, which
misses 2^n at most |n| >= 13 (``exp2(15)`` is 32767.984).  :func:`exp2`
reads those float32 values from a committed table, as :func:`_log2_f32`
follows the reference's ``log2``.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, Optional, Tuple, Union

import torch

# Clamp for the fractional-bit exponent (|n| > 30 never occurs for sane data
# and the clamp also covers all-zero tensors).
N_MIN = -30
N_MAX = 30

_INT_DTYPES = {2: torch.int8, 4: torch.int8, 8: torch.int8, 9: torch.int16, 16: torch.int16,
               32: torch.int32}
_ACC_DTYPES = {2: torch.int32, 4: torch.int32, 8: torch.int32, 9: torch.int32, 16: torch.int32,
               32: torch.int64}

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

# float32 bit patterns of XLA-CPU ``jnp.exp2(n)`` for n = EXP2_MIN..EXP2_MAX
# (jax 0.9.0; tests/test_torch_subint8.py holds each entry to ``jnp.exp2``).
# The range covers exponents in [N_MIN, N_MAX] and their pairwise sums.
EXP2_MIN, EXP2_MAX = -64, 64
_EXP2_BITS = (
    0x1F7FFFFE, 0x1FFFFFE6, 0x20800007, 0x20FFFFF6, 0x2180000F, 0x22000003, 0x227FFFEE,
    0x2300000B, 0x237FFFFE, 0x23FFFFE6, 0x24800007, 0x24FFFFF6, 0x257FFFDE, 0x26000003,
    0x267FFFEE, 0x2700000B, 0x277FFFFE, 0x27FFFFE6, 0x28800007, 0x28FFFFF7, 0x297FFFFF,
    0x2A000003, 0x2A7FFFEF, 0x2AFFFFF7, 0x2B7FFFFF, 0x2C000003, 0x2C800007, 0x2CFFFFF7,
    0x2D7FFFFF, 0x2E000003, 0x2E7FFFEF, 0x2EFFFFF7, 0x2F7FFFFF, 0x30000004, 0x30800008,
    0x30FFFFF7, 0x317FFFFF, 0x32000004, 0x327FFFEF, 0x32FFFFF7, 0x337FFFFF, 0x34000004,
    0x347FFFFF, 0x34FFFFF7, 0x357FFFFF, 0x36000004, 0x367FFFFF, 0x36FFFFF7, 0x377FFFFF,
    0x38000004, 0x38800000, 0x38FFFFF8, 0x39800000, 0x3A000000, 0x3A800000, 0x3B000000,
    0x3B800000, 0x3C000000, 0x3C800000, 0x3D000000, 0x3D800000, 0x3E000000, 0x3E800000,
    0x3F000000, 0x3F800000, 0x40000000, 0x40800000, 0x41000000, 0x41800000, 0x42000000,
    0x42800000, 0x43000000, 0x43800000, 0x44000000, 0x44800000, 0x45000000, 0x45800000,
    0x46000004, 0x46800000, 0x46FFFFF8, 0x47800000, 0x48000004, 0x48800000, 0x48FFFFF9,
    0x49800000, 0x4A000004, 0x4A800000, 0x4AFFFFF9, 0x4B800000, 0x4C000004, 0x4C800008,
    0x4CFFFFF9, 0x4D800000, 0x4E000004, 0x4E7FFFF1, 0x4EFFFFF9, 0x4F800001, 0x50000005,
    0x50800009, 0x50FFFFF9, 0x51800001, 0x52000005, 0x527FFFF1, 0x52FFFFF9, 0x53800001,
    0x54000005, 0x54800009, 0x54FFFFF9, 0x55800001, 0x56000005, 0x567FFFF1, 0x5700000D,
    0x57800001, 0x57FFFFEA, 0x58800009, 0x58FFFFFA, 0x59800011, 0x5A000005, 0x5A7FFFF2,
    0x5B00000D, 0x5B800001, 0x5BFFFFEA, 0x5C800009, 0x5CFFFFFA, 0x5D7FFFE2, 0x5E000005,
    0x5E7FFFF2, 0x5F00000D, 0x5F800001)
EXP2_TABLE = struct.unpack(f"<{len(_EXP2_BITS)}f", struct.pack(f"<{len(_EXP2_BITS)}I",
                                                              *_EXP2_BITS))
_exp2_tables: Dict[torch.device, torch.Tensor] = {}


def storage_dtype(width: int) -> torch.dtype:
    """Smallest integer dtype that holds a ``width``-bit value (int9 -> int16)."""
    return _INT_DTYPES[width]


def accumulator_dtype(width: int) -> torch.dtype:
    """2x-operand-width accumulator dtype (paper Sec. 5.8)."""
    return _ACC_DTYPES[width]


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
    ln2 = _log_f32(torch.full((), 2.0, dtype=torch.float32, device=x.device))
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
    """The reference's float32 ``jnp.exp2`` at integer exponents, from
    :data:`EXP2_TABLE`: a Python float for an int, else a float32 tensor
    on ``n``'s device (a gather, so no value comes back to the host)."""
    if not isinstance(n, torch.Tensor):
        if not EXP2_MIN <= int(n) <= EXP2_MAX:
            raise ValueError(f"exp2: exponent {n} outside [{EXP2_MIN}, {EXP2_MAX}]")
        return EXP2_TABLE[int(n) - EXP2_MIN]
    if n.dtype.is_floating_point:
        raise TypeError(f"exp2 takes integer exponents, got {n.dtype}")
    table = _exp2_tables.get(n.device)
    if table is None:
        table = torch.tensor(EXP2_TABLE, dtype=torch.float32, device=n.device)
        _exp2_tables[n.device] = table
    # torch.take, not table[idx]: a 0-d index tensor would be read back as an int
    return torch.take(table, n.to(torch.int64) - EXP2_MIN)


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


def on_device(v: Exponent, device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """An exponent or shift as a ``dtype`` tensor on ``device``: a tensor is
    moved there, a Python int is filled in place (a fill kernel, not a copy
    from the host, so no sync and nothing a CUDA graph cannot capture)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), int(v), dtype=dtype, device=device)


def scale_from_n(n: Exponent) -> Union[float, torch.Tensor]:
    """Eq. 4: s = 2^-n as float32 (the fake-quant and float paths only)."""
    return exp2(-n)


def quantize_dequantize(x: torch.Tensor, n: Exponent, width: int) -> torch.Tensor:
    """Fake-quantization: clip(trunc(x * 2^n)) * 2^-n, kept in float32 (the
    QAT/EVAL forward, paper Sec. 4.3)."""
    xf = x.to(torch.float32) * exp2(n)
    return torch.clamp(torch.trunc(xf), qmin(width), qmax(width)) * exp2(-n)


def shift_right(v: torch.Tensor, s) -> torch.Tensor:
    """XLA's arithmetic right shift of an integer tensor by ``s`` >= 0: a
    shift of the bit width or more gives the sign fill."""
    bits = torch.iinfo(v.dtype).bits
    return v >> torch.clamp(on_device(s, v.device, v.dtype), 0, bits - 1)


def shift_left(v: torch.Tensor, s) -> torch.Tensor:
    """XLA's left shift of an int32 (or narrower) tensor by ``s`` >= 0: the
    result wraps modulo 2^bits, and a shift of the bit width or more gives 0.
    Worked in int64, so no shift overflows a signed type."""
    bits = torch.iinfo(v.dtype).bits
    if bits > 32:
        raise TypeError(f"shift_left takes at most 32-bit integers, got {v.dtype}")
    s = on_device(s, v.device, torch.int64)
    wide = v.to(torch.int64) << torch.clamp(s, 0, bits - 1).to(torch.int64)
    half = 1 << (bits - 1)
    wrapped = ((wide + half) & ((1 << bits) - 1)) - half
    return torch.where(s >= bits, 0, wrapped).to(v.dtype)


def requantize(acc: torch.Tensor, n_in: Exponent, n_out: Exponent,
               width: int) -> torch.Tensor:
    """Shift an accumulator from format ``n_in`` to ``n_out`` and saturate to
    ``width`` bits (paper Sec. 5.8).

    ``n_in - n_out`` >= 0 is an arithmetic right shift; < 0 a left shift
    that saturates as if taken at infinite precision: worked in int64,
    shifts clipped to 62, and a value whose shift would pass the limit is
    caught first by comparing it with ``qmax >> lshift``.
    """
    shift = on_device(n_in, acc.device, torch.int64) - on_device(n_out, acc.device, torch.int64)
    acc64 = acc.to(torch.int64)
    rsh = torch.clamp(shift, 0, 62)
    lsh = torch.clamp(-shift, 0, 62)
    right = acc64 >> rsh
    lim = torch.bitwise_right_shift(qmax(width), lsh)
    sat = torch.where(acc64 >= 0, qmax(width), qmin(width))
    left = torch.where(torch.abs(acc64) > lim, sat, acc64 << lsh)
    out = torch.where(shift >= 0, right, left)
    return torch.clamp(out, qmin(width), qmax(width)).to(storage_dtype(width))


def align(xq: torch.Tensor, n_x: Exponent, n_common: Exponent,
          acc_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Align an operand to a common Qm.n before an add (paper Sec. 5.8):
    ``xq`` in ``acc_dtype``, shifted left by ``n_common - n_x`` (or right
    when negative), with XLA's shift semantics."""
    acc = xq.to(acc_dtype)
    shift = on_device(n_common, acc.device) - on_device(n_x, acc.device)
    left = shift_left(acc, torch.clamp(shift, min=0))
    right = shift_right(acc, torch.clamp(-shift, min=0))
    return torch.where(shift >= 0, left, right)


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

    @property
    def nbytes_model(self) -> int:
        """Model-ROM bytes at the logical width (paper Table A3)."""
        return self.q.numel() * self.width // 8

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
                    n_override: Optional[Exponent] = None) -> QTensor:
    """Quantize a float tensor on the paper's pow2 grid (Sec. 4.1.4).

    ``channel_axis=None``: per-tensor; ``k``: per-channel along axis k;
    a tuple: one exponent per index of the kept axes (stacked leaves),
    stored broadcast-shaped with ``channel_axis=None``.  ``n_override``: an
    exponent chosen outside (the paper's per-network mode, e.g. Q7.9 gives
    n = 9 for the whole net).
    """
    if n_override is not None:
        n = on_device(n_override, x.device)
        nb = n
        if isinstance(channel_axis, int) and n.ndim > 0:
            shape = [1] * x.ndim
            shape[channel_axis] = -1
            nb = n.reshape(shape)
        return QTensor(quantize(x, nb, width), n, width,
                       channel_axis if isinstance(channel_axis, int) else None)
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


# --------------------------------------------------------------------------
# Sub-int8 packed storage (int4/int2 weights)
# --------------------------------------------------------------------------

def lanes_per_byte(width: int) -> int:
    """How many ``width``-bit lanes fit one int8 container byte (4->2, 2->4)."""
    if width not in (2, 4):
        raise ValueError(f"packed storage supports widths 2 and 4, got {width}")
    return 8 // width


def pack_subint8(q: torch.Tensor, width: int, axis: int = -2) -> torch.Tensor:
    """Pack ``width``-bit signed integers along ``axis`` into int8 bytes.

    Lane ``i`` of byte ``j`` holds element ``lanes*j + i`` in bits
    ``[width*i, width*(i+1))``, two's complement, so lane 0 is the low
    nibble (the layout ``wq4_matmul`` unpacks).  A length the lane count
    does not divide is padded with zero lanes.
    """
    lanes = lanes_per_byte(width)
    ax = axis % q.ndim
    moved = torch.movedim(q, ax, -1).to(torch.int32)
    pad = (-moved.shape[-1]) % lanes
    if pad:
        moved = torch.nn.functional.pad(moved, (0, pad))
    grp = moved.reshape(*moved.shape[:-1], -1, lanes)
    mask = (1 << width) - 1
    acc = torch.zeros(grp.shape[:-1], dtype=torch.int32, device=q.device)
    for i in range(lanes):
        acc = acc | ((grp[..., i] & mask) << (width * i))
    packed = acc.to(torch.uint8).view(torch.int8)
    return torch.movedim(packed, -1, ax).contiguous()


def unpack_subint8(packed: torch.Tensor, width: int, k: int, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_subint8`: int8 bytes -> ``k`` signed lanes (int8)."""
    lanes = lanes_per_byte(width)
    ax = axis % packed.ndim
    u = torch.movedim(packed, ax, -1).contiguous().view(torch.uint8).to(torch.int32)
    mask = (1 << width) - 1
    vals = torch.stack([(u >> (width * i)) & mask for i in range(lanes)], dim=-1)
    vals = torch.where(vals >= 1 << (width - 1), vals - (1 << width), vals)
    flat = vals.reshape(*vals.shape[:-2], -1)[..., :k].to(torch.int8)
    return torch.movedim(flat, -1, ax).contiguous()


def block_frac_bits(x: torch.Tensor, width: int, block_size: int,
                    axis: int = -2) -> torch.Tensor:
    """Per-block exponents: Eq. 1-2 over ``block_size`` runs of ``axis``,
    which shrinks to the number of blocks.  A trailing partial block is
    ranged over its real elements only (zero padding)."""
    ax = axis % x.ndim
    moved = torch.movedim(x, ax, -1)
    pad = (-moved.shape[-1]) % block_size
    if pad:
        moved = torch.nn.functional.pad(moved, (0, pad))
    grp = moved.reshape(*moved.shape[:-1], -1, block_size)
    n = frac_bits_for(torch.amax(torch.abs(grp), dim=-1), width)
    return torch.movedim(n, -1, ax).contiguous()


def repeat_blocks(t: torch.Tensor, block_size: int, k: int) -> torch.Tensor:
    """Per-block rows (..., nb, N) repeated over the ``k`` logical rows of
    axis -2 (a broadcast view copied once; no value comes back to the host)."""
    nb, n = t.shape[-2], t.shape[-1]
    grown = t.unsqueeze(-2).expand(*t.shape[:-1], block_size, n)
    return grown.reshape(*t.shape[:-2], nb * block_size, n)[..., :k, :]


@dataclasses.dataclass(frozen=True)
class PackedQTensor:
    """A sub-int8 weight: a packed int8 container plus pow2 exponents.

    ``q`` is ``(..., ceil(K/lanes), N)``: ``width``-bit lanes (4 or 2)
    packed along the contraction axis of a ``(..., K, N)`` GEMM weight.
    ``n`` is a scalar (per-tensor), ``(..., 1, N)`` (per output channel,
    ``block_size=None``) or ``(..., ceil(K/bs), N)`` (per block of
    ``block_size`` K rows).  ``scale`` caches 2^-n as float32 in the shape
    of ``n``, so no tick recomputes it.
    """

    q: torch.Tensor
    n: torch.Tensor
    width: int
    k: int
    block_size: Optional[int] = None
    scale: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.scale is None:
            object.__setattr__(self, "scale", exp2(-self.n))

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (unpacked) shape ``(..., K, N)``."""
        return (*self.q.shape[:-2], self.k, self.q.shape[-1])

    @property
    def nbytes_packed(self) -> int:
        """Container bytes (the int8 payload; scales excluded)."""
        return self.q.numel()

    @property
    def nbytes_model(self) -> int:
        """Model bytes at the logical width."""
        return math.prod(self.shape) * self.width // 8

    def unpack(self) -> torch.Tensor:
        """The ``width``-bit integers, as int8, in the logical shape."""
        return unpack_subint8(self.q, self.width, self.k, axis=-2)

    def scales(self) -> torch.Tensor:
        """2^-n broadcastable against the logical ``(..., K, N)``."""
        if self.block_size is not None and self.scale.ndim > 0:
            return repeat_blocks(self.scale, self.block_size, self.k)
        return self.scale

    def dequantize(self) -> torch.Tensor:
        return self.unpack().to(torch.float32) * self.scales()

    def layer(self, i: int) -> "PackedQTensor":
        """Slice ``i`` of a stacked leaf (views, no copy)."""
        stacked = self.n.ndim == self.q.ndim
        return PackedQTensor(self.q[i], self.n[i] if stacked else self.n, self.width, self.k,
                             self.block_size, self.scale[i] if stacked else self.scale)

    def to(self, device) -> "PackedQTensor":
        return PackedQTensor(self.q.to(device), self.n.to(device), self.width, self.k,
                             self.block_size, self.scale.to(device))


def quantize_tensor_packed(x: torch.Tensor, width: int, *, block_size: Optional[int] = None,
                           per_channel: bool = True) -> PackedQTensor:
    """Quantize a ``(..., K, N)`` weight to packed ``width``-bit storage.

    ``block_size=None``: one exponent per output channel over all of K
    (``per_channel=False``: one for the tensor); ``block_size=bs``: one per
    ``bs`` rows of K and output channel.
    """
    if x.ndim < 2:
        raise ValueError(f"packed weights need ndim >= 2, got {x.ndim}")
    lanes = lanes_per_byte(width)
    k = x.shape[-2]
    if block_size is not None:
        if block_size < lanes or block_size % lanes:
            raise ValueError(
                f"block_size must be a positive multiple of {lanes} "
                f"(the byte lane count at width {width}), got {block_size}")
        n = block_frac_bits(x, width, block_size, axis=-2)
        nb = repeat_blocks(n, block_size, k)
    elif per_channel:
        n = nb = frac_bits_for(torch.amax(torch.abs(x), dim=-2, keepdim=True), width)
    else:
        n = nb = frac_bits_for(max_abs(x), width)
    q = quantize(x, nb, width)
    return PackedQTensor(pack_subint8(q, width, axis=-2), n, width, k, block_size)
