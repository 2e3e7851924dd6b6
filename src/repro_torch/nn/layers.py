"""Core layers with the reference's execution paths (``repro/nn/layers.py``).

1. **float / fake-quant**: QAT, calibration and PTQ evaluation: inputs,
   weights and biases constrained to the Qm.n grid in float, outputs
   re-quantized after the computation (paper Fig. 2); CALIB records ranges.
2. **full integer**: the deployed engine (Sec. 5.8): int8/int16 operands,
   int32 accumulators (``kernels.ops.qmm`` for ``Dense``, ``ops.qconv1d``
   for 1-D convolutions), exact shift requantization and saturation;
   activations flow between layers as :class:`QTensor`.
3. **weight-only**: serving with int8 (``ops.wq_matmul``) or packed
   int4/int2 (``ops.wq4_matmul``) weights and float activations.

Layouts are the reference's: convolutions are channels last (NWC / NHWC)
with (*K, C_in, C_out) kernels, padded as XLA pads SAME.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qformat
from repro_torch.core.policy import Granularity, QMode
from repro_torch.dist import shard_ops
from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.core.quantizers import quantize_activation, quantize_weight, shared_frac_bits
from repro_torch.nn.module import Context, Params


# --------------------------------------------------------------------------
# Initializers: a torch.Generator on the target device replaces jax.random
# --------------------------------------------------------------------------

def lecun_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Normal truncated at two standard deviations, variance ``1/fan_in``."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 2 else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (1.0 / math.sqrt(max(1, fan_in)))


def normal_init(gen: torch.Generator, shape, device, std: float = 0.02) -> torch.Tensor:
    """Gaussian with a fixed standard deviation."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std


# --------------------------------------------------------------------------
# Quant plumbing shared by the compute layers
# --------------------------------------------------------------------------

def _fq_in(x: torch.Tensor, ctx: Context, site: str) -> torch.Tensor:
    """Fake-quantize a layer input (or output) per the active policy."""
    pol = ctx.policy
    if not pol.enabled or pol.mode is QMode.INTEGER:
        return x
    if ctx.collecting:
        ctx.record(site, x)
    if pol.mode is QMode.CALIB:
        return x
    frozen = ctx.frozen(site)
    if frozen is None and ctx.group is not None and not (
            pol.granularity is Granularity.PER_NETWORK and pol.network_frac_bits is not None):
        frozen = shared_frac_bits(x, pol.act_bits, ctx.group)
    return quantize_activation(x, pol, frozen_n=frozen)


_fq_out = _fq_in


def _fq_weight(w: torch.Tensor, ctx: Context, *, channel_axis: Optional[int]) -> torch.Tensor:
    pol = ctx.policy
    if w is None or not pol.enabled or pol.mode in (QMode.INTEGER, QMode.CALIB):
        return w
    return quantize_weight(w, pol, channel_axis=channel_axis)


# --------------------------------------------------------------------------
# Sharded weights (a mesh on the context): which dims are cut, gathers,
# fake-quant exponents of the whole weight
# --------------------------------------------------------------------------

def _codes(w):
    return w.q if isinstance(w, (QTensor, PackedQTensor)) else w


def mesh_split(local: int, full: int, ctx: Context, logical: str) -> Optional[str]:
    """The mesh axis over which a weight dim of size ``full`` arrives cut
    (its local size is smaller), else None.  The rules give the axis: a
    dim cut otherwise than ``full / local`` ways over it raises."""
    if local == full:
        return None
    axis = ctx.rule(logical)
    if axis is None or local * shard_ops.axis_size(ctx.mesh, axis) != full:
        raise ValueError(f"{ctx.path}: a weight dim of {full} arrives as {local} under the "
                         f"rule {logical!r} -> {axis!r}")
    return axis


def gather_codes(w, dim: int, mesh, axis: str):
    """A weight's dim gathered over ``axis``: a float leaf with the FSDP
    backward (reduce-scatter), a QTensor's int8 codes with no gradient."""
    if isinstance(w, QTensor):
        return QTensor(shard_ops.all_gather(w.q, dim, mesh, axis), w.n, w.width,
                       w.channel_axis, w.scale)
    return shard_ops.gather_fsdp(w, dim, mesh, axis)


def fq_weight_mesh(w: torch.Tensor, ctx: Context, split) -> torch.Tensor:
    """``_fq_weight(w, channel_axis=-1)`` of a weight block whose dims
    ``split`` ({dim: mesh axis}) are cut: an exponent that reduces over a
    cut dim takes the max over that axis too, so it is the whole weight's."""
    pol = ctx.policy
    if w is None or not pol.enabled or pol.mode in (QMode.INTEGER, QMode.CALIB):
        return w
    if not (pol.power_of_two and pol.symmetric):
        raise NotImplementedError("an affine weight quantizer under a mesh is not executed")
    per_ch = pol.granularity is Granularity.PER_CHANNEL
    fixed = pol.granularity is Granularity.PER_NETWORK and pol.network_frac_bits is not None
    reduced = tuple(a for a in range(w.ndim) if not (per_ch and a == w.ndim - 1))
    crossing = [ax for d, ax in split.items() if ax is not None and d % w.ndim in reduced]
    if fixed or not crossing:
        return quantize_weight(w, pol, channel_axis=-1)
    m = qformat.max_abs(w.detach(), reduced) if per_ch else qformat.max_abs(w.detach())
    n = qformat.frac_bits_for(shard_ops.pmax(m.to(torch.float32), ctx.mesh, crossing),
                              pol.weight_bits)
    return quantize_weight(w, pol, channel_axis=-1, frozen_n=n)


def _nout_for(params: Params, ctx: Context, site: str):
    """The frozen output exponent of an integer layer (from calibration)."""
    if "n_out" in params:
        return params["n_out"]
    n = ctx.frozen(site)
    if n is None:
        raise ValueError(f"integer mode needs a calibrated output exponent for site "
                         f"{ctx.key(site)!r}")
    return n


def _broadcast_channel_n(n, ndim: int, axis: int):
    if not isinstance(n, torch.Tensor) or n.ndim == 0:
        return n
    shape = [1] * ndim
    shape[axis] = -1
    return n.reshape(shape)


def _integer_epilogue(acc: torch.Tensor, x: QTensor, kernel: QTensor, bias, params: Params,
                      ctx: Context) -> QTensor:
    """Accumulator format n_x + n_w, bias aligned into it, shift to the
    layer's output exponent and saturate (paper Sec. 5.8)."""
    width = ctx.policy.act_bits
    n_acc = x.n + _broadcast_channel_n(kernel.n, acc.ndim, -1)
    if isinstance(bias, QTensor):
        acc = acc + qformat.align(bias.q, bias.n, n_acc, torch.int32)
    n_out = _nout_for(params, ctx, "out")
    return QTensor(qformat.requantize(acc, n_acc, n_out, width), n_out, width)


def _add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    if bias is None:
        return y
    return y + (bias.dequantize() if isinstance(bias, QTensor) else bias)


# --------------------------------------------------------------------------
# Dense
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine projection dispatching float / fake-quant / integer GEMMs by
    the context's policy and the kernel's type."""

    in_features: int
    out_features: int
    use_bias: bool = True
    name: str = "dense"
    kind: str = "gemm"   # matched against QuantPolicy.skip_kinds

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"kernel": lecun_normal(gen, (self.in_features, self.out_features), device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.out_features, dtype=torch.float32, device=device)
        return p

    def apply(self, params: Params, x, ctx: Context):
        ctx = ctx.scope(self.name)
        kernel = params["kernel"]
        bias = params.get("bias")
        if ctx.mesh is not None:
            if isinstance(kernel, PackedQTensor):
                raise NotImplementedError("packed sub-int8 weights under a mesh are not executed")
            k_in, k_out = _codes(kernel).shape[-2:]
            rows = mesh_split(k_in, self.in_features, ctx, "fsdp")
            cols = mesh_split(k_out, self.out_features, ctx, "model")
            if rows or cols:
                return self._sharded_apply(kernel, bias, x, ctx, rows, cols)
        if isinstance(kernel, PackedQTensor):
            from repro_torch.kernels import ops

            return _add_bias(ops.wq4_matmul(x.to(torch.float32), kernel), bias)
        if isinstance(kernel, QTensor):
            if isinstance(x, QTensor):
                return self._integer_apply(params, x, ctx)
            from repro_torch.kernels import ops

            return _add_bias(ops.wq_matmul(x.to(torch.float32), kernel), bias)
        if self.kind in ctx.policy.skip_kinds or not ctx.policy.enabled:
            return _add_bias(torch.matmul(x.to(torch.float32), kernel), bias)
        xq = _fq_in(x, ctx, "in")
        w = _fq_weight(kernel, ctx, channel_axis=-1)
        y = _add_bias(torch.matmul(xq.to(torch.float32), w), _fq_weight(bias, ctx,
                                                                        channel_axis=None))
        return _fq_out(y, ctx, "out")

    def _sharded_apply(self, kernel, bias, x, ctx: Context, rows, cols):
        """Column-parallel: the kernel gathered over ``data`` (FSDP; int8
        codes for a QTensor), this rank's block of columns multiplied
        (``copy_in`` gives the input's gradient its sum over ``model``),
        the output's columns gathered over ``model``.  Every output column
        is a whole-K dot product, so the numbers are one device's up to the
        BLAS blocking.  The bias is added to the whole output after its own
        fake-quant, and the output's range is every column's.  A stacked
        bias (L, N) is cut as a (D_in, D_out) matrix, by the reference's
        rules: its layer's columns arrive cut over ``model`` and are
        gathered here."""
        mesh = ctx.mesh
        if rows:
            kernel = gather_codes(kernel, -2, mesh, rows)
        if bias is not None:
            bcols = mesh_split(bias.shape[-1], self.out_features, ctx, "model")
            if bcols:
                bias = shard_ops.gather_replicated(bias, -1, mesh, bcols)
        quant = not isinstance(kernel, QTensor) and ctx.policy.enabled \
            and self.kind not in ctx.policy.skip_kinds
        if isinstance(kernel, QTensor):
            if isinstance(x, QTensor):
                raise NotImplementedError("the integer engine under a mesh is not executed")
            from repro_torch.kernels import ops

            y = ops.wq_matmul(x.to(torch.float32), kernel)
        elif quant:
            xq = _fq_in(x, ctx, "in").to(torch.float32)
            w = fq_weight_mesh(kernel, ctx, {-1: cols})
            y = torch.matmul(shard_ops.copy_in(xq, mesh, cols) if cols else xq, w)
            bias = _fq_weight(bias, ctx, channel_axis=None)
        else:
            x = x.to(torch.float32)
            y = torch.matmul(shard_ops.copy_in(x, mesh, cols) if cols else x, kernel)
        if cols:
            y = shard_ops.gather_replicated(y, -1, mesh, cols)
        y = _add_bias(y, bias)
        return _fq_out(y, ctx, "out") if quant else y

    def _integer_apply(self, params: Params, x: QTensor, ctx: Context) -> QTensor:
        """The paper's engine: int operands, int32 accumulator, shift, saturate."""
        from repro_torch.kernels import ops

        kernel: QTensor = params["kernel"]
        acc = ops.qmm(x.q, kernel.q)
        return _integer_epilogue(acc, x, kernel, params.get("bias"), params, ctx)


# --------------------------------------------------------------------------
# Convolutions (the paper's primary layer, Sec. 5.6: Conv1D; 2-D for GTSRB)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvND:
    """N-d convolution, channels last (NWC / NHWC), kernel (*K, C_in/g, C_out)."""

    ndim: int
    in_channels: int
    out_channels: int
    kernel_size: Tuple[int, ...]
    strides: Tuple[int, ...]
    padding: str = "SAME"
    use_bias: bool = True
    name: str = "conv"
    kind: str = "conv"
    feature_group_count: int = 1

    def init(self, gen: torch.Generator, device) -> Params:
        kshape = (*self.kernel_size, self.in_channels // self.feature_group_count,
                  self.out_channels)
        p: Params = {"kernel": lecun_normal(gen, kshape, device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.out_channels, dtype=torch.float32, device=device)
        return p

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Float convolution, channels last, padded as XLA pads SAME."""
        from repro_torch.kernels.ref import conv_pads

        spec = []
        for i in reversed(range(self.ndim)):
            lo, hi, _ = conv_pads(x.shape[1 + i], self.kernel_size[i], self.strides[i],
                                  self.padding)
            spec += [lo, hi]
        xt = F.pad(torch.movedim(x, -1, 1), spec)
        wt = torch.movedim(torch.movedim(w, -1, 0), -1, 1)      # (C_out, C_in/g, *K)
        conv = F.conv1d if self.ndim == 1 else F.conv2d
        y = conv(xt, wt, stride=self.strides, groups=self.feature_group_count)
        return torch.movedim(y, 1, -1)

    def apply(self, params: Params, x, ctx: Context):
        ctx = ctx.scope(self.name)
        kernel = params["kernel"]
        bias = params.get("bias")
        if isinstance(kernel, (QTensor, PackedQTensor)):
            if isinstance(x, QTensor) and isinstance(kernel, QTensor):
                return self._integer_apply(params, x, ctx)
            # weight-only serving: no conv kernel, so dequantize and convolve
            return _add_bias(self._conv(x.to(torch.float32), kernel.dequantize()), bias)
        if not ctx.policy.enabled or self.kind in ctx.policy.skip_kinds:
            return _add_bias(self._conv(x.to(torch.float32), kernel), bias)
        xq = _fq_in(x, ctx, "in")
        w = _fq_weight(kernel, ctx, channel_axis=-1)
        y = _add_bias(self._conv(xq.to(torch.float32), w),
                      _fq_weight(bias, ctx, channel_axis=None))
        return _fq_out(y, ctx, "out")

    def _integer_apply(self, params: Params, x: QTensor, ctx: Context) -> QTensor:
        from repro_torch.kernels import ops, ref

        kernel: QTensor = params["kernel"]
        if self.ndim == 1 and self.feature_group_count == 1:
            acc = ops.qconv1d(x.q, kernel.q, strides=self.strides[0], padding=self.padding)
        else:
            # the reference leaves this to XLA's int32 conv: plain tensor code
            acc = ref.int_conv_ref(x.q, kernel.q, self.strides, self.padding,
                                   self.feature_group_count)
        return _integer_epilogue(acc, x, kernel, params.get("bias"), params, ctx)


def Conv1D(in_channels, out_channels, kernel_size, stride=1, padding="SAME", **kw) -> ConvND:
    """``ConvND`` over one spatial dim (the paper's sensor time series)."""
    return ConvND(1, in_channels, out_channels, (kernel_size,), (stride,), padding, **kw)


def Conv2D(in_channels, out_channels, kernel_size, stride=1, padding="SAME", **kw) -> ConvND:
    """``ConvND`` over two spatial dims."""
    ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    return ConvND(2, in_channels, out_channels, ks, st, padding, **kw)


# --------------------------------------------------------------------------
# Embedding and norms
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Embedding:
    """Token-id lookup table; ``attend`` gives tied-embedding logits."""

    vocab_size: int
    features: int
    name: str = "embed"
    kind: str = "embed"

    def init(self, gen: torch.Generator, device) -> Params:
        return {"table": normal_init(gen, (self.vocab_size, self.features), device,
                                     std=1.0 / math.sqrt(self.features))}

    def _whole(self, table, ctx: Context):
        """The table gathered whole under a mesh (float, or the int8 codes
        and per-column exponents): rows over ``data`` with the FSDP
        backward, columns over ``model`` with this rank's block of the
        gradient."""
        if ctx.mesh is None:
            return table
        v, d = _codes(table).shape
        rows = mesh_split(v, self.vocab_size, ctx, "fsdp")
        cols = mesh_split(d, self.features, ctx, "model")
        if rows:
            table = gather_codes(table, 0, ctx.mesh, rows)
        if cols and isinstance(table, QTensor):
            n = table.n
            if n.ndim == 1 and n.shape[0] == d:
                n = shard_ops.all_gather(n, 0, ctx.mesh, cols)
            table = QTensor(shard_ops.all_gather(table.q, 1, ctx.mesh, cols), n, table.width,
                            table.channel_axis)
        elif cols:
            table = shard_ops.gather_replicated(table, 1, ctx.mesh, cols)
        return table

    def apply(self, params: Params, ids: torch.Tensor, ctx: Context) -> torch.Tensor:
        table = self._whole(params["table"], ctx)
        if isinstance(table, QTensor):
            # gather int8 rows, dequantize only the gathered slice
            return qformat.dequantize(table.q[ids], table.n)
        pol = ctx.policy
        if pol.enabled and pol.mode not in (QMode.CALIB, QMode.INTEGER) \
                and self.kind not in pol.skip_kinds:
            table = quantize_weight(table, pol, channel_axis=None)
        return table[ids]

    def attend(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        """Tied-embedding logits x @ table.T (always float)."""
        table = self._whole(params["table"], ctx)
        if isinstance(table, QTensor):
            from repro_torch.kernels import ops

            return ops.wq_matmul(x, table, transpose=True)
        return torch.matmul(x, table.T)


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    """Root-mean-square normalization with a learned scale."""

    features: int
    eps: float = 1e-6
    name: str = "rms"

    def init(self, gen: torch.Generator, device) -> Params:
        return {"scale": torch.ones(self.features, dtype=torch.float32, device=device)}

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        x = x.to(torch.float32)
        y = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + self.eps)
        return y * params["scale"]


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    """Layer normalization with a learned scale and an optional bias."""

    features: int
    eps: float = 1e-5
    use_bias: bool = True
    use_scale: bool = True
    name: str = "ln"

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {}
        if self.use_scale:
            p["scale"] = torch.ones(self.features, dtype=torch.float32, device=device)
        if self.use_bias:
            p["bias"] = torch.zeros(self.features, dtype=torch.float32, device=device)
        return p

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if "scale" in params:
            y = y * params["scale"]
        if "bias" in params:
            y = y + params["bias"]
        return y.to(dt)


@dataclasses.dataclass(frozen=True)
class BatchNormFolded:
    """Inference-form batch norm as the paper deploys it (Eqs. 5-7): training
    keeps (mean, var, gamma, beta); :meth:`fold` gives y = w * x + b."""

    features: int
    eps: float = 1e-5
    momentum: float = 0.9
    name: str = "bn"

    def init(self, gen: torch.Generator, device) -> Params:
        one = torch.ones(self.features, dtype=torch.float32, device=device)
        return {"gamma": one, "beta": torch.zeros_like(one), "mean": torch.zeros_like(one),
                "var": one.clone()}

    def fold(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma = torch.sqrt(params["var"] + self.eps)                          # Eq. 6
        w = params["gamma"] / sigma                                            # Eq. 5
        b = params["beta"] - params["gamma"] * params["mean"] / sigma         # Eq. 7
        return w, b

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        if ctx.train:
            axes = tuple(range(x.ndim - 1))
            mu = torch.mean(x, dim=axes)
            var = torch.var(x, dim=axes, unbiased=False)
            y = (x - mu) * torch.rsqrt(var + self.eps)
            return y * params["gamma"] + params["beta"]
        w, b = self.fold(params)
        y = x * w + b
        return _fq_out(y, ctx.scope(self.name), "out") if ctx.policy.enabled else y


# --------------------------------------------------------------------------
# Stateless ops with the quant semantics of Sec. 4.3 / 5.8
# --------------------------------------------------------------------------

def relu(x):
    """ReLU: an element-wise max, no requantization (paper Sec. 4.3)."""
    if isinstance(x, QTensor):
        return QTensor(torch.clamp(x.q, min=0), x.n, x.width, x.channel_axis)
    return torch.relu(x)


def _windows(x: torch.Tensor, window: int, stride: int, ndim: int) -> torch.Tensor:
    """VALID pooling windows of a channels-last tensor as trailing dims:
    (B, *S, C) -> (B, *S', C, window, ...)."""
    for d in range(1, 1 + ndim):
        x = x.unfold(d, window, stride)
    return x


def _window_dims(ndim: int) -> Tuple[int, ...]:
    return tuple(range(-ndim, 0))


def max_pool(x, window: int, stride: Optional[int] = None, ndim: int = 1):
    """Max pooling over VALID windows: no requantization (paper Sec. 4.3).
    The gradient goes to the first maximum of each window, as XLA's
    ``reduce_window`` max routes it: fake-quantized activations tie often,
    and ``torch.amax`` would split the gradient among the ties."""
    stride = stride or window
    if isinstance(x, QTensor):
        return QTensor(max_pool(x.q, window, stride, ndim), x.n, x.width, x.channel_axis)
    w = _windows(x, window, stride, ndim)
    return torch.max(w.reshape(*w.shape[:w.ndim - ndim], -1), dim=-1).values


def avg_pool_sum(x: torch.Tensor, window: int, stride: int, ndim: int = 1) -> torch.Tensor:
    """Sum over VALID pooling windows (the integer accumulator of ``avg_pool``)."""
    return torch.sum(_windows(x, window, stride, ndim), dim=_window_dims(ndim), dtype=x.dtype)


def avg_pool(x, window: int, stride: Optional[int] = None, ndim: int = 1):
    """Average pooling; integer inputs take an int32 sum and a shift when the
    window size is a power of two (the paper's no-division rule), else an
    integer divide."""
    stride = stride or window
    size = window ** ndim
    if isinstance(x, QTensor):
        acc = avg_pool_sum(x.q.to(torch.int32), window, stride, ndim)
        q = acc >> int(math.log2(size)) if size & (size - 1) == 0 else acc // size
        q = torch.clamp(q, qformat.qmin(x.width), qformat.qmax(x.width))
        return QTensor(q.to(x.q.dtype), x.n, x.width, x.channel_axis)
    return avg_pool_sum(x, window, stride, ndim) / size


def global_avg_pool(x, ndim: int = 1):
    """Mean over all spatial axes (an integer divide for QTensor inputs)."""
    axes = tuple(range(1, 1 + ndim))
    if isinstance(x, QTensor):
        size = math.prod(x.q.shape[a] for a in axes)
        acc = torch.sum(x.q.to(torch.int32), dim=axes, dtype=torch.int32)
        q = torch.clamp(acc // size, qformat.qmin(x.width), qformat.qmax(x.width))
        return QTensor(q.to(x.q.dtype), x.n, x.width, x.channel_axis)
    return torch.mean(x, dim=axes)


def dropout(x: torch.Tensor, rate: float, ctx: Context, name: str = "dropout") -> torch.Tensor:
    """Inverted dropout; the identity when not training, at rate 0 or
    without ``ctx.rng``.  The mask comes from ``ctx.fold_rng(name)``."""
    if not ctx.train or rate <= 0.0 or ctx.rng is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=ctx.fold_rng(name), device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def qadd(a, b, ctx: Context, site: str = "add", n_out=None):
    """Element-wise add with the paper's Add-layer semantics (Sec. 4.3): the
    output gets its own exponent.  Integer path: both operands aligned to a
    common format in int32, added, requantized and saturated."""
    if isinstance(a, QTensor) and isinstance(b, QTensor):
        n_common = torch.minimum(torch.as_tensor(a.n), torch.as_tensor(b.n))
        acc = qformat.align(a.q, a.n, n_common, torch.int32) + \
            qformat.align(b.q, b.n, n_common, torch.int32)
        if n_out is None:
            n_out = ctx.frozen(f"{site}/out")
            if n_out is None:
                raise ValueError(f"integer add needs a calibrated exponent at {ctx.key(site)}")
        return QTensor(qformat.requantize(acc, n_common, n_out, a.width), n_out, a.width)
    y = a + b
    if ctx.policy.enabled and ctx.policy.mode is not QMode.INTEGER:
        y = _fq_out(y, ctx.scope(site), "out")
    return y
