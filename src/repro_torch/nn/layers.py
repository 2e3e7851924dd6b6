"""Dense, Embedding and RMSNorm (``repro/nn/layers.py``), float32 throughout.

``Dense`` has the float path, the weight-only int8 path (an int8
:class:`QTensor` kernel goes through ``kernels.ops.wq_matmul``) and the
packed sub-int8 path (a :class:`PackedQTensor` kernel goes through
``kernels.ops.wq4_matmul``).  The
fake-quant and full-integer paths of the reference wait for the training
and integer-engine slices of the port.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import qformat
from repro_torch.core.policy import QMode
from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.nn.module import Context, Params


def _later_slice(what: str):
    return NotImplementedError(f"{what} arrives with a later slice of the port "
                               "(ROADMAP.md queue 1)")


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


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine projection: float, weight-only int8 when the kernel is a QTensor,
    packed int4/int2 when it is a PackedQTensor."""

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

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        ctx = ctx.scope(self.name)
        kernel = params["kernel"]
        bias = params.get("bias")
        if isinstance(kernel, PackedQTensor):
            return self._packed_apply(kernel, bias, x)
        if isinstance(kernel, QTensor):
            return self._weight_only_apply(kernel, bias, x)
        if ctx.policy.mode not in (QMode.OFF, QMode.INTEGER) \
                and self.kind not in ctx.policy.skip_kinds:
            raise _later_slice(f"Dense under policy mode {ctx.policy.mode.value!r}")
        y = torch.matmul(x.to(torch.float32), kernel)
        return y if bias is None else y + bias

    def _weight_only_apply(self, kernel: QTensor, bias, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        y = ops.wq_matmul(x.to(torch.float32), kernel)
        if bias is not None:
            b = bias.dequantize() if isinstance(bias, QTensor) else bias
            y = y + b
        return y

    def _packed_apply(self, kernel: PackedQTensor, bias, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ops

        y = ops.wq4_matmul(x.to(torch.float32), kernel)
        if bias is not None:
            b = bias.dequantize() if isinstance(bias, QTensor) else bias
            y = y + b
        return y


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

    def apply(self, params: Params, ids: torch.Tensor, ctx: Context) -> torch.Tensor:
        table = params["table"]
        if isinstance(table, QTensor):
            # gather int8 rows, dequantize only the gathered slice
            return qformat.dequantize(table.q[ids], table.n)
        if ctx.policy.mode not in (QMode.OFF, QMode.CALIB, QMode.INTEGER) \
                and self.kind not in ctx.policy.skip_kinds:
            raise _later_slice(f"Embedding under policy mode {ctx.policy.mode.value!r}")
        return table[ids]

    def attend(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        """Tied-embedding logits x @ table.T (always float)."""
        table = params["table"]
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
