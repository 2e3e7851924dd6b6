"""The paper's evaluation network: ResNetv1-6 (Fig. 4), 1-D and 2-D
(``repro/nn/resnet.py``).

    conv1(k) -> relu
    [conv2(k) -> relu -> conv3(k)] + shortcut conv(1) -> add -> relu
    maxpool(pool)
    [conv4(k) -> relu -> conv5(k)] + identity -> add -> relu
    global max pool -> fully connected(classes)

Float, fake-quant and full-integer paths run end to end: an integer input
arrives as a :class:`QTensor`, activations flow as QTensors (ReLU and max
pooling pass them through without requantization, Add re-aligns its
operands) and the classifier's output is dequantized to float logits.  In
the integer path each forward launches six ``qconv1d`` kernels (1-D) and
one ``qmm``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.qformat import QTensor
from repro_torch.nn.layers import Conv1D, Conv2D, Dense, global_avg_pool, max_pool, qadd, relu
from repro_torch.nn.module import Context, Params, resolve_device


def _global_max_pool(x, ndim: int):
    axes = tuple(range(1, 1 + ndim))
    if isinstance(x, QTensor):
        return QTensor(torch.amax(x.q, dim=axes), x.n, x.width, x.channel_axis)
    return torch.amax(x, dim=axes)


@dataclasses.dataclass(frozen=True)
class ResNetV1_6:
    """The paper's small ResNetv1-6: a conv stem, two residual stages, a
    global pool and a classifier, at a constant ``filters`` width."""

    in_channels: int
    filters: int
    classes: int
    kernel: int = 3
    pool: int = 4
    ndim: int = 1                 # 1 (UCI-HAR / SMNIST) or 2 (GTSRB)
    global_pool: str = "max"      # the paper's net ends in a max pool
    name: str = "resnet6"
    device: Optional[str] = None  # where init puts the parameters

    def _conv(self, cin: int, cout: int, k: int, name: str):
        mk = Conv1D if self.ndim == 1 else Conv2D
        return mk(cin, cout, k, padding="SAME", name=name)

    def _layers(self):
        f, k = self.filters, self.kernel
        return {"conv1": self._conv(self.in_channels, f, k, "conv1"),
                "conv2": self._conv(f, f, k, "conv2"),
                "conv3": self._conv(f, f, k, "conv3"),
                "short1": self._conv(f, f, 1, "short1"),
                "conv4": self._conv(f, f, k, "conv4"),
                "conv5": self._conv(f, f, k, "conv5"),
                "fc": Dense(f, self.classes, name="fc")}

    def init(self, gen: torch.Generator, device=None) -> Params:
        """Random parameters drawn from ``gen`` (a generator on the device:
        ``device``, else the model's, else ``cuda``)."""
        dev = resolve_device(device if device is not None else self.device)
        return {nm: layer.init(gen, dev) for nm, layer in self._layers().items()}

    def apply(self, params: Params, x, ctx: Context):
        """x: (B, S, C) for 1-D, (B, H, W, C) for 2-D, float or QTensor."""
        ctx = ctx.scope(self.name)
        ls = self._layers()
        h = relu(ls["conv1"].apply(params["conv1"], x, ctx))
        r = relu(ls["conv2"].apply(params["conv2"], h, ctx))
        r = ls["conv3"].apply(params["conv3"], r, ctx)
        sc = ls["short1"].apply(params["short1"], h, ctx)
        h = relu(qadd(r, sc, ctx, site="add1"))
        h = max_pool(h, self.pool, ndim=self.ndim)
        r = relu(ls["conv4"].apply(params["conv4"], h, ctx))
        r = ls["conv5"].apply(params["conv5"], r, ctx)
        h = relu(qadd(r, h, ctx, site="add2"))
        h = _global_max_pool(h, self.ndim) if self.global_pool == "max" \
            else global_avg_pool(h, ndim=self.ndim)
        logits = ls["fc"].apply(params["fc"], h, ctx)
        return logits.dequantize() if isinstance(logits, QTensor) else logits
