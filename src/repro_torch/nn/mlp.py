"""Feed-forward blocks (``repro/nn/mlp.py``): the gated ``GatedMLP`` and the
classic two-layer ``MLP`` with biases (whisper)."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import Dense
from repro_torch.nn.module import Context, Params


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": _gelu}


@dataclasses.dataclass(frozen=True)
class GatedMLP:
    """SwiGLU: w_out(act(w_gate(x)) * w_in(x))."""

    d_model: int
    d_ff: int
    activation: str = "silu"
    use_bias: bool = False
    name: str = "mlp"

    def _layers(self):
        return {
            "w_gate": Dense(self.d_model, self.d_ff, self.use_bias, name="w_gate"),
            "w_in": Dense(self.d_model, self.d_ff, self.use_bias, name="w_in"),
            "w_out": Dense(self.d_ff, self.d_model, self.use_bias, name="w_out"),
        }

    def init(self, gen: torch.Generator, device) -> Params:
        return {nm: layer.init(gen, device) for nm, layer in self._layers().items()}

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        ctx = ctx.scope(self.name)
        ls = self._layers()
        g = ls["w_gate"].apply(params["w_gate"], x, ctx)
        h = ls["w_in"].apply(params["w_in"], x, ctx)
        return ls["w_out"].apply(params["w_out"], ACTIVATIONS[self.activation](g) * h, ctx)


@dataclasses.dataclass(frozen=True)
class MLP:
    """Classic two-layer MLP with biases: w_out(act(w_in(x)))."""

    d_model: int
    d_ff: int
    activation: str = "gelu"
    use_bias: bool = True
    name: str = "mlp"

    def _layers(self):
        return {
            "w_in": Dense(self.d_model, self.d_ff, self.use_bias, name="w_in"),
            "w_out": Dense(self.d_ff, self.d_model, self.use_bias, name="w_out"),
        }

    def init(self, gen: torch.Generator, device) -> Params:
        return {nm: layer.init(gen, device) for nm, layer in self._layers().items()}

    def apply(self, params: Params, x: torch.Tensor, ctx: Context) -> torch.Tensor:
        ctx = ctx.scope(self.name)
        ls = self._layers()
        a = ACTIVATIONS[self.activation](ls["w_in"].apply(params["w_in"], x, ctx))
        return ls["w_out"].apply(params["w_out"], a, ctx)
