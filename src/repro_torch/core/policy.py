"""Quantization policy: which tensors get quantized, how wide, at what
granularity (``repro/core/policy.py``).

Widths 8 / 9 / 16 (int9 is the paper's Appendix-B PTQ variant; int4/int2
are weight-only serving formats); granularity per-network (one exponent,
e.g. Q7.9), per-layer (the paper's int8 default) or per-channel; modes off,
qat, calib (record activation ranges), eval (fake-quant on frozen scales)
and integer (true integer storage and int32 accumulators).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class QMode(enum.Enum):
    OFF = "off"
    QAT = "qat"
    CALIB = "calib"
    EVAL = "eval"
    INTEGER = "integer"


class Granularity(enum.Enum):
    PER_NETWORK = "per_network"
    PER_LAYER = "per_layer"
    PER_CHANNEL = "per_channel"


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Static quantization configuration."""

    mode: QMode = QMode.OFF
    weight_bits: int = 8
    act_bits: int = 8
    granularity: Granularity = Granularity.PER_LAYER
    # Per-network mode: one exponent for the whole net (the paper's Q7.9 int16).
    network_frac_bits: Optional[int] = None
    # The TFLite-style refinements the paper compares against (affine ranges,
    # non-pow2 scales).
    symmetric: bool = True
    power_of_two: bool = True
    # Layer kinds that stay float (router logits, norms, SSM state).
    skip_kinds: tuple = ("router", "norm", "ssm_state")

    @property
    def enabled(self) -> bool:
        return self.mode != QMode.OFF

    def with_mode(self, mode: QMode) -> "QuantPolicy":
        return dataclasses.replace(self, mode=mode)

    @staticmethod
    def float32() -> "QuantPolicy":
        return QuantPolicy(mode=QMode.OFF)

    @staticmethod
    def int16_ptq() -> "QuantPolicy":
        """The paper's int16 flow: PTQ, per-network Q7.9 (n = 9)."""
        return QuantPolicy(mode=QMode.EVAL, weight_bits=16, act_bits=16,
                           granularity=Granularity.PER_NETWORK, network_frac_bits=9)

    @staticmethod
    def int8_qat() -> "QuantPolicy":
        """The paper's int8 flow: QAT, per-layer pow2 scales."""
        return QuantPolicy(mode=QMode.QAT, weight_bits=8, act_bits=8)

    @staticmethod
    def int9_ptq() -> "QuantPolicy":
        """Appendix-B variant: int9 PTQ."""
        return QuantPolicy(mode=QMode.EVAL, weight_bits=9, act_bits=9)

    @staticmethod
    def serve_int8() -> "QuantPolicy":
        """Integer serving path (int8 storage)."""
        return QuantPolicy(mode=QMode.INTEGER, weight_bits=8, act_bits=8)
