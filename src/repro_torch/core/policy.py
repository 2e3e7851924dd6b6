"""Quantization policy: the part of ``repro/core/policy.py`` the serving
slice reads (the float32 policy and the int8 serving skip list).
"""
from __future__ import annotations

import dataclasses
import enum


class QMode(enum.Enum):
    OFF = "off"
    QAT = "qat"
    CALIB = "calib"
    EVAL = "eval"
    INTEGER = "integer"


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Static quantization configuration."""

    mode: QMode = QMode.OFF
    weight_bits: int = 8
    act_bits: int = 8
    # Layer kinds that stay float (router logits, norms, SSM state).
    skip_kinds: tuple = ("router", "norm", "ssm_state")

    @property
    def enabled(self) -> bool:
        return self.mode != QMode.OFF

    @staticmethod
    def float32() -> "QuantPolicy":
        return QuantPolicy(mode=QMode.OFF)

    @staticmethod
    def serve_int8() -> "QuantPolicy":
        """Integer serving path (int8 storage)."""
        return QuantPolicy(mode=QMode.INTEGER, weight_bits=8, act_bits=8)
