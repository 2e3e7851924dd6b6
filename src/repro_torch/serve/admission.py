"""Chunked-admission state (``repro/serve/admission.py``).

Only :class:`PrefillLane` is ported: ``AdmissionPlanner`` sizes paged
admissions and waits for ROADMAP slice 3, the preemption policy with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class PrefillLane:
    """One request being prefilled, chunk by chunk, into its reserved (not
    yet live) slot."""

    req: Any                     # serve.scheduler.Request
    slot: int
    prompt: np.ndarray           # (P,) int32
    next_start: int = 0          # first row of the next chunk
