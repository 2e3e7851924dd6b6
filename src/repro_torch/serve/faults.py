"""Deterministic fault injection for the serving scheduler
(``repro/serve/faults.py``, numpy and json only, semantics intact).

A :class:`FaultPlan` is a schedule of failures fixed before the run starts,
which the Scheduler consults at its resource seams, so every degradation
path (page-pool exhaustion, swap-area refusal, admission stalls, NaN/Inf
logits) can be driven on purpose and repeated.  Nothing is random at run
time: :meth:`FaultPlan.random` derives the schedule from a seed once, in
the reference's draw order, so one seed gives one plan in both packages.

The seams (``serve/scheduler.py`` ``run``):

* ``alloc_fail`` ticks make every page allocation answer as if the pool
  were empty: admission defers in the queue and decode growth preempts
  victims, as under genuine exhaustion.  A growth crossing on such a tick
  preempts every eligible victim up to the growing slot itself, so keep
  fault windows finite;
* ``swap_fail`` ticks make ``preempt_policy="swap"`` parking refuse the
  victim's pages: the preemption falls back to recompute, as a full
  ``SwapArea(capacity_bytes=...)`` does;
* ``admit_stall`` ticks hold every new admission for the tick (live decode
  never waits);
* ``nan`` poisons one live decode slot's logits with NaN at (or at the
  first live tick after) a chosen tick.  It needs ``Scheduler(audit=True)``:
  the health sentinel turns the poison into a ``failed`` result instead of
  a stream of garbage.

Fault ticks are virtual time (scheduler ticks), like arrivals and
deadlines, so a plan means the same on every machine.  Under a mesh every
data rank runs the same host loop, so each seam denies on the same ticks
everywhere; a NaN poisons its slot's row on the data rank that holds the
slot (:func:`poison_vector`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, FrozenSet, Iterable, List, Tuple

import numpy as np


def _tickset(ticks: Iterable[int]) -> FrozenSet[int]:
    out = frozenset(int(t) for t in ticks)
    if any(t < 0 for t in out):
        raise ValueError(f"fault ticks must be >= 0, got {sorted(out)}")
    return out


def poison_vector(rows: int, slot: int) -> np.ndarray:
    """A step's (rows,) float32 poison over its sampled rows: NaN at row
    ``slot`` (a decode slot's row), zeros (an exact no-op) elsewhere.
    Under a mesh each data rank's step takes its own rows of it."""
    vec = np.zeros(rows, np.float32)
    vec[slot] = np.nan
    return vec


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected serving faults (module doc).

    ``alloc_fail`` / ``swap_fail`` / ``admit_stall``: the ticks at which
    that seam denies.  ``nan``: {tick: decode slot}; each entry poisons the
    slot's logits at the first tick >= the key at which the slot holds a
    live request.
    """

    alloc_fail: FrozenSet[int] = frozenset()
    swap_fail: FrozenSet[int] = frozenset()
    admit_stall: FrozenSet[int] = frozenset()
    nan: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "alloc_fail", _tickset(self.alloc_fail))
        object.__setattr__(self, "swap_fail", _tickset(self.swap_fail))
        object.__setattr__(self, "admit_stall", _tickset(self.admit_stall))
        nan = {int(t): int(s) for t, s in dict(self.nan).items()}
        if any(t < 0 for t in nan):
            raise ValueError(f"nan ticks must be >= 0, got {sorted(nan)}")
        if any(s < 0 for s in nan.values()):
            raise ValueError(f"nan slots must be >= 0, got {nan}")
        object.__setattr__(self, "nan", nan)

    # ---- the seams the scheduler queries -------------------------------------
    def deny_alloc(self, tick: int) -> bool:
        """True when page allocation must fail at ``tick``."""
        return tick in self.alloc_fail

    def deny_swap(self, tick: int) -> bool:
        """True when swap-out parking must refuse at ``tick``."""
        return tick in self.swap_fail

    def deny_admission(self, tick: int) -> bool:
        """True when new admissions must stall at ``tick``."""
        return tick in self.admit_stall

    def nan_events(self) -> List[Tuple[int, int]]:
        """The (tick, slot) poison schedule, earliest tick first."""
        return sorted(self.nan.items())

    # ---- bookkeeping ------------------------------------------------------------
    @property
    def empty(self) -> bool:
        """True when the plan injects nothing."""
        return not (self.alloc_fail or self.swap_fail or self.admit_stall or self.nan)

    @property
    def max_tick(self) -> int:
        """The last tick any fault fires at (-1 for an empty plan)."""
        ticks = (list(self.alloc_fail) + list(self.swap_fail) + list(self.admit_stall)
                 + list(self.nan))
        return max(ticks) if ticks else -1

    # ---- (de)serialization ---------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """A JSON-serializable dict; ``from_json`` round-trips it."""
        return {"alloc_fail": sorted(self.alloc_fail), "swap_fail": sorted(self.swap_fail),
                "admit_stall": sorted(self.admit_stall),
                "nan": [[t, s] for t, s in self.nan_events()]}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FaultPlan":
        """A plan from a :meth:`to_json`-shaped dict."""
        known = {"alloc_fail", "swap_fail", "admit_stall", "nan"}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown FaultPlan keys {sorted(extra)} "
                             f"(expected a subset of {sorted(known)})")
        nan = obj.get("nan", {})
        if isinstance(nan, (list, tuple)):
            nan = {int(t): int(s) for t, s in nan}
        return cls(alloc_fail=obj.get("alloc_fail", ()), swap_fail=obj.get("swap_fail", ()),
                   admit_stall=obj.get("admit_stall", ()), nan=nan)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """The CLI's form: ``spec`` is inline JSON (starting with ``{``) or the
        path of a JSON file holding a :meth:`to_json` dict."""
        text = spec.strip()
        if not text.startswith("{"):
            with open(spec, "r", encoding="utf-8") as fh:
                text = fh.read()
        return cls.from_json(json.loads(text))

    @classmethod
    def random(cls, seed: int, *, ticks: int, slots: int, alloc_rate: float = 0.05,
               swap_rate: float = 0.05, stall_rate: float = 0.05,
               nan_events: int = 1) -> "FaultPlan":
        """A seeded plan over ``[0, ticks)``: each seam denies a tick with its
        rate, and ``nan_events`` poisons target random slots in ``[0, slots)``."""
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        rng = np.random.default_rng(seed)
        draws = rng.random((3, ticks))
        nan: Dict[int, int] = {}
        for _ in range(nan_events):
            nan[int(rng.integers(0, ticks))] = int(rng.integers(0, slots))
        return cls(alloc_fail=np.flatnonzero(draws[0] < alloc_rate).tolist(),
                   swap_fail=np.flatnonzero(draws[1] < swap_rate).tolist(),
                   admit_stall=np.flatnonzero(draws[2] < stall_rate).tolist(),
                   nan=nan)
