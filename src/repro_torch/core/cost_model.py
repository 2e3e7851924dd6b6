"""Analytic MCU cost model (``repro/core/cost_model.py``): the paper's
Appendix E / Tables A4-A6, so the deployment story of the integer engine
stays reproducible beside the GPU port.

Per-layer integer-ALU op counts (Appendix E, Table A6) with Cortex-M4 cycle
weights: MACC=1, add=1, shift=1, max/saturate=2 (the compiler's cmp+csel
pair; the paper notes SSAT is *not* emitted).  Energy model: E = I * V * t
from the Table 3 board constants.  Pure Python: it touches no tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

# Cycle weights (Appendix E).
CYCLES = {"macc": 1, "add": 1, "shift": 1, "maxsat": 2}

# Table 3 board constants.
BOARDS = {
    # name: (run current A @3.3V 48MHz, supply V, clock Hz, coremark/MHz)
    "nucleo-l452re-p": (4.80e-3, 3.3, 48e6, 3.42),
    "sparkfun-edge": (0.82e-3, 3.3, 48e6, 2.479),
}


@dataclasses.dataclass
class OpCount:
    macc: int = 0
    add: int = 0
    shift: int = 0
    maxsat: int = 0

    def __add__(self, o: "OpCount") -> "OpCount":
        return OpCount(self.macc + o.macc, self.add + o.add,
                       self.shift + o.shift, self.maxsat + o.maxsat)

    @property
    def cycles(self) -> int:
        return (self.macc * CYCLES["macc"] + self.add * CYCLES["add"]
                + self.shift * CYCLES["shift"] + self.maxsat * CYCLES["maxsat"])


def conv1d_ops(f: int, s: int, c: int, k: int) -> OpCount:
    """Conv1D (Table A6): f*s*c*k MACs, 2*f*s shifts, f*s saturations."""
    return OpCount(macc=f * s * c * k, shift=2 * f * s, maxsat=f * s)


def relu_ops(c: int, s: int) -> OpCount:
    return OpCount(maxsat=c * s)


def maxpool_ops(c: int, s: int, k: int) -> OpCount:
    return OpCount(maxsat=c * s * k)


def add_ops(s: int, c: int, i: int = 2) -> OpCount:
    """Residual Add (Table A6): s*c*(i-1) adds, s*c*i shifts, c*s saturations."""
    return OpCount(add=s * c * (i - 1), shift=s * c * i, maxsat=c * s)


def fully_connected_ops(n: int, s: int) -> OpCount:
    return OpCount(macc=n * s, shift=2 * n, maxsat=n)


def resnet6_ops(filters: int, in_samples: int, in_channels: int,
                kernel: int = 3, pool: int = 4, classes: int = 6) -> OpCount:
    """Op count for the paper's ResNetv1-6 (Fig. 4) on 1D input.

    conv1(f,s,c,k) -> [conv2 -> conv3 + shortcut conv1x1 -> add] -> maxpool
    -> conv4 -> conv5 + add -> global-ish pooling -> FC.  Matches the layer
    list of Fig. 4 (6 convs incl. the 1x1 shortcut, 2 adds, 1 FC).
    """
    f, s, c, k = filters, in_samples, in_channels, kernel
    total = OpCount()
    total += conv1d_ops(f, s, c, k) + relu_ops(f, s)            # conv1 + relu
    total += conv1d_ops(f, s, f, k) + relu_ops(f, s)            # conv2 + relu
    total += conv1d_ops(f, s, f, k)                             # conv3
    total += conv1d_ops(f, s, f, 1)                             # shortcut 1x1
    total += add_ops(s, f) + relu_ops(f, s)                     # add1 + relu
    s2 = s // pool
    total += maxpool_ops(f, s * 1, pool)                        # maxpool k=pool
    total += conv1d_ops(f, s2, f, k) + relu_ops(f, s2)          # conv4 + relu
    total += conv1d_ops(f, s2, f, k)                            # conv5
    total += add_ops(s2, f) + relu_ops(f, s2)                   # add2 + relu
    total += maxpool_ops(f, s2, s2)                             # global maxpool
    total += fully_connected_ops(classes, f)                    # classifier
    return total


def inference_seconds(ops: OpCount, board: str = "nucleo-l452re-p",
                      cpi_overhead: float = 2.0) -> float:
    """Cycles -> seconds at the board clock.

    ``cpi_overhead`` folds loads/stores/branches around the ALU ops (the
    paper's measured times are ~2-3x the pure-ALU cycle count; the *shape*
    across filter sweeps is what Table A4 validates).
    """
    _, _, hz, _ = BOARDS[board]
    return ops.cycles * cpi_overhead / hz


def inference_energy_uwh(seconds: float, board: str = "nucleo-l452re-p") -> float:
    """Energy per inference in µWh (Table A5): E = I*V*t."""
    current, volts, _, _ = BOARDS[board]
    joules = current * volts * seconds
    return joules / 3600.0 * 1e6


def rom_bytes(n_params: int, width_bits: int, code_overhead: int = 40 * 1024) -> int:
    """Model ROM (Table A3): params at width + fixed inference-code overhead."""
    return n_params * width_bits // 8 + code_overhead


@dataclasses.dataclass
class PoolAllocator:
    """The paper's RAM-pool output-buffer allocator (Sec. 5.7).

    Greedy first-fit: each layer output goes to the first pool that neither
    overwrites the layer's own input nor a not-yet-consumed output.  Reports
    total RAM = sum of pool high-water marks — reproduced here because it is
    part of the paper's engine spec (and it doubles as a sanity model for
    activation-memory napkin math).
    """

    pools: List[int] = dataclasses.field(default_factory=list)

    def allocate(self, graph: List[Dict]) -> int:
        """graph: topo-ordered [{'name', 'inputs': [names], 'bytes': int}]."""
        consumers: Dict[str, int] = {}
        for node in graph:
            for inp in node["inputs"]:
                consumers[inp] = consumers.get(inp, 0) + 1
        placement: Dict[str, int] = {}
        live_in_pool: Dict[int, set] = {}
        remaining = dict(consumers)
        for node in graph:
            banned = set()
            for inp in node["inputs"]:
                if inp in placement:
                    banned.add(placement[inp])
            for pid, names in live_in_pool.items():
                if any(remaining.get(nm, 0) > 0 for nm in names):
                    banned.add(pid)
            pool_id = None
            for pid in range(len(self.pools)):
                if pid not in banned:
                    pool_id = pid
                    break
            if pool_id is None:
                pool_id = len(self.pools)
                self.pools.append(0)
                live_in_pool[pool_id] = set()
            self.pools[pool_id] = max(self.pools[pool_id], node["bytes"])
            live_in_pool.setdefault(pool_id, set()).clear()
            live_in_pool[pool_id] = {node["name"]}
            placement[node["name"]] = pool_id
            for inp in node["inputs"]:
                if inp in remaining:
                    remaining[inp] -= 1
        return sum(self.pools)
