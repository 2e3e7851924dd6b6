"""Requests, results, stats and the restart-the-batch policy
(``repro/serve/scheduler.py``).

The continuous-batching ``Scheduler`` and its chunked admission (the
``qchunk_attn`` kernel) are the next slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is the decode-step tick at which
    it becomes visible (0 = available at start)."""

    rid: int
    prompt: Any                 # (P,) int token ids
    max_new: int
    arrival: int = 0


@dataclasses.dataclass
class RequestResult:
    """The generated ids and the (arrival, admitted, finished) tick timeline."""

    rid: int
    tokens: List[int]
    prompt_len: int
    arrival: int
    admitted_at: int
    finished_at: int
    eos: bool
    status: str = "ok"

    @property
    def latency_steps(self) -> int:
        """Queueing + service time in decode-step ticks."""
        return self.finished_at - self.arrival


@dataclasses.dataclass
class ServeStats:
    """Aggregates of one run; ``summary()`` feeds the report line."""

    compile_s: float = 0.0      # warm-up (first run: kernel build, allocator) wall time
    steady_s: float = 0.0       # post-warm-up serving loop wall time
    decode_steps: int = 0
    tokens_out: int = 0
    occupancy_sum: float = 0.0
    latencies_steps: List[int] = dataclasses.field(default_factory=list)
    peak_cache_bytes: int = 0
    completed: int = 0

    @property
    def steady_tok_s(self) -> float:
        """Post-warm-up tokens per wall second."""
        return self.tokens_out / self.steady_s if self.steady_s > 0 else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch slots live per decode step."""
        return self.occupancy_sum / max(self.decode_steps, 1)

    def summary(self) -> Dict[str, Any]:
        lat = np.asarray(self.latencies_steps or [0])
        return {
            "steady_tok_s": round(self.steady_tok_s, 2),
            "compile_s": round(self.compile_s, 3),
            "steady_s": round(self.steady_s, 4),
            "decode_steps": self.decode_steps,
            "tokens_out": self.tokens_out,
            "occupancy": round(self.occupancy, 4),
            "p50_latency_steps": float(np.percentile(lat, 50)),
            "p99_latency_steps": float(np.percentile(lat, 99)),
            "peak_cache_bytes": self.peak_cache_bytes,
            "completed": self.completed,
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_restart_batching(engine, requests: Sequence[Request], *, seed: int = 0,
                         warmup: bool = True, eos_id: Optional[int] = None,
                         ) -> Tuple[Dict[int, RequestResult], ServeStats]:
    """Serve via lockstep ``generate()`` restarts: gather whatever has
    arrived (<= batch_slots), run the whole batch for the longest request's
    horizon, restart.  Late arrivals wait for the restart; short requests
    pad out the batch."""
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    plens = {int(np.asarray(r.prompt).reshape(-1).shape[0]) for r in reqs}
    if len(plens) != 1:
        raise ValueError(f"restart baseline needs equal prompt lengths: {plens}")
    plen = plens.pop()
    nslots = engine.batch_slots
    stats = ServeStats(peak_cache_bytes=engine.cache_bytes())
    max_horizon = max(r.max_new for r in reqs)

    if warmup:
        t0 = time.perf_counter()
        engine.generate(np.zeros((nslots, plen), np.int32), max_horizon, seed=seed)
        _sync(engine.device)
        stats.compile_s = time.perf_counter() - t0

    queue = deque(reqs)
    results: Dict[int, RequestResult] = {}
    t = 0
    t0 = time.perf_counter()
    while queue:
        if queue[0].arrival > t:
            t = queue[0].arrival
        batch: List[Request] = []
        while queue and queue[0].arrival <= t and len(batch) < nslots:
            batch.append(queue.popleft())
        horizon = max(r.max_new for r in batch)
        prompts = np.zeros((nslots, plen), np.int32)
        for i, r in enumerate(batch):
            prompts[i] = np.asarray(r.prompt, np.int32).reshape(-1)
        out = engine.generate(prompts, horizon, seed=seed).cpu().numpy()
        for i, r in enumerate(batch):
            toks = [int(x) for x in out[i, :r.max_new]]
            eos = False
            if eos_id is not None and eos_id in toks:
                toks, eos = toks[:toks.index(eos_id) + 1], True
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=toks, prompt_len=plen, arrival=r.arrival,
                admitted_at=t, finished_at=t + horizon, eos=eos)
            stats.tokens_out += len(toks)
            stats.latencies_steps.append(t + horizon - r.arrival)
        for step in range(horizon):
            stats.occupancy_sum += sum(1 for r in batch if r.max_new > step) / nslots
        stats.decode_steps += horizon
        t += horizon
    stats.steady_s = time.perf_counter() - t0
    stats.completed = len(results)
    return results, stats
