"""Continuous batching over dense per-slot KV caches, and the
restart-the-batch baseline (``repro/serve/scheduler.py``).

:class:`Scheduler` admits queued requests into free slots of one
``(slots, max_len)`` cache with a (B,) ``len`` vector and evicts them on EOS
or length, under one of two admission policies:

* *one-shot* (``chunk_size=None``): a freed slot is refilled by a batch-1
  prefill into a scratch cache, copied into the slot (``write_kv_slot``).
  Every live slot stalls for the whole prompt.
* *chunked* (``chunk_size=C``): each tick is one mixed step
  (``engine.make_mixed_step``): every live slot decodes a token and one
  C-token chunk of the oldest queued prompt is written in place into its
  slot (``ops.qchunk_attn`` for int8 caches).  ``token_budget`` caps the
  tick's tokens (live slots + C): when decode alone would exceed it, the
  chunk waits and decode runs.

Without an ``eos_id`` no token value is needed mid-run, so the loop reads
nothing back from the device and harvests every token at the end; with one,
each tick reads its (B, 1) tokens back.  The reference's paged pools,
prefix sharing, oversubscription, ragged tick, recurrent and cross-attention
state, fault injection, audit, deadlines and bounded queues wait for later
slices of the port (ROADMAP.md) and raise ``NotImplementedError``.

One deliberate difference: when a one-shot admission finishes at once
(first token EOS, or ``max_new == 1``), the freed slot is refilled in the
same tick.  The reference keeps a stale free list there and fails the next
queued request as "can never be admitted" (``tests/test_scheduler.py::
test_eos_evicts_slot_and_readmits`` fails on it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.admission import PrefillLane
from repro_torch.serve.engine import (make_decode_step, make_mixed_step, make_prefill_step,
                                      sample_tokens)
from repro_torch.serve.slot_state import admit_cache_slot, evict_cache_slot, state_kinds


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is the decode-step tick at which
    it becomes visible (0 = available at start).  ``enc`` (EncDec serving)
    and ``deadline_steps`` wait for later slices and must stay None."""

    rid: int
    prompt: Any                 # (P,) int token ids
    max_new: int
    arrival: int = 0
    enc: Any = None
    deadline_steps: Optional[int] = None


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
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    peak_cache_bytes: int = 0
    prefill_chunks: int = 0     # chunked admission: mixed steps that carried a chunk
    stalled_chunks: int = 0     # chunked admission: ticks the pending chunk sat out
    #                             under token_budget
    admission_stalls: int = 0   # one-shot admission: prefills run while >= 1
    #                             other slot was live
    peak_live_slots: int = 0    # max live decode slots + mid-prefill lanes
    ttft_steps: List[int] = dataclasses.field(default_factory=list)
    #                             per request: admission tick - arrival
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
        lat_ms = np.asarray(self.latencies_s or [0.0]) * 1e3
        ttft = np.asarray(self.ttft_steps or [0])
        return {
            "steady_tok_s": round(self.steady_tok_s, 2),
            "compile_s": round(self.compile_s, 3),
            "steady_s": round(self.steady_s, 4),
            "decode_steps": self.decode_steps,
            "tokens_out": self.tokens_out,
            "occupancy": round(self.occupancy, 4),
            "p50_latency_steps": float(np.percentile(lat, 50)),
            "p99_latency_steps": float(np.percentile(lat, 99)),
            "p50_latency_ms": round(float(np.percentile(lat_ms, 50)), 3),
            "p99_latency_ms": round(float(np.percentile(lat_ms, 99)), 3),
            "peak_cache_bytes": self.peak_cache_bytes,
            "prefill_chunks": self.prefill_chunks,
            "stalled_chunks": self.stalled_chunks,
            "admission_stalls": self.admission_stalls,
            "peak_live_slots": self.peak_live_slots,
            "p50_ttft_steps": float(np.percentile(ttft, 50)),
            "p99_ttft_steps": float(np.percentile(ttft, 99)),
            "completed": self.completed,
        }


@dataclasses.dataclass
class _Slot:
    req: Request
    admitted_at: int
    emitted: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)  # EOS mode
    first: Any = None            # (1, 1) device first token
    cols: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    #                              no-EOS mode: (slot row, step column) per decode token


# Scheduler options of the reference that wait for a later slice of the
# port: name -> (the reference's default, which is accepted, the slice).
_LATER = {
    "prefix_sharing": (True, "ROADMAP slice 3 (paged KV)"),
    "oversubscribe": (False, "ROADMAP slice 3 (paged KV)"),
    "preempt_policy": ("recompute", "ROADMAP slice 3 (paged KV)"),
    "preempt_aging": (2, "ROADMAP slice 3 (paged KV)"),
    "oversize": ("reject", "ROADMAP slice 3 (paged KV)"),
    "swap_bytes": (None, "ROADMAP slice 3 (paged KV)"),
    "ragged": (False, "ROADMAP slice 4 (the ragged tick)"),
    "prefill_lanes": (1, "ROADMAP slice 4 (the ragged tick)"),
    "max_queue": (None, "ROADMAP slice 6 (hardened serving)"),
    "reject_policy": ("reject", "ROADMAP slice 6 (hardened serving)"),
    "audit": (False, "ROADMAP slice 6 (hardened serving)"),
}


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for {where} of the port")


class Scheduler:
    """Continuous batching over a ``ServeEngine``'s model and params.

    ``eos_id``: generation stops when this id is sampled (None = length
    only).  ``pad_id``: emitted by free slots and used to pad prompts.
    ``prompt_bucket`` (one-shot admission): prompts are padded up to a
    multiple of it; the first token is sampled at the true last position
    and the slot's length is the true prompt length, so padding changes no
    token.  ``chunk_size``: chunked admission (the mixed step); the chunk
    grid subsumes bucketing, so ``prompt_bucket`` is then ignored.
    ``token_budget`` (chunked only): per-tick token cap, at least one chunk.
    """

    def __init__(self, engine, *, eos_id: Optional[int] = None, pad_id: int = 0,
                 prompt_bucket: Optional[int] = None, chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"Scheduler got an unexpected keyword argument {name!r}")
            default, where = _LATER[name]
            if value != default:
                raise _later(f"Scheduler({name}={value!r})", where)
        state_kinds(engine.model)       # raises for recurrent / cross-attention models
        if chunk_size is not None and chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if token_budget is not None:
            if chunk_size is None:
                raise ValueError("token_budget requires chunked admission (chunk_size=...)")
            if token_budget < chunk_size:
                raise ValueError(f"token_budget {token_budget} < chunk_size {chunk_size}: "
                                 f"an idle batch could never admit a chunk")
        self.engine = engine
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.prompt_bucket = prompt_bucket
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        model = engine.model
        self._decode = make_decode_step(model, temperature=engine.temperature)
        self._mixed = make_mixed_step(model, temperature=engine.temperature)
        self._prefill = make_prefill_step(model)

    # ---- the steps: plain functions over the engine's params ----------------
    def _masked_decode(self, tok, cache, gen, active):
        nxt, cache = self._decode(self.engine.params, tok, cache, gen)
        return torch.where(active[:, None], nxt, self.pad_id), cache

    def _masked_mixed(self, tok, cache, gen, active, chunk_tok, slot, start, length):
        nxt, first, cache = self._mixed(self.engine.params, tok, cache, gen, chunk_tok,
                                        slot, start, length)
        return torch.where(active[:, None], nxt, self.pad_id), first, cache

    def _slot_prefill(self, tokens, plen: int, gen):
        """(1, P) prompt -> (first token (1, 1), batch-1 cache), the LM head
        over the true last position only."""
        eng = self.engine
        logits, small = self._prefill(eng.params, tokens, eng.new_cache(batch=1),
                                      logit_pos=plen - 1)
        return sample_tokens(logits[:, 0], gen, eng.vocab, eng.temperature), small

    @staticmethod
    def _set_tok(tok, first, slot: int):
        """A copy of ``tok`` with row ``slot`` set to ``first``: earlier
        tokens stay as they were, since the async harvest keeps them."""
        tok = tok.clone()
        tok[slot] = first[0]
        return tok

    # ---- prompt bucketing ----------------------------------------------------
    def _bucket(self, plen: int) -> int:
        if self.prompt_bucket is None:
            return plen
        b = self.prompt_bucket
        return ((plen + b - 1) // b) * b

    def _pad_prompt(self, prompt) -> Tuple[torch.Tensor, int]:
        arr = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(arr.shape[0])
        padded = np.full((1, self._bucket(plen)), self.pad_id, np.int32)
        padded[0, :plen] = arr
        return torch.from_numpy(padded).to(self.engine.device), plen

    def _generator(self, seed: int) -> Optional[torch.Generator]:
        if self.engine.temperature <= 0.0:
            return None
        return torch.Generator(device=self.engine.device).manual_seed(seed)

    # ---- warm-up ---------------------------------------------------------------
    def warmup(self, prompt_lens: Sequence[int], *, seed: int = 0) -> float:
        """Run every step the run will take once against throwaway state (the
        first calls build the kernels and warm the allocator), so the
        measured loop is steady state.  Returns the seconds it took.

        One-shot admission prefills once per distinct (bucketed) prompt
        length; chunked admission runs one mixed step.  Both then run one
        decode step and evict slot 0.
        """
        eng = self.engine
        t0 = time.perf_counter()
        gen = self._generator(seed)
        cache = eng.new_cache(per_slot=True)
        tok = torch.full((eng.batch_slots, 1), self.pad_id, dtype=torch.int32,
                         device=eng.device)
        active = torch.ones(eng.batch_slots, dtype=torch.bool, device=eng.device)
        with torch.inference_mode():
            if self.chunk_size is not None:
                ctok = torch.full((1, self.chunk_size), self.pad_id, dtype=torch.int32,
                                  device=eng.device)
                tok, first, cache = self._masked_mixed(tok, cache, gen, active, ctok, 0, 0,
                                                       self.chunk_size)
                tok = self._set_tok(tok, first, 0)
            else:
                for p in sorted({self._bucket(int(p)) for p in prompt_lens}):
                    toks = torch.full((1, p), self.pad_id, dtype=torch.int32,
                                      device=eng.device)
                    first, small = self._slot_prefill(toks, p, gen)
                    cache = admit_cache_slot(cache, small, 0, p)
                    tok = self._set_tok(tok, first, 0)
            tok, cache = self._masked_decode(tok, cache, gen, active)
            cache = evict_cache_slot(cache, 0)
        _sync(eng.device)
        return time.perf_counter() - t0

    # ---- the serving loop --------------------------------------------------------
    def run(self, requests: Sequence[Request], *, seed: int = 0, warmup: bool = True,
            time_ticks: bool = False, cancels=None, preempts=None, fault_plan=None,
            on_tick=None) -> Tuple[Dict[int, RequestResult], ServeStats]:
        """Serve every request to completion; ({rid: result}, stats).

        Time is discrete: one tick per batched step.  Queued requests become
        visible at their ``arrival`` tick and are admitted into the
        lowest-numbered free slot in (arrival, rid) order.
        ``time_ticks=True`` waits for each tick's tokens and records each
        request's wall-clock latency (summary p50/p99_latency_ms).
        """
        for name, value in (("cancels", cancels), ("preempts", preempts),
                            ("on_tick", on_tick)):
            if value is not None:
                raise _later(f"run({name}=...)", "ROADMAP slice 6 (hardened serving)")
        if fault_plan is not None:
            raise _later("run(fault_plan=...)", "ROADMAP slice 6 (hardened serving)")
        with torch.inference_mode():
            return self._run(requests, seed=seed, warmup=warmup, time_ticks=time_ticks)

    def _validate(self, requests: Sequence[Request]) -> Dict[int, int]:
        eng, C = self.engine, self.chunk_size
        plen_of: Dict[int, int] = {}
        for r in requests:
            plen = int(np.asarray(r.prompt).reshape(-1).shape[0])
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            if plen < 1:
                raise ValueError(f"request {r.rid}: empty prompt")
            if r.deadline_steps is not None:
                raise _later(f"request {r.rid}: deadline_steps",
                             "ROADMAP slice 6 (hardened serving)")
            if r.enc is not None:
                raise _later(f"request {r.rid}: Request.enc (EncDec serving)",
                             "ROADMAP slice 9 (other architectures)")
            if C is not None:
                rows = -(-plen // C) * C   # the last (padded) chunk's extent
                if max(rows, plen + r.max_new) > eng.max_len:
                    raise ValueError(
                        f"request {r.rid}: prompt {plen} (chunk-padded to {rows}) + max_new "
                        f"{r.max_new} exceeds cache capacity {eng.max_len} (max_len "
                        f"{eng.max_len}); shrink the request or raise max_len")
            elif self._bucket(plen) + r.max_new > eng.max_len:
                raise ValueError(f"request {r.rid}: prompt {plen} (+bucket) + max_new "
                                 f"{r.max_new} exceeds cache max_len {eng.max_len}")
            plen_of[r.rid] = plen
        return plen_of

    def _run(self, requests, *, seed, warmup, time_ticks):
        eng = self.engine
        nslots, C, dev = eng.batch_slots, self.chunk_size, eng.device
        stats = ServeStats()
        plen_of = self._validate(requests)
        if warmup:
            stats.compile_s = self.warmup([plen_of[r.rid] for r in requests], seed=seed)

        use_eos = self.eos_id is not None
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        queue: deque = deque()
        slots: List[Optional[_Slot]] = [None] * nslots
        lanes: List[PrefillLane] = []       # the mixed step drives one lane
        finished: List[Tuple[_Slot, int, bool]] = []   # (slot, finish tick, eos)
        step_cols: List[torch.Tensor] = []  # no-EOS mode: each tick's (B, 1) tokens
        arrival_wall: Dict[int, float] = {}
        cache = eng.new_cache(per_slot=True)
        stats.peak_cache_bytes = eng.cache_bytes(per_slot=True)
        tok = torch.full((nslots, 1), self.pad_id, dtype=torch.int32, device=dev)
        gen = self._generator(seed)
        active_host, active_dev = None, None
        t = 0

        def finish(j: int, slot: _Slot, eos: bool) -> None:
            nonlocal cache
            finished.append((slot, t, eos))
            stats.latencies_steps.append(t - slot.req.arrival)
            if time_ticks:
                stats.latencies_s.append(time.perf_counter() - arrival_wall[slot.req.rid])
            stats.completed += 1
            cache = evict_cache_slot(cache, j)
            slots[j] = None

        def admit_live(j: int, r: Request, first) -> None:
            """Slot j goes live holding its freshly sampled first token."""
            slot = _Slot(req=r, admitted_at=t, emitted=1, first=first)
            slots[j] = slot
            stats.tokens_out += 1
            stats.ttft_steps.append(t - r.arrival)
            if use_eos:
                first_id = int(first.reshape(-1)[0])
                slot.tokens.append(first_id)
                if first_id == self.eos_id or r.max_new == 1:
                    finish(j, slot, first_id == self.eos_id)
            elif r.max_new == 1:
                finish(j, slot, False)

        t0 = time.perf_counter()
        while pending or queue or lanes or any(s is not None for s in slots):
            while pending and pending[0].arrival <= t:
                r = pending.popleft()
                if time_ticks:
                    arrival_wall[r.rid] = time.perf_counter()
                queue.append(r)

            chunk_job: Optional[PrefillLane] = None
            if C is None:
                # one-shot admission; the free slots are read again after each
                # admission, since one that finishes at once frees its slot
                while queue:
                    free = [j for j in range(nslots) if slots[j] is None]
                    if not free:
                        break
                    j, r = free[0], queue.popleft()
                    if any(s is not None for s in slots):
                        stats.admission_stalls += 1
                    padded, plen = self._pad_prompt(r.prompt)
                    first, small = self._slot_prefill(padded, plen, gen)
                    cache = admit_cache_slot(cache, small, j, plen)
                    tok = self._set_tok(tok, first, j)
                    admit_live(j, r, first)
            else:
                # chunked admission: reserve a free slot for the oldest arrival;
                # its chunks ride the mixed step
                if not lanes and queue:
                    free = [j for j in range(nslots) if slots[j] is None]
                    if free:
                        r = queue.popleft()
                        lanes.append(PrefillLane(
                            req=r, slot=free[0],
                            prompt=np.asarray(r.prompt, np.int32).reshape(-1)))
                if lanes:
                    n_live = sum(s is not None for s in slots)
                    if self.token_budget is not None and n_live + C > self.token_budget:
                        stats.stalled_chunks += 1    # decode never waits
                    else:
                        chunk_job = lanes[0]

            if not any(s is not None for s in slots) and chunk_job is None:
                if queue or lanes:
                    raise RuntimeError("scheduler: nothing live with a free slot and a "
                                       "waiting request")
                if pending:                 # idle gap: jump to the next arrival
                    t = max(t + 1, pending[0].arrival)
                continue

            # -- one batched step; free slots emit masked pads --------------------
            active = [s is not None for s in slots]
            stats.peak_live_slots = max(stats.peak_live_slots, sum(active) + len(lanes))
            if active != active_host:       # rebuild the device mask only on change
                active_host = active
                active_dev = torch.tensor(active, dtype=torch.bool, device=dev)
            admitted = []                   # (slot, request, first) on last chunks
            if chunk_job is not None:
                start = chunk_job.next_start
                plen = int(chunk_job.prompt.shape[0])
                clen = min(C, plen - start)
                ctok = np.full((1, C), self.pad_id, np.int32)
                ctok[0, :clen] = chunk_job.prompt[start:start + clen]
                tok, first, cache = self._masked_mixed(
                    tok, cache, gen, active_dev, torch.from_numpy(ctok).to(dev),
                    chunk_job.slot, start, clen)
                stats.prefill_chunks += 1
                chunk_job.next_start = start + clen
                if chunk_job.next_start >= plen:
                    tok = self._set_tok(tok, first, chunk_job.slot)
                    admitted.append((chunk_job.slot, chunk_job.req, first))
                    lanes.pop(0)
            else:
                tok, cache = self._masked_decode(tok, cache, gen, active_dev)
            if time_ticks:
                _sync(dev)
            t += 1
            stats.decode_steps += 1
            stats.occupancy_sum += sum(active) / nslots
            tok_host = tok.cpu().numpy() if use_eos else None
            if not use_eos:
                step_cols.append(tok)
            for j in range(nslots):
                slot = slots[j]
                if slot is None:
                    continue
                slot.emitted += 1
                stats.tokens_out += 1
                hit_eos = False
                if use_eos:
                    tid = int(tok_host[j, 0])
                    slot.tokens.append(tid)
                    hit_eos = tid == self.eos_id
                else:
                    slot.cols.append((j, len(step_cols) - 1))
                if hit_eos or slot.emitted >= slot.req.max_new:
                    finish(j, slot, hit_eos)
            for a in admitted:
                admit_live(*a)
        _sync(dev)
        stats.steady_s = time.perf_counter() - t0

        # -- harvest: one device-to-host copy for the whole run (no-EOS mode) --
        mat = torch.cat(step_cols, dim=1).cpu().numpy() if step_cols else None
        results: Dict[int, RequestResult] = {}
        for slot, t_fin, eos in finished:
            r = slot.req
            if not use_eos:
                slot.tokens = [int(slot.first.reshape(-1)[0])] \
                    + [int(mat[row, c]) for row, c in slot.cols]
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=slot.tokens, prompt_len=plen_of[r.rid], arrival=r.arrival,
                admitted_at=slot.admitted_at, finished_at=t_fin, eos=eos)
        return results, stats


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
