"""Continuous batching over per-slot KV caches, dense or paged, and the
restart-the-batch baseline (``repro/serve/scheduler.py``).

:class:`Scheduler` admits queued requests into free slots of one per-slot
cache with a (B,) ``len`` vector and evicts them on EOS or length, under
one of two admission policies:

* *one-shot* (``chunk_size=None``): a freed slot is refilled by a batch-1
  prefill into a scratch cache, copied into the slot (``write_kv_slot``).
  Every live slot stalls for the whole prompt.
* *chunked* (``chunk_size=C``): each tick is one mixed step
  (``engine.make_mixed_step``): every live slot decodes a token and one
  C-token chunk of the oldest queued prompt is written in place into its
  slot (``ops.qchunk_attn`` / ``ops.qpaged_chunk_attn`` for int8 caches).
  ``token_budget`` caps the tick's tokens (live slots + C): when decode
  alone would exceed it, the chunk waits and decode runs;
* *ragged* (``chunk_size=C, ragged=True, prefill_lanes=L``): each tick is
  one ragged forward (``engine.make_ragged_step``) over a flat batch of
  T = B + L*C tokens, every live slot's decode token and one chunk from each
  of up to L admission lanes (``ops.qragged_attn`` for int8 caches, dense
  or paged).  Idle slots and lane tails are inert rows, so every tick, pure
  decode included, has the same shapes.  ``token_budget`` less the live
  slots is split over the lanes in admission order; a lane left without
  room waits (``stalled_chunks``).

With a paged engine (``ServeEngine(paged_kv=True)``, chunked or ragged
admission) the cache is a page pool shared by all slots plus a page table, and
the scheduler runs a host-side allocator (``serve/paging.py``):

* admission allocates the request's pages all or nothing and installs its
  table row; a pool that cannot serve them defers the request in the queue
  (``page_stalls``); eviction unmaps the row, then frees the pages;
* prefix sharing (default on): a prompt whose full leading pages are
  resident maps them (refcounted), prefills from the divergence point, and
  copies a shared page it must write first (copy-on-write);
* oversubscription (``oversubscribe=True``): admission reserves only the
  prompt's pages; decode grows each slot a page at a time, and a dry pool
  preempts a victim (least progress first, with an aging bound) under
  ``preempt_policy``: ``"recompute"`` re-queues it as a continuation prompt,
  ``"swap"`` parks its private pages on the host (``SwapArea``) and restores
  them when a slot and pages free up.  Greedy tokens stay those of the
  unpreempted run.

Hardened serving: every request ends with one of :data:`STATUSES`.  A
``deadline_steps`` expiry is a ``timeout`` wherever the request is (queued,
mid-prefill, parked or live); a host cancel (``run(cancels=...)`` or
:meth:`Scheduler.cancel`) a ``cancelled``; ``max_queue`` bounds the waiting
queue under ``reject_policy`` (``rejected``); a request a dry pool can never
serve, and under ``audit=True`` a slot whose logits turn NaN or Inf, is
``failed``.  ``run(fault_plan=...)`` injects a :class:`~repro_torch.serve.
faults.FaultPlan` at the allocator, swap and admission seams, and
``audit=True`` runs the invariant auditor (``serve/audit.py``) every tick.

Without an ``eos_id`` no token value is needed mid-run, so the loop reads
nothing back from the device and harvests every token at the end; with one,
each tick reads its (B, 1) tokens back.  A swap-out copies the victim's
pages to the host, the one other read-back, as in the reference.
``audit=True`` adds one read-back per tick, the step's health flags, and
with a paged cache a second one at the tick's end: the device page table
and lens, audited against the host state of that moment, so a table breach
raises in its own tick, with the reference's message.
Recurrent-state models (Mamba, RWKV-6) serve through the one-shot and
chunked loops, as in the reference: every batched step runs under the
inactive-slot merge (``slot_state.merge_inactive``), which puts the rows of
slots that did not take part back as they were, and the audited tick checks
that dead slots' recurrent rows are zero from a (leaves, B) array of row
maxima read back with the health flags.  Ragged ticks, paged caches, swap
preemption and one-shot prompt buckets are refused for them with the
reference's messages.  EncDec models (whisper) serve through the chunked
and ragged loops only, as in the reference, every request carrying its
encoder output (``Request.enc``): the scheduler keeps a per-slot (slots,
S_enc, D) encoder buffer, written in place at admission and resume, and
hands it to every step.  With ``engine.cross_attn_cache`` (the default)
admission and resume also project the request's cross-attention K/V once
into the slot's rows (``EncDecLM.write_cross_kv``), and the audited tick
reads every layer's ``xlen`` back with the health flags
(``audit.check_cross_len_rows``).

Under a mesh (``ServeEngine(mesh=...)``, every rank running the same
``run()`` on the same requests) each data rank holds B / D of the slots
and, paged, their block of the pool (``SlotShard``; the allocator's free
list per block), and the steps return the whole batch's tokens (and under
``audit`` their health flags) to every rank in one gather a tick, so every
rank takes the same host decisions and returns the same results and
stats.  Every mode serves there, each slot event acting on the rank that
holds the slot or the pages:

* a slot's pages, grown ones too, come from its rank's block; admission
  takes the lowest free slot whose block can serve the request's plan; a
  dry block preempts a victim among that rank's live slots, and a parked
  request resumes into a slot of the rank that parked it (its kept prefix
  pages and its swapped bytes are there; the other ranks book the same
  bytes);
* the prefix index matches a prompt in the admitting slot's block only;
* the audit checks each rank's block, table rows and swap area, and the
  tick's verdict is agreed over ``data`` in one all-reduce, so every rank
  raises in the same tick; a fault plan's NaN poisons its slot's row on
  the rank that holds it;
* a decode read through an unmapped entry finds the one device's pool
  page 0, mirrored on every rank and refreshed, layer by layer, only on
  the ticks that may have written it (``nn/attention.py`` ``PageZero``).

A per-rank block can change, against one device, the counters that
depend on where pages are (page stalls, preemptions, resumes, swapped
pages, prefix hits and shared pages): ``ROADMAP.md`` pins them.

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

from repro_torch.nn.attention import PageZero, host_tensor
from repro_torch.nn.module import Context, DataRows
from repro_torch.serve.admission import (AdmissionPlanner, Preempted, PrefillLane,
                                         pick_preemption_victim)
from repro_torch.serve.audit import (AuditError, agree_over_data, check_allocator,
                                     check_cross_len_rows, check_page_tables,
                                     check_recurrent_row_max, check_swap)
from repro_torch.serve.engine import (enc_kwargs, make_decode_step, make_mixed_step,
                                      make_prefill_step, make_ragged_step, sample_tokens)
from repro_torch.serve.faults import FaultPlan, poison_vector
from repro_torch.serve.lanes import RaggedTick, assemble_ragged_tick, localize_ragged_tick
from repro_torch.serve.paging import (PageAllocator, PrefixIndex, SwapArea, SwapBooking,
                                      _tree_bytes)
from repro_torch.serve.slot_state import (admit_cache_slot, copy_cache_page, cross_lens,
                                          evict_cache_slot, find_paged_kv, gather_cache_pages,
                                          merge_inactive, recurrent_row_max,
                                          scatter_cache_pages, set_cache_page_entry,
                                          set_cache_page_row, set_cache_slot_len, state_kinds,
                                          swap_bytes_of, SlotShard)


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is the decode-step tick at which
    it becomes visible (0 = available at start).  ``deadline_steps``: a
    request unfinished that many ticks after arrival ends ``"timeout"`` with
    its tokens so far.  ``enc`` (EncDec serving): this request's encoder
    output, (S_enc, D) or (1, S_enc, D); None for a causal model."""

    rid: int
    prompt: Any                 # (P,) int token ids
    max_new: int
    arrival: int = 0
    enc: Any = None
    deadline_steps: Optional[int] = None


#: Terminal request statuses: ``ok`` (ran to EOS or length), ``timeout``
#: (deadline_steps expired), ``cancelled`` (host cancel), ``rejected``
#: (bounded-queue backpressure), ``failed`` (unservable deadlock, or a slot
#: the audit's NaN/Inf sentinel evicted).
STATUSES = ("ok", "timeout", "cancelled", "rejected", "failed")


@dataclasses.dataclass
class RequestResult:
    """The generated ids, the (arrival, admitted, finished) tick timeline and
    how the request ended (one of :data:`STATUSES`; a degraded one carries
    the tokens emitted before it).  ``admitted_at`` is -1 for a request that
    never reached a slot."""

    rid: int
    tokens: List[int]
    prompt_len: int
    arrival: int
    admitted_at: int            # first admission tick; -1 if never admitted
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
    page_stalls: int = 0        # paged: ticks the head request waited for pages
    prefix_hits: int = 0        # paged: admissions that mapped >= 1 resident page
    shared_pages_mapped: int = 0  # paged: page mappings served by the prefix index
    cow_copies: int = 0         # paged: shared pages privatized before a write
    peak_pages_in_use: int = 0  # paged: allocator high-water mark
    peak_live_slots: int = 0    # max live decode slots + mid-prefill lanes
    page_util_sum: float = 0.0  # paged: per-tick live rows / resident pool rows
    page_util_ticks: int = 0
    grown_pages: int = 0        # oversubscription: decode pages allocated lazily
    preemptions: int = 0        # oversubscription: slots evicted mid-decode
    resumes: int = 0            # swap policy: parked requests restored
    swapped_pages: int = 0      # swap policy: private pages copied to the host
    swap_peak_bytes: int = 0    # swap policy: SwapArea high-water mark
    resume_stalls: int = 0      # swap policy: ticks the oldest parked request
    #                             waited for a slot and pages
    swap_refusals: int = 0      # swap parks refused by swap_bytes -> recompute
    truncations: int = 0        # oversize="truncate": requests whose max_new was clamped
    preempted_rids: Dict[int, int] = dataclasses.field(default_factory=dict)
    truncated_rids: Dict[int, int] = dataclasses.field(default_factory=dict)
    ttft_steps: List[int] = dataclasses.field(default_factory=list)
    #                             per request: first admission tick - arrival
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    #                             time_ticks runs with chunked or ragged
    #                             admission: wall seconds from arrival to the
    #                             synced first token (not in the reference)
    completed: int = 0          # requests that ended "ok"
    rejections: int = 0         # bounded queue: requests shed ("rejected")
    timeouts: int = 0           # deadline_steps expiries ("timeout")
    cancellations: int = 0      # host cancels ("cancelled")
    failed: int = 0             # requests that ended "failed"
    deadlock_failures: int = 0  # failed: nothing live, and the pool could never serve them
    nan_evictions: int = 0      # failed: slots the NaN/Inf sentinel evicted (audit)
    fault_events: int = 0       # injected FaultPlan denials and poisons that fired
    audited_ticks: int = 0      # ticks the invariant auditor ran clean
    audit_reads: int = 0        # audit: device-to-host copies: the health flags of
    #                             each stepped tick and, paged, its end-of-tick
    #                             table and lens (not in the reference)
    state_kinds: str = ""       # the served model's slot-state kinds, "+"-joined
    #                             ("kv", "recurrent", "kv+cross"); empty for
    #                             restart batching

    @property
    def completion_rate(self) -> float:
        """``ok`` results over all terminal results (1.0 when none ended)."""
        total = (self.completed + self.rejections + self.timeouts + self.cancellations
                 + self.failed)
        return self.completed / total if total else 1.0

    @property
    def steady_tok_s(self) -> float:
        """Post-warm-up tokens per wall second."""
        return self.tokens_out / self.steady_s if self.steady_s > 0 else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch slots live per decode step."""
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def page_occupancy(self) -> float:
        """Paged: mean live-row fill of the pages requests hold (a page
        mapped by several slots counts once, at its deepest live row);
        0.0 for a dense run."""
        return self.page_util_sum / max(self.page_util_ticks, 1)

    def summary(self) -> Dict[str, Any]:
        lat = np.asarray(self.latencies_steps or [0])
        lat_ms = np.asarray(self.latencies_s or [0.0]) * 1e3
        ttft = np.asarray(self.ttft_steps or [0])
        ttft_ms = np.asarray(self.ttft_s or [0.0]) * 1e3
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
            "page_stalls": self.page_stalls,
            "peak_pages_in_use": self.peak_pages_in_use,
            "peak_live_slots": self.peak_live_slots,
            "page_occupancy": round(self.page_occupancy, 4),
            "prefix_hits": self.prefix_hits,
            "shared_pages_mapped": self.shared_pages_mapped,
            "cow_copies": self.cow_copies,
            "grown_pages": self.grown_pages,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "swapped_pages": self.swapped_pages,
            "swap_peak_bytes": self.swap_peak_bytes,
            "resume_stalls": self.resume_stalls,
            "swap_refusals": self.swap_refusals,
            "truncations": self.truncations,
            "p50_ttft_steps": float(np.percentile(ttft, 50)),
            "p99_ttft_steps": float(np.percentile(ttft, 99)),
            "p50_ttft_ms": round(float(np.percentile(ttft_ms, 50)), 3),
            "p99_ttft_ms": round(float(np.percentile(ttft_ms, 99)), 3),
            "completed": self.completed,
            "rejections": self.rejections,
            "timeouts": self.timeouts,
            "cancellations": self.cancellations,
            "failed": self.failed,
            "completion_rate": round(self.completion_rate, 4),
            "deadlock_failures": self.deadlock_failures,
            "nan_evictions": self.nan_evictions,
            "fault_events": self.fault_events,
            "audited_ticks": self.audited_ticks,
            "audit_reads": self.audit_reads,
            "state_kinds": self.state_kinds,
        }


@dataclasses.dataclass
class _Slot:
    req: Request
    admitted_at: int
    plen: int = 0                # this leg's prompt length (a recompute
    #                              continuation's includes carried tokens)
    emitted: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)  # EOS mode
    first: Any = None            # (1, 1) device first token
    cols: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    #                              no-EOS mode: (slot row, step column) per decode
    #                              token; the row moves when a swap resumes elsewhere


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
    ``ragged`` (chunked only): every tick is one ragged forward over the
    live slots' decode tokens and one chunk from each of up to
    ``prefill_lanes`` admission lanes (more than one lane needs ``ragged``).

    Paged engines require chunked admission.  ``prefix_sharing`` (paged,
    default on) maps resident prompt-prefix pages; ``oversubscribe`` (paged)
    reserves only the prompt's pages and preempts under ``preempt_policy``
    (``"recompute"`` or ``"swap"``) when decode growth finds the pool dry;
    ``preempt_aging`` bounds how often one request is chosen before it is
    spared; ``swap_bytes`` caps the host swap area (a victim that does not
    fit is recomputed).  ``oversize`` decides what happens to a request
    whose prompt + max_new exceeds the table (paged) or ``max_len``:
    ``"reject"`` raises at ``run()``, ``"truncate"`` clamps its ``max_new``
    and records it in ``ServeStats.truncated_rids``.

    ``max_queue`` bounds the arrived-and-waiting queue: an arrival past it
    ends ``"rejected"`` under ``reject_policy="reject"``, or under
    ``"shed_oldest"`` the oldest waiting request is shed in its favor
    (recompute continuations are never shed: they hold served tokens).
    ``audit=True`` runs the invariant auditor every tick and arms the
    NaN/Inf logit sentinel: a slot whose logits turn non-finite ends
    ``"failed"`` instead of streaming garbage.  It costs one device-to-host
    copy per tick (two with a paged cache: the table and lens at the tick's
    end), so it is opt-in.
    """

    def __init__(self, engine, *, eos_id: Optional[int] = None, pad_id: int = 0,
                 prompt_bucket: Optional[int] = None, chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None, prefix_sharing: bool = True,
                 oversubscribe: bool = False, preempt_policy: str = "recompute",
                 preempt_aging: int = 2, oversize: str = "reject",
                 ragged: bool = False, prefill_lanes: int = 1,
                 max_queue: Optional[int] = None, reject_policy: str = "reject",
                 swap_bytes: Optional[int] = None, audit: bool = False):
        self.encdec = engine.encdec
        kinds = list(state_kinds(engine.model))
        if "cross" in kinds and not engine.cross_attn_cache:
            kinds.remove("cross")   # the engine re-projects enc every step
        self.state_kinds: Tuple[str, ...] = tuple(kinds)
        self._has_recurrent = "recurrent" in kinds
        self._cross_cached = "cross" in kinds
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if reject_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"reject_policy must be 'reject' or 'shed_oldest', "
                             f"got {reject_policy!r}")
        self.paged = bool(getattr(engine, "paged_kv", False))
        if chunk_size is not None and chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if swap_bytes is not None and swap_bytes < 0:
            raise ValueError(f"swap_bytes must be >= 0, got {swap_bytes}")
        if oversubscribe and not self.paged:
            raise ValueError("oversubscribe=True requires a paged engine "
                             "(ServeEngine(paged_kv=True)): lazy decode pages grow a page "
                             "table, dense slabs have nothing to grow")
        if preempt_policy not in ("recompute", "swap"):
            raise ValueError(f"preempt_policy must be 'recompute' or 'swap', "
                             f"got {preempt_policy!r}")
        if preempt_aging < 1:
            raise ValueError(f"preempt_aging must be >= 1, got {preempt_aging}")
        if oversize not in ("reject", "truncate"):
            raise ValueError(f"oversize must be 'reject' or 'truncate', got {oversize!r}")
        if self.paged and chunk_size is None:
            raise ValueError("paged KV (engine.paged_kv) requires chunked admission: pass "
                             "chunk_size=... (one-shot admission block-copies a dense "
                             "scratch cache, which has no paged analog)")
        if self.encdec and chunk_size is None:
            raise ValueError(
                "EncDec serving requires chunked admission: pass chunk_size=... (e.g. "
                "Scheduler(engine, chunk_size=32)) — the one-shot slot prefill block-copies "
                "a scratch cache without the request's encoder output or its "
                "cross-attention K/V, so the slot would decode without encoder context")
        if self._has_recurrent:
            if ragged:
                raise ValueError(
                    "ragged=True cannot serve recurrent-state (SSM/RWKV) layers: the ragged "
                    "forward interleaves many slots' tokens in one flattened batch, and a "
                    "recurrence must consume its slot's tokens in order — use the mixed "
                    "step (chunk_size=... without ragged)")
            if self.paged and "kv" not in kinds:
                raise ValueError(
                    "paged KV (engine.paged_kv) on a pure recurrent-state model: there is "
                    "no KV cache to page — recurrent state is a fixed-size per-slot row "
                    "(drop paged_kv; its bytes do not grow with sequence length)")
            if oversubscribe and preempt_policy == "swap":
                raise ValueError(
                    "preempt_policy='swap' cannot serve recurrent-state layers: swap parks "
                    "only KV pool pages, the victim's recurrence rows would be zeroed by "
                    "eviction and resume would continue from corrupt state — use "
                    "preempt_policy='recompute' (re-prefill rebuilds the recurrence "
                    "exactly)")
            if prompt_bucket is not None and chunk_size is None:
                raise ValueError(
                    "prompt_bucket cannot serve recurrent-state layers under one-shot "
                    "admission: bucket padding would run pad tokens through the "
                    "recurrence and corrupt the admitted state (KV slots mask on len; a "
                    "recurrence cannot) — drop prompt_bucket or use chunk_size=...")
        if token_budget is not None:
            if chunk_size is None:
                raise ValueError("token_budget requires chunked admission (chunk_size=...)")
            if token_budget < chunk_size:
                raise ValueError(f"token_budget {token_budget} < chunk_size {chunk_size}: "
                                 f"an idle batch could never admit a chunk")
        if ragged and chunk_size is None:
            raise ValueError("ragged=True requires chunked admission (chunk_size=...): the "
                             "ragged step's prefill lanes carry fixed-size chunks")
        if prefill_lanes < 1:
            raise ValueError(f"prefill_lanes must be >= 1, got {prefill_lanes}")
        if prefill_lanes > 1 and not ragged:
            raise ValueError(f"prefill_lanes={prefill_lanes} requires ragged=True: the mixed "
                             f"step carries exactly one chunk per tick — only the ragged "
                             f"forward flattens several lanes into one batch")
        self._shard = None
        if engine.mesh is not None:
            self._shard = SlotShard(engine.data_rank, engine.local_slots,
                                    engine.local_pages if self.paged else 0)
        self.engine = engine
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.prompt_bucket = prompt_bucket
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        self.prefix_sharing = bool(prefix_sharing) and self.paged
        self.oversubscribe = bool(oversubscribe)
        self.preempt_policy = preempt_policy
        self.preempt_aging = int(preempt_aging)
        self.oversize = oversize
        self.swap_bytes = swap_bytes
        self.ragged = bool(ragged)
        self.prefill_lanes = int(prefill_lanes)
        self.max_queue = max_queue
        self.reject_policy = reject_policy
        self.audit = bool(audit)
        self._cancel_box: set = set()
        self._admission = AdmissionPlanner(
            page_size=engine.page_size, max_pages=engine.kv_max_pages, chunk_size=chunk_size,
            oversubscribe=self.oversubscribe) if self.paged else None
        model, health = engine.model, self.audit
        mk = {"mesh": engine.mesh, "axis_rules": engine.axis_rules}
        self._decode = make_decode_step(model, temperature=engine.temperature,
                                        with_health=health, **mk)
        # recurrent state: the inactive slots' rows are put back after each
        # batched step (between the mixed step's decode and chunk halves)
        self._merge = merge_inactive if self._has_recurrent else None
        self._mixed = make_mixed_step(model, temperature=engine.temperature,
                                      with_health=health, merge=self._merge, **mk)
        self._ragged = make_ragged_step(model, temperature=engine.temperature,
                                        with_health=health, **mk)
        self._prefill = make_prefill_step(model, **mk)

    def cancel(self, rid: int) -> None:
        """Ask the running ``run()`` to cancel ``rid``: it drains the request
        at its next tick, wherever it is (queued, mid-prefill, parked or
        live), as ``"cancelled"`` with its tokens so far.  An unknown or
        finished rid is a no-op."""
        self._cancel_box.add(int(rid))

    # ---- the steps: plain functions over the engine's params ----------------
    # Each returns the step's health flags before the cache: under ``audit``
    # its steps take a trailing poison vector and return them; else None.
    def _poison(self, poison) -> tuple:
        return (poison,) if self.audit else ()

    def _at_slot(self, event, cache, *args):
        """``event(cache, *args)``, a slot-state event (``slot_state``);
        under a mesh on the owner's local slot only (``shard=``)."""
        if self._shard is None:
            return event(cache, *args)
        return event(cache, *args, shard=self._shard)

    def _mine(self, tok):
        """This data rank's rows of the whole batch's (B, 1) tokens (all of
        them without a mesh): what its steps take."""
        return tok if self._shard is None else tok[self.engine.data_rows()]

    @staticmethod
    def _at_page_zero(page_zero) -> dict:
        return {} if page_zero is None else {"page_zero": page_zero}

    def _masked_decode(self, tok, cache, gen, active, poison=None, enc=None, page_zero=None):
        """(tokens (B, 1), masked; flags (B,); cache).  Under a mesh the
        step takes this rank's rows of ``tok`` and ``poison`` and returns
        the whole batch's; ``page_zero``: where its paged reads find the
        one device's page 0."""
        out = self._decode(self.engine.params, self._mine(tok), cache, gen,
                           *self._poison(None if poison is None else self._mine(poison)),
                           **enc_kwargs(enc), **self._at_page_zero(page_zero))
        flags = out[1] if self.audit else None
        new = out[-1] if self._merge is None else self._merge(cache, out[-1], active)
        return torch.where(active[:, None], out[0], self.pad_id), flags, new

    def _masked_mixed(self, tok, cache, gen, active, chunk_tok, slot, start, length,
                      poison=None, enc=None, page_zero=None):
        """(tokens (B, 1), masked; first (1, 1); flags (B + 1,), the decode
        rows' then the first token's; cache)."""
        out = self._mixed(self.engine.params, self._mine(tok), cache, gen, chunk_tok, slot, start,
                          length, *self._poison(None if poison is None else self._mine(poison)),
                          active=active, **enc_kwargs(enc), **self._at_page_zero(page_zero))
        flags = torch.cat([out[2], out[3]]) if self.audit else None
        return torch.where(active[:, None], out[0], self.pad_id), out[1], flags, out[-1]

    def _masked_ragged(self, tok, cache, gen, active, meta: RaggedTick, poison=None,
                       enc=None, lane_slots: Sequence[int] = ()):
        """One ragged tick from its host metadata, sent up as one int32 array
        through pinned memory without blocking.  Returns (the slots' decode
        tokens (B, 1), masked; the lanes' first tokens (L, 1); flags (B + L,);
        cache).  Under a mesh the tick is cut to this data rank's share
        first (``lanes.localize_ragged_tick``; ``lane_slots``: the slots of
        the lanes, in order), and takes this rank's rows of ``poison``."""
        nslots = tok.shape[0]
        lanes, c = meta.ctok.shape
        extra, kw = [], {}
        if self._shard is not None:
            loc = localize_ragged_tick(meta, lane_slots, self._shard, nslots=nslots,
                                       n_lanes=lanes, chunk=c, pad_id=self.pad_id)
            meta, extra = loc.meta, [loc.select, loc.take, loc.owners, loc.sampled]
        n = meta.lrows.shape[0] - lanes
        t = meta.sids.shape[0]
        dev = host_tensor(np.concatenate([meta.sids, meta.poss, meta.lrows,
                                          meta.ctok.reshape(-1)] + extra), tok.device)
        sids, poss = dev[:t], dev[t:2 * t]
        lrows = dev[2 * t:2 * t + n + lanes]
        at = 2 * t + n + lanes + lanes * c
        ctok = dev[at - lanes * c:at]
        if extra:
            sel, take = extra[0].shape[0], extra[1].shape[0]
            at_s = at + sel + take + lanes
            kw = {"rows": DataRows(select=dev[at:at + sel].long(),
                                   take=dev[at + sel:at + sel + take].long()),
                  "owners": dev[at + sel + take:at_s].long()}
            if poison is not None:
                poison = poison[dev[at_s:].long()]
        out = self._ragged(self.engine.params, self._mine(tok), cache, gen, ctok.view(lanes, c),
                           sids, poss, lrows, *self._poison(poison), **enc_kwargs(enc), **kw)
        flags = out[1] if self.audit else None
        return (torch.where(active[:, None], out[0][:nslots], self.pad_id), out[0][nslots:],
                flags, out[-1])

    def _write_xkv(self, cache, enc_row: torch.Tensor, slot: int):
        """Project one request's cross-attention K/V into ``slot``'s rows of
        the cache, in place (``EncDecLM.write_cross_kv``)."""
        return self.engine.model.write_cross_kv(self.engine.params, cache, enc_row, slot,
                                                Context())

    def _encoder_rows(self, requests: Sequence[Request]) -> Dict[int, torch.Tensor]:
        """Each request's encoder output as a (1, S_enc, D) tensor on the
        engine's device, checked as the reference checks them: one shape for
        the run, and with the cross-attention cache at most ``enc_len``
        rows."""
        dev = self.engine.device
        enc_of: Dict[int, torch.Tensor] = {}
        for r in requests:
            row = r.enc.to(dev) if isinstance(r.enc, torch.Tensor) \
                else host_tensor(np.array(r.enc), dev)
            if row.ndim == 2:
                row = row[None]
            if row.ndim != 3 or row.shape[0] != 1:
                raise ValueError(f"request {r.rid}: enc must be (S_enc, D) or (1, S_enc, D), "
                                 f"got {tuple(row.shape)}")
            enc_of[r.rid] = row
        shapes = {tuple(v.shape) for v in enc_of.values()}
        if len(shapes) > 1:
            raise ValueError(f"all requests must share one encoder shape per run (one jitted "
                             f"step signature), got {sorted(shapes)}")
        if self._cross_cached and shapes:
            el = int(self.engine.model.enc_len)
            (one,) = shapes
            if one[1] > el:
                raise ValueError(f"encoder output length {one[1]} exceeds the model's "
                                 f"cross-attention cache capacity enc_len={el}: the cached "
                                 f"xk/xv rows would truncate the encoder context — raise "
                                 f"enc_len or shorten the encoder output")
        return enc_of

    def _slot_prefill(self, tokens, plen: int, gen, slot: int):
        """(1, P) prompt for ``slot`` -> (first token (1, 1), batch-1 cache),
        the LM head over the true last position only.  Under a mesh every
        data rank prefills the prompt alike (the slot's owner then admits
        it): the logits, and so the token, are the same on every rank."""
        eng = self.engine
        kw = {} if self._shard is None else {"owner": self._shard.owner(slot)}
        logits, small = self._prefill(eng.params, tokens, eng.new_cache(batch=1),
                                      logit_pos=plen - 1, **kw)
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
    def warmup(self, prompt_lens: Sequence[int], *, seed: int = 0,
               enc: Optional[torch.Tensor] = None) -> float:
        """Run every step the run will take once against throwaway state (the
        first calls build the kernels and warm the allocator), so the
        measured loop is steady state.  Returns the seconds it took.

        One-shot admission prefills once per distinct (bucketed) prompt
        length; chunked admission runs one mixed step (paged: after a
        throwaway page assignment for slot 0 and its table events).  Both
        then run one decode step and evict slot 0.  Ragged admission runs one
        ragged tick of inert rows at the run's fixed T instead, then evicts
        slot 0.  Under ``audit`` the steps take all-zero poison vectors.
        ``enc`` (EncDec serving) is the run's per-slot encoder buffer: the
        steps take a zeroed one of its shape, whose slot 0 row (with the
        cross-attention cache) is projected into the throwaway cache first.
        """
        eng = self.engine
        t0 = time.perf_counter()
        gen = self._generator(seed)
        cache = eng.new_cache(per_slot=True)
        tok = torch.full((eng.batch_slots, 1), self.pad_id, dtype=torch.int32,
                         device=eng.device)
        active = torch.ones(eng.batch_slots, dtype=torch.bool, device=eng.device)
        lanes = self.prefill_lanes if self.ragged else 0
        pz = torch.zeros(eng.batch_slots + lanes, dtype=torch.float32, device=eng.device) \
            if self.audit else None
        # under a mesh of several data ranks over a paged pool, the decode
        # reads find page 0 in the mirror, refreshed (the collective built)
        pz0 = self._page_zero(True)
        with torch.inference_mode():
            if enc is not None:
                enc = torch.zeros_like(enc)
                if self._cross_cached:
                    cache = self._write_xkv(cache, enc[:1], 0)
            if self.chunk_size is not None:
                if self.paged:
                    n = min(self._admission.pages_needed(self.chunk_size, 1), eng.local_pages)
                    cache = self._at_slot(set_cache_page_row, cache, 0,
                                          self._admission.page_row(list(range(n))))
                    cache = self._at_slot(set_cache_page_entry, cache, 0, n - 1, n - 1)
                    cache = self._at_slot(set_cache_slot_len, cache, 0, 0)
                    if self.prefix_sharing:
                        cache = copy_cache_page(cache, 0, n - 1)
                if self.ragged:
                    b, lanes, c = eng.batch_slots, self.prefill_lanes, self.chunk_size
                    meta = RaggedTick(sids=np.zeros(b + lanes * c, np.int32),
                                      poss=np.full(b + lanes * c, -1, np.int32),
                                      ctok=np.full((lanes, c), self.pad_id, np.int32),
                                      lrows=np.zeros(b + lanes, np.int32), ran=[], stalled=0)
                    tok, firsts, _, cache = self._masked_ragged(tok, cache, gen, active, meta,
                                                                pz, enc)
                    tok = self._set_tok(tok, firsts[:1], 0)
                    cache = self._at_slot(evict_cache_slot, cache, 0)
                    _sync(eng.device)
                    return time.perf_counter() - t0
                ctok = torch.full((1, self.chunk_size), self.pad_id, dtype=torch.int32,
                                  device=eng.device)
                tok, first, _, cache = self._masked_mixed(tok, cache, gen, active, ctok, 0, 0,
                                                          self.chunk_size, pz, enc, pz0)
                tok = self._set_tok(tok, first, 0)
            else:
                for p in sorted({self._bucket(int(p)) for p in prompt_lens}):
                    toks = torch.full((1, p), self.pad_id, dtype=torch.int32,
                                      device=eng.device)
                    first, small = self._slot_prefill(toks, p, gen, 0)
                    cache = self._at_slot(admit_cache_slot, cache, small, 0, p)
                    tok = self._set_tok(tok, first, 0)
            tok, _, cache = self._masked_decode(tok, cache, gen, active, pz, enc, pz0)
            cache = self._at_slot(evict_cache_slot, cache, 0)
        _sync(eng.device)
        return time.perf_counter() - t0

    def _page_zero(self, refresh: bool) -> Optional[PageZero]:
        """A step's :class:`PageZero` (``refresh``: the step broadcasts data
        rank 0's page 0 into the mirrors, layer by layer), or None where the
        engine keeps no mirror (one device, one data rank, a dense cache)
        and for the ragged tick, whose reads see no unmapped entry."""
        page = self.engine.page_zero_mirror
        if page is None or self.ragged:
            return None
        return PageZero(mesh=self.engine.mesh, axis="data", page=page, refresh=refresh)

    # ---- the serving loop --------------------------------------------------------
    def run(self, requests: Sequence[Request], *, seed: int = 0, warmup: bool = True,
            time_ticks: bool = False, cancels: Optional[Dict[int, int]] = None,
            preempts: Optional[Dict[int, int]] = None, fault_plan: Optional[FaultPlan] = None,
            on_tick=None) -> Tuple[Dict[int, RequestResult], ServeStats]:
        """Serve every request to a terminal status; ({rid: result}, stats).

        Time is discrete: one tick per batched step.  Queued requests become
        visible at their ``arrival`` tick and are admitted into the
        lowest-numbered free slot in (arrival, rid) order.  Every request
        gets one result: ``"ok"`` or a degraded status (:data:`STATUSES`)
        with the tokens emitted before it.  ``run()`` raises only for invalid
        inputs and, under ``audit``, :class:`~repro_torch.serve.audit.
        AuditError` for corrupt state.

        ``cancels={rid: tick}`` cancels ``rid`` at that tick; ``on_tick(t)``
        runs at the top of every tick (and may call :meth:`cancel`).
        ``preempts={rid: tick}`` preempts ``rid`` at the first tick >= ``tick``
        at which it holds a live slot: under ``preempt_policy`` on a paged
        engine, by recompute on a dense one.  ``fault_plan`` injects a
        :class:`FaultPlan`; its NaN events need ``audit=True``.
        ``time_ticks=True`` waits for each tick's tokens and records each
        request's wall-clock latency (summary p50/p99_latency_ms).
        """
        nslots = self.engine.batch_slots
        if fault_plan is not None:
            if fault_plan.nan and not self.audit:
                raise ValueError("FaultPlan.nan requires Scheduler(audit=True): the NaN/Inf "
                                 "sentinel is audit mode's per-tick health read-back — "
                                 "without it the poison would stream garbage tokens "
                                 "undetected")
            for tk, sj in fault_plan.nan.items():
                if not 0 <= sj < nslots:
                    raise ValueError(f"FaultPlan.nan[{tk}] targets slot {sj} outside "
                                     f"[0, {nslots})")
        with torch.inference_mode():
            return self._run(requests, seed=seed, warmup=warmup, time_ticks=time_ticks,
                             cancels={int(k): int(v) for k, v in (cancels or {}).items()},
                             preempts={int(k): int(v) for k, v in (preempts or {}).items()},
                             fault=fault_plan, on_tick=on_tick)

    def _validate(self, requests: Sequence[Request], stats: ServeStats):
        """The requests as served (``oversize="truncate"`` may shorten one)
        and their prompt lengths; raises for a request that cannot be."""
        eng, C = self.engine, self.chunk_size
        plen_of: Dict[int, int] = {}
        checked: List[Request] = []
        for r in requests:
            plen = int(np.asarray(r.prompt).reshape(-1).shape[0])
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            if plen < 1:
                raise ValueError(f"request {r.rid}: empty prompt")
            if r.deadline_steps is not None and r.deadline_steps < 1:
                raise ValueError(f"request {r.rid}: deadline_steps must be >= 1, got "
                                 f"{r.deadline_steps}")
            if self.encdec and r.enc is None:
                raise ValueError(f"request {r.rid}: EncDec serving needs the request's "
                                 f"encoder output (Request.enc) — decoding without it drops "
                                 f"the encoder context entirely")
            if not self.encdec and r.enc is not None:
                raise ValueError(f"request {r.rid}: Request.enc given but the model has no "
                                 f"encoder")
            if C is not None:
                rows = -(-plen // C) * C   # the last (padded) chunk's extent
                # a paged slot is bounded by its table (max_len rounded up to pages)
                cap = eng.kv_max_pages * eng.page_size if self.paged else eng.max_len
                if plen + r.max_new > cap and self.oversize == "truncate" \
                        and max(rows, plen + 1) <= cap:
                    granted = cap - plen
                    print(f"serve: request {r.rid}: truncating max_new {r.max_new} -> "
                          f"{granted} (prompt {plen} + horizon exceeds table capacity {cap})")
                    stats.truncations += 1
                    stats.truncated_rids[r.rid] = granted
                    r = dataclasses.replace(r, max_new=granted)
                if max(rows, plen + r.max_new) > cap:
                    raise ValueError(
                        f"request {r.rid}: prompt {plen} (chunk-padded to {rows}) + max_new "
                        f"{r.max_new} exceeds cache capacity {cap} (max_len {eng.max_len}); "
                        f"its KV rows past the table edge would be dropped and it would "
                        f"decode garbage — shrink the request, raise max_len, or use "
                        f"oversize='truncate'")
            elif self._bucket(plen) + r.max_new > eng.max_len:
                raise ValueError(f"request {r.rid}: prompt {plen} (+bucket) + max_new "
                                 f"{r.max_new} exceeds cache max_len {eng.max_len}")
            if self.paged:
                # under a mesh a slot's pages come from its data rank's block
                need = self._admission.pages_needed(plen, r.max_new)
                if need > eng.local_pages:
                    where = "" if self._shard is None else " block of a data rank"
                    raise ValueError(f"request {r.rid}: needs {need} pages but the pool{where} "
                                     f"holds {eng.local_pages} — it could never be admitted "
                                     f"(raise kv_pool_pages or shrink the request)")
            plen_of[r.rid] = plen
            checked.append(r)
        return checked, plen_of

    def _run(self, requests, *, seed, warmup, time_ticks, cancels, preempts, fault, on_tick):
        eng = self.engine
        nslots, C, dev, ps = eng.batch_slots, self.chunk_size, eng.device, eng.page_size
        stats = ServeStats(state_kinds="+".join(self.state_kinds))
        requests, plen_of = self._validate(requests, stats)
        orig_plen = dict(plen_of)   # recompute preemption moves plen_of
        enc_of = self._encoder_rows(requests) if self.encdec else {}
        # the per-slot encoder buffer: row j is the encoder output of the
        # request in slot j, written in place at admission and resume
        enc_buf = torch.zeros((nslots,) + tuple(next(iter(enc_of.values())).shape[1:]),
                              dtype=next(iter(enc_of.values())).dtype, device=dev) \
            if enc_of else None
        if warmup:
            stats.compile_s = self.warmup([plen_of[r.rid] for r in requests], seed=seed,
                                          enc=enc_buf)

        use_eos = self.eos_id is not None
        # pending: not yet arrived; queue: arrived and waiting (what max_queue bounds)
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        queue: deque = deque()
        cont_rids: set = set()              # recompute continuations: never shed
        cancel_pending: set = set()
        has_deadlines = any(r.deadline_steps is not None for r in requests)
        poison_plan = deque(fault.nan_events()) if fault is not None else deque()
        fault_hold = False                  # this tick idled on an injected denial
        slots: List[Optional[_Slot]] = [None] * nslots
        lanes: List[PrefillLane] = []       # the mixed step drives one, the ragged L
        max_lanes = self.prefill_lanes if self.ragged else 1
        results: Dict[int, RequestResult] = {}
        finished: List[Tuple[_Slot, int, bool, str]] = []  # (slot, tick, eos, status)
        step_cols: List[torch.Tensor] = []  # no-EOS mode: each tick's (B, 1) tokens
        arrival_wall: Dict[int, float] = {}
        cache = eng.new_cache(per_slot=True)
        stats.peak_cache_bytes = eng.cache_bytes(per_slot=True)
        tok = torch.full((nslots, 1), self.pad_id, dtype=torch.int32, device=dev)
        gen = self._generator(seed)
        active_host, active_dev = None, None
        zero_poison = torch.zeros(nslots + (self.prefill_lanes if self.ragged else 0),
                                  dtype=torch.float32, device=dev) if self.audit else None
        shard = self._shard
        alloc = PageAllocator(eng.kv_num_pages, blocks=eng.data_size) if self.paged else None
        index = (PrefixIndex(ps) if shard is None else PrefixIndex(ps, eng.local_pages)) \
            if self.prefix_sharing else None
        planner = self._admission
        slot_pages: Dict[int, List[int]] = {}
        prompt_keys: Dict[int, List[bytes]] = {}   # rid -> cached prompt digests
        carry: Dict[int, List[int]] = {}     # recompute: earlier legs' tokens
        first_admit: Dict[int, int] = {}     # rid -> first admission tick
        preempted: List[Preempted] = []      # swap policy: parked requests
        swap = SwapArea(capacity_bytes=self.swap_bytes) \
            if self.oversubscribe and self.preempt_policy == "swap" else None
        t = 0

        def install_enc(j: int, rid: int) -> None:
            """Slot j's encoder row and, with the cross-attention cache, its
            projected K/V rows: once per admission or resume."""
            nonlocal cache
            if enc_buf is not None:
                enc_buf[j:j + 1].copy_(enc_of[rid])
                if self._cross_cached:
                    cache = self._write_xkv(cache, enc_of[rid], j)

        def digests_of(r: Request) -> Optional[List[bytes]]:
            """Prompt page digests, hashed once per request."""
            if index is None:
                return None
            if r.rid not in prompt_keys:
                prompt_keys[r.rid] = index.digests(r.prompt)
            return prompt_keys[r.rid]

        def bump(status: str) -> None:
            if status == "ok":
                stats.completed += 1
            elif status == "timeout":
                stats.timeouts += 1
            elif status == "cancelled":
                stats.cancellations += 1
            elif status == "rejected":
                stats.rejections += 1
            else:
                stats.failed += 1

        def release(pages: List[int]) -> None:
            """Drop a reference to each page; retire released pages from the index."""
            released = alloc.free(pages)
            if index is not None:
                index.drop_pages(released)

        def finish(j: int, slot: _Slot, eos: bool, status: str = "ok") -> None:
            nonlocal cache
            finished.append((slot, t, eos, status))
            if status == "ok":
                # a degraded ending's latency is no service time (a timeout's
                # is its deadline), so it stays out of the percentiles
                stats.latencies_steps.append(t - slot.req.arrival)
                if time_ticks and slot.req.rid in arrival_wall:
                    stats.latencies_s.append(time.perf_counter() - arrival_wall[slot.req.rid])
            bump(status)
            # the row is unmapped (in stream order) before its pages re-enter
            # the free list: the next admission may be handed them at once
            cache = self._at_slot(evict_cache_slot, cache, j)
            if alloc is not None and j in slot_pages:
                release(slot_pages.pop(j))
            slots[j] = None

        def admit_live(j: int, r: Request, first) -> None:
            """Slot j goes live holding its freshly sampled first token."""
            slot = _Slot(req=r, admitted_at=t, plen=plen_of[r.rid], emitted=1, first=first)
            slots[j] = slot
            stats.tokens_out += 1
            if r.rid not in first_admit:
                first_admit[r.rid] = t
                stats.ttft_steps.append(t - r.arrival)
                if time_ticks and r.rid in arrival_wall:
                    stats.ttft_s.append(time.perf_counter() - arrival_wall[r.rid])
            if index is not None and j in slot_pages:
                # prefill complete: the full prompt pages become donor candidates
                index.insert_keys(digests_of(r), slot_pages[j][:plen_of[r.rid] // ps])
            if use_eos:
                first_id = int(first.reshape(-1)[0])
                slot.tokens.append(first_id)
                if first_id == self.eos_id or r.max_new == 1:
                    finish(j, slot, first_id == self.eos_id)
            elif r.max_new == 1:
                finish(j, slot, False)

        def requeue(r: Request) -> None:
            """A preemption continuation back into the queue, in (arrival, rid)
            order, past the max_queue bound and immune to shedding."""
            cont_rids.add(r.rid)
            items = sorted(list(queue) + [r], key=lambda q: (q.arrival, q.rid))
            queue.clear()
            queue.extend(items)

        def terminal_queued(r: Request, status: str) -> None:
            """End a request outside a live slot (queued, mid-prefill or
            unservable) with the tokens earlier legs banked, if any."""
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=carry.pop(r.rid, []), prompt_len=orig_plen[r.rid],
                arrival=r.arrival, admitted_at=first_admit.get(r.rid, -1), finished_at=t,
                eos=False, status=status)
            bump(status)

        def fail_slot_state(j: int, r: Request, status: str) -> None:
            """Tear down reserved slot j (unmapped before its pages are freed,
            as in ``finish``) and end its request."""
            nonlocal cache
            cache = self._at_slot(evict_cache_slot, cache, j)
            if alloc is not None and j in slot_pages:
                release(slot_pages.pop(j))
            terminal_queued(r, status)

        def abort_lane(p: PrefillLane, status: str) -> None:
            lanes.remove(p)
            fail_slot_state(p.slot, p.req, status)

        def terminal_parked(p: Preempted, status: str) -> None:
            """End a parked request: its kept prefix references and swapped
            bytes go, its tokens are harvested."""
            preempted.remove(p)
            finished.append((p.slot, t, False, status))
            bump(status)
            release(p.kept)
            if p.slot.req.rid in swap:
                swap.pop(p.slot.req.rid)

        def reap_status(r: Request) -> Optional[str]:
            """The terminal status ``r`` takes this tick (a cancel beats a
            timeout), or None to go on serving it."""
            if r.rid in cancel_pending:
                return "cancelled"
            if r.deadline_steps is not None and t >= r.arrival + r.deadline_steps:
                return "timeout"
            return None

        def home(j: int) -> int:
            """The data rank that holds slot j (0 without a mesh)."""
            return 0 if shard is None else shard.owner(j)

        def pool_alloc(n: int, block: int = 0) -> Optional[List[int]]:
            """``alloc.alloc`` through the fault seam: a ``deny_alloc`` tick
            answers None whatever is free.  Under a mesh from ``block``."""
            nonlocal fault_hold
            if fault is not None and fault.deny_alloc(t):
                stats.fault_events += 1
                fault_hold = True
                return None
            return alloc.alloc(n) if shard is None else alloc.alloc(n, block)

        def harvest_slot_tokens(slot: _Slot) -> List[int]:
            """Tokens this leg emitted so far (one device read in no-EOS mode)."""
            if use_eos:
                return list(slot.tokens)
            vals = [slot.first.reshape(-1)[0]] + [step_cols[c][row, 0] for row, c in slot.cols]
            return [int(x) for x in torch.stack(vals).cpu()]

        def preempt(j: int) -> None:
            """Evict live slot j mid-decode to hand its pages to someone else:
            ``recompute`` (and any preemption on a dense engine) re-queues it
            as prompt + tokens so far; ``swap`` parks its private pages on the
            host (shared prefix pages stay resident under the refcount it
            keeps), or recomputes when the swap seam or area refuses.  Under
            a mesh the rank that holds the slot parks the bytes and every
            other rank books as many (``SwapBooking``)."""
            nonlocal cache
            slot = slots[j]
            rid = slot.req.rid
            stats.preemptions += 1
            stats.preempted_rids[rid] = stats.preempted_rids.get(rid, 0) + 1
            pages = slot_pages.pop(j) if alloc is not None else None
            park = swap is not None
            if park and fault is not None and fault.deny_swap(t):
                stats.fault_events += 1      # an injected host-memory refusal
                stats.swap_refusals += 1
                park = False
            if park:
                # admission keeps shared mappings a leading run of the row
                m = 0
                while m < len(pages) and alloc.refcount(pages[m]) > 1:
                    m += 1
                kept, priv = pages[:m], pages[m:]
                data, pad = None, 0
                if priv:
                    # padded to a power of two of pages, as the reference pads
                    # its compiled gathers: swap_peak_bytes and swap_bytes
                    # refusals count the same bytes
                    pad = 1
                    while pad < len(priv):
                        pad *= 2
                    idx = priv + [priv[0]] * (pad - len(priv))
                    # the host copy completes before the pages re-enter the free list
                    nodes = self._at_slot(gather_cache_pages, cache, idx)
                    data = SwapBooking(swap_bytes_of(cache, pad)) if nodes is None else \
                        [{k: x.cpu().numpy() for k, x in node.items()} for node in nodes]
                if not swap.fits(_tree_bytes(data)):
                    stats.swap_refusals += 1
                    park = False
            if park:
                stats.swapped_pages += len(priv)
                swap.put(rid, data)
                stats.swap_peak_bytes = swap.peak_bytes
                preempted.append(Preempted(slot=slot, kept=kept, n_priv=len(priv), data=data,
                                           pad=pad, live_len=slot.plen + slot.emitted - 1,
                                           last_tok=tok[j:j + 1], home=home(j)))
                cache = self._at_slot(evict_cache_slot, cache, j)
                release(priv)                  # kept pages: references retained
            else:
                toks = harvest_slot_tokens(slot)
                carry[rid] = carry.get(rid, []) + toks
                cont_prompt = np.concatenate([np.asarray(slot.req.prompt, np.int32).reshape(-1),
                                              np.asarray(toks, np.int32)])
                plen_of[rid] = int(cont_prompt.shape[0])
                prompt_keys.pop(rid, None)     # the digests are stale now
                cache = self._at_slot(evict_cache_slot, cache, j)
                if alloc is not None:
                    release(pages)
                requeue(dataclasses.replace(slot.req, prompt=cont_prompt,
                                            max_new=slot.req.max_new - slot.emitted))
            slots[j] = None

        def try_resume() -> None:
            """Restore parked (swap-policy) requests, oldest first, while room
            lasts; under a mesh into a slot of the rank that parked it."""
            nonlocal cache, tok, zero_dirty
            while preempted:
                p = preempted[0]
                free = [j for j in range(nslots)
                        if slots[j] is None and all(ln.slot != j for ln in lanes)
                        and home(j) == p.home]
                got = pool_alloc(p.n_priv, p.home) if free else None
                if got is None:
                    stats.resume_stalls += 1
                    return
                j, rid = free[0], p.slot.req.rid
                data = swap.pop(rid)
                if p.n_priv:
                    # the duplicate pad indices rewrite one page with its own rows
                    cache = self._at_slot(scatter_cache_pages, cache,
                                          got + [got[0]] * (p.pad - p.n_priv), data)
                    zero_dirty = zero_dirty or 0 in got
                row = p.kept + got
                slot_pages[j] = row
                cache = self._at_slot(set_cache_page_row, cache, j, planner.page_row(row))
                cache = self._at_slot(set_cache_slot_len, cache, j, p.live_len)
                tok = self._set_tok(tok, p.last_tok, j)
                install_enc(j, rid)
                if index is not None and rid in prompt_keys:
                    index.insert_keys(prompt_keys[rid], row[:p.slot.plen // ps])
                slots[j] = p.slot
                preempted.pop(0)
                stats.resumes += 1
                stats.peak_pages_in_use = alloc.peak_in_use

        def ensure_growth() -> None:
            """Lazy decode growth: give each live slot about to cross a page
            boundary its next page; preempt a victim when the pool is dry
            (under a mesh: the slot's block, and a victim among the slots
            that block serves)."""
            nonlocal cache
            for j in range(nslots):
                slot = slots[j]
                if slot is None:
                    continue
                need_rows = slot.plen + slot.emitted   # next write position + 1
                while slots[j] is not None and need_rows > len(slot_pages[j]) * ps:
                    if len(slot_pages[j]) >= eng.kv_max_pages:
                        raise RuntimeError(f"slot {j} (rid {slot.req.rid}) needs row "
                                           f"{need_rows} past its page table "
                                           f"({eng.kv_max_pages} pages)")
                    got = pool_alloc(1, home(j))
                    if got is not None:
                        cache = self._at_slot(set_cache_page_entry, cache, j, len(slot_pages[j]),
                                              got[0])
                        slot_pages[j].append(got[0])
                        stats.grown_pages += 1
                        stats.peak_pages_in_use = alloc.peak_in_use
                        continue
                    cands = [(i, s.req.rid, s.emitted, s.admitted_at)
                             for i, s in enumerate(slots) if s is not None and home(i) == home(j)]
                    preempt(pick_preemption_victim(cands, stats.preempted_rids,
                                                   self.preempt_aging))

        def admit_lane() -> bool:
            """Reserve a free slot (and, paged, the request's pages) for the
            oldest arrival; its chunks ride the mixed or ragged step.  False
            when an injected stall holds admission, no slot is free or the
            pool stalls the request (under a mesh: every block that has a
            free slot)."""
            nonlocal cache, fault_hold
            if fault is not None and fault.deny_admission(t):
                stats.fault_events += 1
                fault_hold = True
                return False
            free = [j for j in range(nslots)
                    if slots[j] is None and all(ln.slot != j for ln in lanes)]
            if not free:
                return False
            r, j = queue[0], free[0]
            start0 = 0
            if alloc is not None:
                if fault is not None and fault.deny_alloc(t):
                    # injected pool exhaustion at the admission seam
                    stats.fault_events += 1
                    stats.page_stalls += 1
                    fault_hold = True
                    return False
                # the lowest free slot whose block can serve the plan: under
                # a mesh a dry block spills the request to another rank's
                plan, tried = None, set()
                for cand in free:
                    if home(cand) not in tried:
                        tried.add(home(cand))
                        plan = planner.plan(r, plen_of[r.rid], alloc, index, keys=digests_of(r),
                                            block=None if shard is None else home(cand))
                        if plan is not None:
                            j = cand
                            break
                if plan is None:
                    # head-of-queue blocking: skipping ahead would starve a
                    # large request behind a stream of small ones
                    stats.page_stalls += 1
                    return False
                row_pages, copies, n_share, start0 = plan
                slot_pages[j] = list(row_pages)
                if n_share or copies:
                    stats.prefix_hits += 1
                    stats.shared_pages_mapped += n_share
                    stats.cow_copies += len(copies)
                # privatize the divergence pages before the row that points
                # at the copies; park len at the shared-prefix boundary so
                # the decode half's junk append lands in a private page
                for src, dst in copies:
                    cache = self._at_slot(copy_cache_page, cache, src, dst)
                cache = self._at_slot(set_cache_page_row, cache, j,
                                      planner.page_row(row_pages))
                if start0:
                    cache = self._at_slot(set_cache_slot_len, cache, j, start0)
                stats.peak_pages_in_use = alloc.peak_in_use
            queue.popleft()
            install_enc(j, r.rid)
            lanes.append(PrefillLane(req=r, slot=j,
                                     prompt=np.asarray(r.prompt, np.int32).reshape(-1),
                                     next_start=start0))
            return True

        def read_back(flags: torch.Tensor):
            """Audit's mid-tick device-to-host copy: the (B, 1) tokens in EOS
            mode, the step's health flags, with recurrent state the (leaves,
            B) row maxima of the cache the step left (float32 bits carried as
            int32) and with a cross-attention cache every layer's ``xlen``.
            Returns (tokens or None, flags); the row maxima and the slots dead
            at this moment go to ``rec_read``, the lengths and the slots'
            expected ones at this moment to ``cross_read``."""
            keys, rmax = recurrent_row_max(cache) if self._has_recurrent else ([], None)
            counts, xlens = cross_lens(cache) if self._cross_cached else ([], None)
            parts = ([tok.reshape(-1)] if use_eos else []) + [flags.to(torch.int32)]
            if rmax is not None:
                parts.append(rmax.reshape(-1).view(torch.int32))
            if xlens is not None:
                parts.append(xlens.reshape(-1))
            host = torch.cat(parts).cpu().numpy()
            stats.audit_reads += 1
            k = nslots if use_eos else 0
            at = k + flags.shape[0]
            ok = host[k:at] != 0
            lanes_now = {p_.slot for p_ in lanes}
            if rmax is not None:
                rec_read.update(keys=keys, dead={j_ for j_ in range(nslots)
                                                 if slots[j_] is None and j_ not in lanes_now},
                                maxes=host[at:at + rmax.numel()].view(np.float32)
                                .reshape(len(keys), nslots))
                at += rmax.numel()
            if xlens is not None:
                want = {j_: int(enc_of[s_.req.rid].shape[1]) for j_, s_ in enumerate(slots)
                        if s_ is not None}
                want.update({p_.slot: int(enc_of[p_.req.rid].shape[1]) for p_ in lanes})
                cross_read.update(counts=counts, want=want,
                                  rows=host[at:at + xlens.numel()].reshape(xlens.shape))
            return (host[:nslots].reshape(nslots, 1) if use_eos else None), ok

        def audit_tick() -> None:
            """The invariant auditor at the end of a tick: the allocator, the
            device table and lens (read back now) and the swap area.  Under a
            mesh each data rank checks its block, its slots' rows and its
            swap area, and the verdict is every rank's (``agree_over_data``)."""
            if shard is None:
                audit_checks()
            else:
                err = None
                try:
                    audit_checks()
                except AuditError as e:
                    err = e
                agree_over_data(err, eng.mesh, dev, t - 1)
            stats.audited_ticks += 1

        def audit_checks() -> None:
            holders: Dict[Any, List[int]] = {("slot", j_): pgs for j_, pgs in slot_pages.items()}
            for p_ in preempted:
                holders[("parked", p_.slot.req.rid)] = p_.kept
            if alloc is not None:
                check_allocator(alloc, holders, **({} if shard is None else {"block": shard.rank}))
                kv = find_paged_kv(cache)
                if kv is not None:
                    shape = tuple(kv["page_table"].shape)
                    host = torch.cat([kv["page_table"].reshape(-1), kv["len"]]).cpu().numpy()
                    stats.audit_reads += 1
                    n = shape[0] * shape[1]
                    table, lens = host[:n].reshape(shape), host[n:n + shape[0]]
                    # live decode slots pin their len (plen + emitted - 1 rows
                    # written); a lane only bounds it from below: the mixed
                    # step's masked junk appends may run it past the cursor
                    exact = {j_: s_.plen + s_.emitted - 1 for j_, s_ in enumerate(slots)
                             if s_ is not None}
                    mins = {p_.slot: p_.next_start for p_ in lanes}
                    if shard is None:
                        check_page_tables(table, lens, slot_pages, alloc.refcount,
                                          exact_lens=exact, min_lens=mins, page_size=ps)
                    else:
                        # this rank's rows, in pool ids
                        mine = range(shard.rank * shard.per_rank, (shard.rank + 1) * shard.per_rank)
                        check_page_tables(shard.global_pages(table), lens,
                                          {j_: pgs for j_, pgs in slot_pages.items() if j_ in mine},
                                          alloc.refcount, exact_lens=exact, min_lens=mins,
                                          page_size=ps, slots=mine)
            check_swap(swap, [(p_.slot.req.rid, p_.data) for p_ in preempted])
            if rec_read:
                # dead slots' recurrent rows must be zero.  The rows were read
                # with the step's flags; a slot dead now but live then was
                # evicted since, which zeroes its rows in every leaf of the
                # same walk, so the slots dead at both moments are the ones
                # whose rows the read can still speak for
                live = {j_ for j_, s_ in enumerate(slots) if s_ is not None}
                live |= {p_.slot for p_ in lanes}
                live |= set(range(nslots)) - rec_read["dead"]
                check_recurrent_row_max(rec_read["keys"], rec_read["maxes"], live)
            if cross_read:
                # cached cross-attention lengths, as read with the step's
                # flags, against the slots live or in a lane at that moment:
                # an eviction since then sets xlen to 0 in every layer
                check_cross_len_rows(cross_read["counts"], cross_read["rows"],
                                     cross_read["want"])

        def on_page_zero(j: int, lo: int, hi: int) -> bool:
            """Whether rows [lo, hi) of slot j lie on pool page 0."""
            return 0 in slot_pages.get(j, [])[lo // ps:(hi - 1) // ps + 1]

        def page_zero_of_tick() -> Optional[PageZero]:
            """This tick's :class:`PageZero` (None without a mirror): a
            refresh where page 0 changed since the last one (``zero_dirty``)
            or may change in this step's decode appends, which come before
            its reads: a live slot's next row on it, or a lane's slot that
            maps it (its masked append lands at a length the host does not
            track)."""
            if not mirrored:
                return None
            return self._page_zero(
                zero_dirty or any(0 in slot_pages.get(p_.slot, []) for p_ in lanes)
                or any(s_ is not None and on_page_zero(j_, s_.plen + s_.emitted - 1,
                                                       s_.plen + s_.emitted)
                       for j_, s_ in enumerate(slots)))

        rec_read: Dict[str, Any] = {}       # audit: this tick's recurrent row maxima
        cross_read: Dict[str, Any] = {}     # audit: this tick's cross-attention lengths
        mirrored = self._page_zero(False) is not None
        zero_dirty = False                  # page 0 written since the mirrors' refresh
        t0 = time.perf_counter()
        while pending or queue or lanes or preempted or any(s is not None for s in slots):
            if on_tick is not None:
                on_tick(t)
            fault_hold = False

            # -- arrivals, and the bounded queue's backpressure ---------------------
            while pending and pending[0].arrival <= t:
                r = pending.popleft()
                if time_ticks:
                    arrival_wall.setdefault(r.rid, time.perf_counter())
                if self.max_queue is not None and len(queue) >= self.max_queue:
                    victim = next((q for q in queue if q.rid not in cont_rids), None) \
                        if self.reject_policy == "shed_oldest" else None
                    if victim is not None:
                        queue.remove(victim)
                        print(f"serve: queue full ({self.max_queue}) — shedding oldest "
                              f"waiting request {victim.rid} for arrival {r.rid}")
                        terminal_queued(victim, "rejected")
                        queue.append(r)
                    else:
                        print(f"serve: queue full ({self.max_queue}) — rejecting request "
                              f"{r.rid}")
                        terminal_queued(r, "rejected")
                    continue
                queue.append(r)

            # -- cancels and deadlines, wherever a request is --------------------------
            for rid_, tk_ in cancels.items():
                if tk_ <= t:
                    cancel_pending.add(rid_)
            if self._cancel_box:
                cancel_pending |= self._cancel_box
                self._cancel_box = set()
            if cancel_pending or has_deadlines:
                for r in list(queue):
                    st = reap_status(r)
                    if st:
                        queue.remove(r)
                        cancel_pending.discard(r.rid)
                        terminal_queued(r, st)
                for p in list(lanes):
                    st = reap_status(p.req)
                    if st:
                        cancel_pending.discard(p.req.rid)
                        abort_lane(p, st)
                for p in list(preempted):
                    st = reap_status(p.slot.req)
                    if st:
                        cancel_pending.discard(p.slot.req.rid)
                        terminal_parked(p, st)
                for j in range(nslots):
                    if slots[j] is not None:
                        st = reap_status(slots[j].req)
                        if st:
                            cancel_pending.discard(slots[j].req.rid)
                            finish(j, slots[j], False, status=st)

            # -- forced preemptions: at the first tick >= the key with rid live;
            #    an entry for a request that ended outside a slot is dropped ------
            for rid_, tk_ in list(preempts.items()):
                if tk_ > t:
                    continue
                if rid_ in results:
                    preempts.pop(rid_)
                    continue
                for j in range(nslots):
                    if slots[j] is not None and slots[j].req.rid == rid_:
                        preempt(j)
                        preempts.pop(rid_)
                        break

            # parked requests get the first claim on freed pages, then live
            # slots grow into what remains, before a new admission
            if self.oversubscribe:
                if preempted:
                    try_resume()
                ensure_growth()

            chunk_job: Optional[PrefillLane] = None
            if C is None:
                # one-shot admission; the free slots are read again after each
                # admission, since one that finishes at once frees its slot
                while queue:
                    free = [j for j in range(nslots) if slots[j] is None]
                    if not free:
                        break
                    if fault is not None and fault.deny_admission(t):
                        stats.fault_events += 1
                        fault_hold = True
                        break
                    j, r = free[0], queue.popleft()
                    if any(s is not None for s in slots):
                        stats.admission_stalls += 1
                    padded, plen = self._pad_prompt(r.prompt)
                    first, small = self._slot_prefill(padded, plen, gen, j)
                    cache = self._at_slot(admit_cache_slot, cache, small, j, plen)
                    tok = self._set_tok(tok, first, j)
                    admit_live(j, r, first)
            else:
                while len(lanes) < max_lanes and queue and admit_lane():
                    pass
                if lanes and not self.ragged:
                    n_live = sum(s is not None for s in slots)
                    if self.token_budget is not None and n_live + C > self.token_budget:
                        stats.stalled_chunks += 1    # decode never waits
                    else:
                        chunk_job = lanes[0]

            if not any(s is not None for s in slots) and chunk_job is None \
                    and not (self.ragged and lanes):
                if not lanes:
                    if fault_hold:
                        # an injected denial idled this tick: a passing stall,
                        # not a deadlock (fault windows are finite)
                        t += 1
                        continue
                    # nothing live will ever free a page again: a blocked
                    # resume or a page-stalled head request fails, one at a time
                    if preempted:
                        stats.deadlock_failures += 1
                        print(f"serve: unservable deadlock — parked request "
                              f"{preempted[0].slot.req.rid} cannot resume (pool pages pinned "
                              f"by parked shared prefixes, nothing live to free any); failing "
                              f"it to unblock (raise kv_pool_pages to avoid this)")
                        terminal_parked(preempted[0], "failed")
                        continue
                    if queue:
                        r = queue.popleft()
                        stats.deadlock_failures += 1
                        print(f"serve: request {r.rid} can never be admitted — nothing is "
                              f"live yet its admission plan still cannot be served from the "
                              f"pool ({eng.kv_num_pages} pages); failing it (raise "
                              f"kv_pool_pages or shrink the request)")
                        terminal_queued(r, "failed")
                        continue
                    if pending:                 # idle gap: jump to the next arrival
                        t = max(t + 1, pending[0].arrival)
                continue

            # -- one batched step; free slots emit masked pads --------------------
            active = [s is not None for s in slots]
            stats.peak_live_slots = max(stats.peak_live_slots, sum(active) + len(lanes))
            if active != active_host:       # rebuild the device mask only on change
                active_host = active
                active_dev = host_tensor(np.asarray(active, dtype=np.bool_), dev)
            poison, tok_host, ok_host = zero_poison, None, None
            if self.audit and poison_plan and t >= poison_plan[0][0] \
                    and slots[poison_plan[0][1]] is not None:
                # a NaN event poisons its slot's row at the first tick >= its
                # key at which the slot is live; zeros are an exact no-op
                _, sj = poison_plan.popleft()
                stats.fault_events += 1
                poison = host_tensor(poison_vector(zero_poison.shape[0], sj), dev)
            if self.ragged:
                # one forward: B decode rows + L lanes x C chunk rows; idle
                # slots and lane tails are inert rows
                rt = assemble_ragged_tick(
                    slots, lanes, nslots=nslots, n_lanes=self.prefill_lanes, chunk=C,
                    pad_id=self.pad_id, token_budget=self.token_budget, n_active=sum(active),
                    assert_private=(
                        (lambda sj, lo, hi: planner.assert_private_write(slot_pages[sj], lo,
                                                                         hi, alloc))
                        if alloc is not None else None))
                stats.stalled_chunks += rt.stalled  # decode never waits
                tok, firsts, flags, cache = self._masked_ragged(tok, cache, gen, active_dev,
                                                                rt, poison, enc_buf,
                                                                [p.slot for p in lanes])
                ran = rt.ran
            elif chunk_job is not None:
                start = chunk_job.next_start
                clen = min(C, int(chunk_job.prompt.shape[0]) - start)
                ctok = np.full((1, C), self.pad_id, np.int32)
                ctok[0, :clen] = chunk_job.prompt[start:start + clen]
                if alloc is not None:
                    # the chunk writes C (padded) rows: none through a shared page
                    planner.assert_private_write(slot_pages[chunk_job.slot], start, start + C,
                                                 alloc)
                page_zero = page_zero_of_tick()
                tok, first, flags, cache = self._masked_mixed(
                    tok, cache, gen, active_dev, torch.from_numpy(ctok).to(dev), chunk_job.slot,
                    start, clen, poison, enc_buf, page_zero)
                # the chunk half writes after the decode half's reads
                zero_dirty = mirrored and on_page_zero(chunk_job.slot, start, start + C)
                # lane 0 and flag row B: the ragged tick's layout with one lane
                ran, firsts = [(0, clen)], first
            else:
                page_zero = page_zero_of_tick()
                tok, flags, cache = self._masked_decode(tok, cache, gen, active_dev, poison,
                                                        enc_buf, page_zero)
                zero_dirty = False
                ran = []
            if self.audit:
                tok_host, ok_host = read_back(flags)
            admitted = []                   # (slot, request, first) on last chunks
            done = []
            for li, clen in ran:
                p = lanes[li]
                stats.prefill_chunks += 1
                p.next_start += clen
                if p.next_start >= int(p.prompt.shape[0]):
                    done.append(li)
                    if ok_host is not None and not ok_host[nslots + li]:
                        # non-finite first-token logits: the lane's slot state
                        # is torn down instead of admitted
                        stats.nan_evictions += 1
                        fail_slot_state(p.slot, p.req, "failed")
                        continue
                    first = firsts[li:li + 1]
                    tok = self._set_tok(tok, first, p.slot)
                    admitted.append((p.slot, p.req, first))
            for li in reversed(done):
                lanes.pop(li)
            if time_ticks:
                _sync(dev)
            t += 1
            stats.decode_steps += 1
            stats.occupancy_sum += sum(active) / nslots
            if alloc is not None and alloc.pages_in_use:
                # live rows per resident pool row; a page several slots map
                # counts once, at the deepest live row any of them reaches
                fill: Dict[int, int] = {}

                def _acc(pages: List[int], live: int) -> None:
                    for i, pg in enumerate(pages):
                        rows = min(max(live - i * ps, 0), ps)
                        if rows > fill.get(pg, 0):
                            fill[pg] = rows

                for s_j, s_ in enumerate(slots):
                    if s_ is not None:
                        _acc(slot_pages[s_j], s_.plen + s_.emitted)
                for p_ in lanes:
                    _acc(slot_pages.get(p_.slot, []), p_.next_start)
                for p_ in preempted:       # parked shared prefixes stay live
                    _acc(p_.kept, len(p_.kept) * ps)
                stats.page_util_sum += sum(fill.values()) / (alloc.pages_in_use * ps)
                stats.page_util_ticks += 1
            if use_eos and not self.audit:
                tok_host = tok.cpu().numpy()
            if not use_eos:
                step_cols.append(tok)
            for j in range(nslots):
                slot = slots[j]
                if slot is None:
                    continue
                if ok_host is not None and not ok_host[j]:
                    # non-finite logits in row j: the slot ends "failed" and
                    # its token is never recorded (the harvest stops at the
                    # last healthy one)
                    stats.nan_evictions += 1
                    finish(j, slot, False, status="failed")
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
            if self.audit:
                audit_tick()
        _sync(dev)
        stats.steady_s = time.perf_counter() - t0

        # -- harvest: one device-to-host copy for the whole run (no-EOS mode) --
        mat = torch.cat(step_cols, dim=1).cpu().numpy() if step_cols else None
        for slot, t_fin, eos, status in finished:
            r = slot.req
            if not use_eos:
                slot.tokens = [int(slot.first.reshape(-1)[0])] \
                    + [int(mat[row, c]) for row, c in slot.cols]
            # a recompute continuation's earlier legs come first; the result
            # keeps the original prompt length and first admission tick
            results[r.rid] = RequestResult(
                rid=r.rid, tokens=carry.pop(r.rid, []) + slot.tokens,
                prompt_len=orig_plen[r.rid], arrival=r.arrival,
                admitted_at=first_admit.get(r.rid, slot.admitted_at), finished_at=t_fin,
                eos=eos, status=status)
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
    pad out the batch.  An EncDec model is refused: the restarts carry no
    encoder output (the reference crashes on the None one)."""
    if hasattr(engine.model, "encode"):
        raise ValueError("run_restart_batching cannot serve an EncDec model: its lockstep "
                         "generate() restarts carry no per-request encoder output "
                         "(Request.enc); serve it through Scheduler(chunk_size=...)")
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
