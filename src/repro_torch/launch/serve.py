"""Serving entry point of the port (``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --policy chunked --chunk-size 32 --wq --qkv [--device cpu]

--arch takes every id of the reference's registry (``models/registry.py``):
smollm-135m, glm4-9b, qwen2.5-14b, command-r-plus-104b, internvl2-2b (its
text backbone: serving is text-only, as in the reference), the recurrent
mamba-130m and rwkv6-7b, whisper-tiny, the MoE phi3.5-moe-42b-a6.6b and
kimi-k2-1t-a32b, the hybrid jamba-v0.1-52b, and each one's ``<id>-smoke``.
A full-size model's float32 init must fit the card (glm4-9b: 35 GB,
rwkv6-7b: 29 GB; --wq then holds 8.8 / 7.5 GB of int8 weights; phi3.5-moe
whole is 168 GB, kimi-k2 4.1 TB: serve their -smoke configs or a cut
depth).  An MoE model serves with --wq (int8) or float weights on every
policy; --wq int4/int2 is refused when the engine is built (the reference
fails on packed expert stacks).  jamba (Mamba and attention) serves as the
recurrent models do, with --paged too; --policy ragged raises the
reference's error.  A recurrent model serves through the restart,
scheduler and chunked policies; --paged and --policy ragged raise the
reference's errors, and --qkv has no KV cache to quantize there (the flag
is taken and changes nothing, as in the reference).  whisper-tiny resolves,
but as in the reference this launcher cannot serve it: its workload
carries no encoder output, so the chunked and ragged policies raise the
scheduler's "needs the request's encoder output (Request.enc)", scheduler
raises "requires chunked admission", and restart and lockstep raise the
port's refusal of a missing encoder output (the reference crashes there);
--wq is refused when the engine is built.  EncDec serves through
``ServeEngine`` and its ``Scheduler`` with ``Request.enc``.

--wq   int8 weight-only storage (the ``wq_matmul`` kernel); ``--wq int4`` /
       ``int4-block`` packs two lanes per byte (the ``wq4_matmul`` kernel),
       ``int2`` / ``int2-block`` four (unpacked and multiplied); ``-block``
       gives one scale per ``--wq-block`` K rows (default 32)
--qkv  int8 KV cache on the paper's Qm.n grid (the ``qdecode_attn``,
       ``qchunk_attn`` and ``qragged_attn`` kernels)

Policies ported so far:
  scheduler  continuous batching with one-shot admission: a freed slot is
             refilled by a batch-1 prefill copied into it (every live slot
             stalls for the whole prompt); --prompt-bucket pads prompts
  chunked    continuous batching with chunked admission: every tick is one
             mixed step = all live decode slots + one --chunk-size prompt
             chunk written in place into its slot; --token-budget caps the
             tick's tokens (live slots + chunk; decode always runs)
  ragged     chunked, but every tick is ONE ragged forward over a flat token
             batch: all live decode tokens plus up to --prefill-lanes prompt
             chunks (the ``qragged_attn`` kernel; the same shapes every
             tick); --token-budget is split over the lanes in admission
             order
  restart    restart-the-batch: lockstep generate() per gathered batch,
             everyone waits for the longest request
  lockstep   one generate() over --slots prompts (--requests clamped)
--paged (chunked or ragged policy) serves from a page pool shared by all
slots (the ``qpaged_decode_attn`` and ``qpaged_chunk_attn`` kernels, or
``qragged_attn`` through the table) with prefix
sharing (--no-prefix-sharing turns it off) and, with --oversubscribe, lazy
decode pages and --preempt-policy recompute|swap when the pool runs dry:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --policy chunked --paged --page-size 16 --pool-pages 48 \
        --oversubscribe --preempt-policy swap --wq --qkv

Hardening: --deadline-steps gives every request a deadline in ticks
("timeout"), --max-queue and --reject-policy reject|shed_oldest bound the
waiting queue ("rejected"), --audit runs the invariant auditor every tick
and arms the NaN/Inf logit sentinel ("failed"), and --fault-plan injects a
deterministic fault schedule (inline JSON or a file, ``serve/faults.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --policy chunked --paged --oversubscribe --preempt-policy swap \
        --deadline-steps 600 --max-queue 4 --reject-policy shed_oldest --audit \
        --fault-plan '{"alloc_fail": [6, 7], "nan": [[40, 2]]}' --wq --qkv

Runs on the GPU unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models.registry import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.serve import FaultPlan, Request, ServeEngine, run_restart_batching


def build_workload(args, vocab: int):
    """Request i arrives at tick i*spacing with a --prompt-len prompt and a
    max_new alternating across [--max-new-min, --max-new] and, with
    --deadline-steps, that deadline."""
    rng = np.random.default_rng(args.seed + 1)
    lo = args.max_new_min or args.max_new
    deadline = getattr(args, "deadline_steps", 0) or None
    reqs = []
    for i in range(args.requests):
        max_new = lo if (lo == args.max_new or i % 2 == 0) else args.max_new
        reqs.append(Request(rid=i, prompt=rng.integers(0, vocab, size=args.prompt_len,
                                                       dtype=np.int32),
                            max_new=int(max_new), arrival=i * args.arrival_spacing,
                            deadline_steps=deadline))
    return reqs


def report(name: str, stats) -> None:
    s = stats.summary()
    extra = ""
    if s.get("p99_latency_ms"):
        extra += (f" | latency p50/p99 {s['p50_latency_ms']:.1f}/"
                  f"{s['p99_latency_ms']:.1f} ms")
    if s.get("prefill_chunks"):
        extra += f" | chunks {s['prefill_chunks']} (stalled {s['stalled_chunks']})"
    if s.get("admission_stalls"):
        extra += f" | admission stalls {s['admission_stalls']}"
    if s.get("peak_pages_in_use"):
        extra += (f" | pages peak {s['peak_pages_in_use']} (stalls {s['page_stalls']}, "
                  f"fill {s['page_occupancy']:.2f})")
    if s.get("prefix_hits"):
        extra += (f" | prefix hits {s['prefix_hits']} (shared {s['shared_pages_mapped']} "
                  f"pages, cow {s['cow_copies']})")
    if s.get("grown_pages"):
        extra += (f" | grown {s['grown_pages']} pages (preempt {s['preemptions']}, resume "
                  f"{s['resumes']}, swapped {s['swapped_pages']})")
    if s.get("p99_ttft_steps"):
        extra += (f" | ttft p50/p99 {s['p50_ttft_steps']:.0f}/"
                  f"{s['p99_ttft_steps']:.0f} steps")
    if s.get("rejections", 0) + s.get("timeouts", 0) + s.get("cancellations", 0) \
            + s.get("failed", 0):
        extra += (f" | completion {s['completion_rate']:.2f} (rej {s['rejections']}, "
                  f"timeout {s['timeouts']}, cancel {s['cancellations']}, failed "
                  f"{s['failed']})")
    if s.get("state_kinds"):
        extra += f" | state {s['state_kinds']}"
    if s.get("audited_ticks"):
        extra += f" | audited {s['audited_ticks']} ticks clean"
    if s.get("fault_events"):
        extra += f" | faults {s['fault_events']} (swap refusals {s['swap_refusals']})"
    if s.get("peak_live_slots"):
        extra += f" | peak live {s['peak_live_slots']}"
    print(f"[{name}] warmup(compile) {s['compile_s']:.2f}s | "
          f"steady {s['steady_tok_s']:.1f} tok/s over {s['steady_s']:.3f}s | "
          f"occupancy {s['occupancy']:.2f} | "
          f"latency p50/p99 {s['p50_latency_steps']:.0f}/"
          f"{s['p99_latency_steps']:.0f} steps | "
          f"cache {s['peak_cache_bytes']/1024:.0f} KiB{extra}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", "--batch", type=int, default=4, dest="slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-new-min", type=int, default=0,
                    help="alternate request horizons in [min, max] (0 = uniform --max-new)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arrival-spacing", type=int, default=2,
                    help="decode-step ticks between request arrivals")
    ap.add_argument("--policy", default="scheduler",
                    choices=["chunked", "ragged", "scheduler", "restart", "lockstep"])
    ap.add_argument("--prefill-lanes", type=int, default=2,
                    help="concurrent prompt-chunk lanes per ragged tick (ragged policy; "
                         "1 keeps chunked admission's order with the ragged kernel)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prefill chunk tokens per mixed or ragged step (chunked and "
                         "ragged policies; the last chunk's padded rows must fit max_len)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-tick token cap for chunked and ragged admission (0 = "
                         "unbounded; must fit one chunk)")
    ap.add_argument("--prompt-bucket", type=int, default=0,
                    help="round prompt lengths up to this multiple (0 = exact; "
                         "scheduler policy only)")
    ap.add_argument("--time-ticks", action="store_true",
                    help="wait for every tick and report wall-clock p50/p99 request "
                         "latency (ms)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: a page pool shared by all slots plus per-slot "
                         "page tables, pages allocated per request (chunked or ragged "
                         "policy)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="rows per KV page (paged; 0 = the engine's default)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="KV pool pages shared by all slots (paged; 0 = dense parity: "
                         "slots * ceil(max_len / page_size))")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="paged: do not map resident prompt-prefix pages into new slots")
    ap.add_argument("--oversubscribe", action="store_true",
                    help="paged: admission reserves only the prompt's pages, decode grows "
                         "one page per crossed boundary and preempts a victim when the "
                         "pool runs dry (see --preempt-policy)")
    ap.add_argument("--preempt-policy", default="recompute", choices=["recompute", "swap"],
                    help="with --oversubscribe: 'recompute' re-queues the victim as a "
                         "continuation prompt; 'swap' parks its private pages in host "
                         "memory and restores them bit for bit")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request deadline in ticks (0 = none): a request unfinished "
                         "this many ticks after arrival ends 'timeout' with its tokens "
                         "so far")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the arrived-and-waiting queue (0 = unbounded): arrivals "
                         "past it are shed per --reject-policy as 'rejected'")
    ap.add_argument("--reject-policy", default="reject", choices=["reject", "shed_oldest"],
                    help="bounded queue: reject the arrival, or shed the oldest waiting "
                         "request in its favor")
    ap.add_argument("--audit", action="store_true",
                    help="run the invariant auditor every tick and arm the NaN/Inf logit "
                         "sentinel (one device-to-host copy per tick, two with --paged)")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault injection: inline JSON (starting '{') or a "
                         "JSON file (serve/faults.py FaultPlan.from_spec)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request when this token is sampled (-1 = off)")
    ap.add_argument("--wq", nargs="?", const="int8", default=False,
                    choices=["int8", "int4", "int4-block", "int2", "int2-block"],
                    help="weight-only storage format (bare --wq = int8; int4/int2 pack "
                         "two/four lanes per byte, -block adds per-block scales)")
    ap.add_argument("--wq-block", type=int, default=32,
                    help="K rows per scale block for the --wq *-block formats")
    ap.add_argument("--qkv", action="store_true", help="int8 KV cache")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain kernels)")
    args = ap.parse_args(argv)
    if args.paged and args.policy not in ("chunked", "ragged"):
        raise SystemExit("--paged requires --policy chunked or ragged (pages are allocated "
                         "per request and written through the fused step's chunks)")
    fault_plan = None
    if args.fault_plan:
        fault_plan = FaultPlan.from_spec(args.fault_plan)
        if args.policy in ("restart", "lockstep"):
            raise SystemExit("--fault-plan requires a scheduler policy (chunked, ragged or "
                             "scheduler)")
        if fault_plan.nan and not args.audit:
            raise SystemExit("--fault-plan with nan events requires --audit (the NaN "
                             "sentinel is audit mode's health read-back)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = cfg.build()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # the float params are handed over: --wq frees them leaf by leaf
    engine = ServeEngine(model=model, params=model.init(gen, device), own_params=True,
                         max_len=args.prompt_len + args.max_new,
                         batch_slots=args.slots, quantized_kv=args.qkv,
                         weight_quant=args.wq, weight_block=args.wq_block,
                         temperature=args.temperature,
                         device=device, paged_kv=args.paged,
                         page_size=args.page_size or None,
                         kv_pool_pages=args.pool_pages or None)

    if args.policy == "lockstep":
        n = min(args.requests, args.slots)
        pgen = torch.Generator(device=device).manual_seed(args.seed + 1)
        prompts = torch.randint(0, cfg.vocab, (args.slots, args.prompt_len),
                                generator=pgen, device=device, dtype=torch.int32)
        t0 = time.perf_counter()
        engine.generate(prompts, args.max_new, seed=args.seed)
        _sync(device)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.max_new, seed=args.seed)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"[lockstep] warmup(compile) {warm:.2f}s | "
              f"steady {n * args.max_new / dt:.1f} tok/s over {dt:.3f}s")
        print(out[:n, :16].cpu())
        return out

    reqs = build_workload(args, cfg.vocab)
    eos_id = None if args.eos_id < 0 else args.eos_id
    if args.policy == "restart":
        results, stats = run_restart_batching(engine, reqs, seed=args.seed, eos_id=eos_id)
    else:
        chunked = args.policy in ("chunked", "ragged")
        ragged = args.policy == "ragged"
        sched = engine.scheduler(eos_id=eos_id, prompt_bucket=args.prompt_bucket or None,
                                 chunk_size=args.chunk_size if chunked else None,
                                 token_budget=(args.token_budget or None) if chunked else None,
                                 ragged=ragged,
                                 prefill_lanes=args.prefill_lanes if ragged else 1,
                                 prefix_sharing=not args.no_prefix_sharing,
                                 oversubscribe=args.oversubscribe,
                                 preempt_policy=args.preempt_policy,
                                 max_queue=args.max_queue or None,
                                 reject_policy=args.reject_policy, audit=args.audit)
        results, stats = sched.run(reqs, seed=args.seed, time_ticks=args.time_ticks,
                                   fault_plan=fault_plan)
    report(args.policy, stats)
    first = results[min(results)]
    print(f"request {first.rid}: {len(first.tokens)} tokens "
          f"({first.status}), first-10 {first.tokens[:10]}")
    return results


if __name__ == "__main__":
    main()
