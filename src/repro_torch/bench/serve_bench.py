"""The weight-format and chaos sides of ``benchmarks/serve_bench.py``, on
the port.

``bench_weight_formats`` serves one workload through the chunked scheduler
with each serving weight format (fp32, int8, packed int4 with per-block
scales), repeats it and requires the repeat to give the same tokens, and
counts each format's weight bytes with :func:`weight_payload_bytes`.
``bench_chaos`` drives hardened serving under the reference's fault plan
and ``check_chaos`` gates it.  The entry points run on the card unless
``device`` says otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qformat import PackedQTensor, QTensor
from repro_torch.serve import FaultPlan, Request, ServeEngine

# Weight formats on the serving frontier: engine ``weight_quant`` specs.
WEIGHT_FORMATS = {"fp32": False, "int8": True, "int4": "int4-block"}

# The chaos lane's engines: int8 weights with an int8 KV cache (the
# ``qpaged_*`` kernels) and with a float KV cache.
CHAOS_VARIANTS = {"wq_qkv": {"weight_quant": True, "quantized_kv": True},
                  "wq": {"weight_quant": True}}


def chaos_setup(vocab: int, *, smoke: bool = True, seed: int = 0):
    """The reference's chaos workload and plan: (workload dict, requests,
    FaultPlan).  An oversubscribed swap workload with generous deadlines and
    a bounded queue; the plan mixes pool-exhaustion ticks, swap refusals, an
    admission stall and one NaN event."""
    if smoke:
        wl = dict(n_requests=10, plen=64, max_new=48, spacing=1, slots=10, chunk=32, page=16,
                  pool_pages=21, deadline=600, max_queue=10)
        plan = FaultPlan(alloc_fail={6, 7}, swap_fail={6, 7, 9}, admit_stall={3},
                         nan={40: 2})
    else:
        wl = dict(n_requests=20, plen=128, max_new=96, spacing=1, slots=20, chunk=64, page=16,
                  pool_pages=42, deadline=1200, max_queue=20)
        plan = FaultPlan(alloc_fail={10, 11}, swap_fail={10, 11, 14}, admit_stall={4},
                         nan={80: 3})
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, size=wl["plen"], dtype=np.int32),
                    max_new=wl["max_new"], arrival=i * wl["spacing"],
                    deadline_steps=wl["deadline"])
            for i in range(wl["n_requests"])]
    return wl, reqs, plan


def chaos_scheduler(engine, wl: dict, **kw):
    """The chaos lane's scheduler: chunked, paged, oversubscribed with swap
    preemption, bounded queue, audited."""
    return engine.scheduler(chunk_size=wl["chunk"], prefix_sharing=False, oversubscribe=True,
                            preempt_policy="swap", audit=True, max_queue=wl["max_queue"],
                            reject_policy="reject", **kw)


def check_chaos_run(name: str, reqs, ref_res, ref_st, f_res, f_st) -> dict:
    """The chaos lane's in-run checks of a faulted run against its fault-free
    reference: every request ends, exactly the NaN victim fails (its tokens a
    prefix of its reference stream), no other request times out or is
    rejected, every other stream is token-identical, and the seams fired.
    Returns the lane's record."""
    def need(cond, msg):
        if not cond:
            raise RuntimeError(f"chaos/{name}: {msg}")

    need(all(r.status == "ok" for r in ref_res.values()), "fault-free reference run degraded")
    need(ref_st.audited_ticks > 0, "the fault-free run audited no tick")
    need(sorted(f_res) == sorted(r.rid for r in reqs), "a request has no terminal status")
    failed = sorted(r.rid for r in f_res.values() if r.status == "failed")
    need(f_st.nan_evictions == 1 and len(failed) == 1,
         f"expected exactly the NaN victim to fail, got {failed} (nan_evictions "
         f"{f_st.nan_evictions})")
    victim = failed[0]
    need(f_st.timeouts == 0 and f_st.rejections == 0,
         f"non-faulted requests degraded (timeouts {f_st.timeouts}, rejections "
         f"{f_st.rejections})")
    vtoks = f_res[victim].tokens
    need(vtoks == ref_res[victim].tokens[:len(vtoks)],
         f"NaN victim rid {victim} emitted a poisoned token before eviction")
    for r in reqs:                  # faults reorder the schedule, never the streams
        need(r.rid == victim or f_res[r.rid].tokens == ref_res[r.rid].tokens,
             f"token divergence under faults on non-faulted rid {r.rid}")
    need(f_st.fault_events > 0 and f_st.audited_ticks > 0, "no fault fired or no tick audited")
    need(f_st.swap_refusals > 0, "the swap-refusal seam never fired")
    rate = sum(1 for r in f_res.values() if r.status == "ok") / max(len(reqs) - 1, 1)
    return {"tokens_identical": True,
            "statuses": {s: sum(1 for r in f_res.values() if r.status == s)
                         for s in sorted({r.status for r in f_res.values()})},
            "nan_victim_rid": victim, "victim_clean_tokens": len(vtoks),
            "fault_events": f_st.fault_events, "nan_evictions": f_st.nan_evictions,
            "swap_refusals": f_st.swap_refusals, "preemptions": f_st.preemptions,
            "resumes": f_st.resumes, "deadlock_failures": f_st.deadlock_failures,
            "audited_ticks_faulted": f_st.audited_ticks,
            "audited_ticks_reference": ref_st.audited_ticks,
            "nonfaulted_completion_rate": round(rate, 4),
            "completion_rate": round(f_st.completion_rate, 4)}


def make_workload(n_requests: int, prompt_len: int, short_new: int, long_new: int,
                  spacing: int, vocab: int, seed: int = 0):
    """Request i arrives at tick i * spacing with a random prompt and
    ``short_new`` (even i) or ``long_new`` (odd i) tokens to generate."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=prompt_len, dtype=np.int32),
                    max_new=short_new if i % 2 == 0 else long_new, arrival=i * spacing)
            for i in range(n_requests)]


def weight_payload_bytes(params) -> dict:
    """Serving weight bytes by kind.

    ``kernel_bytes``: the GEMM weight payload (container bytes: 1 per int8
    element, exactly half that for packed int4 at even K); ``table_bytes``:
    the embedding tables; ``scale_bytes``: the exponent grids, 4 bytes per
    exponent, apart so the packed formats' payload is counted alone;
    ``float_bytes``: everything left in float (norms, biases).
    """
    out = {"kernel_bytes": 0, "table_bytes": 0, "scale_bytes": 0, "float_bytes": 0}

    def rec(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v, name)
        elif isinstance(node, PackedQTensor):
            out["kernel_bytes"] += node.nbytes_packed
            out["scale_bytes"] += node.n.numel() * 4
        elif isinstance(node, QTensor):
            key = "table_bytes" if name == "table" else "kernel_bytes"
            out[key] += node.q.numel() * node.q.element_size()
            out["scale_bytes"] += node.n.numel() * 4
        elif isinstance(node, torch.Tensor):
            key = ("kernel_bytes" if name == "kernel"
                   else "table_bytes" if name == "table" else "float_bytes")
            out[key] += node.numel() * node.element_size()

    rec(params, "")
    return out


def bench_weight_formats(model, params, vocab: int, *, smoke: bool = True, seed: int = 0,
                         weight_block: int = 32, device=None) -> dict:
    """Tok/s and weight bytes of each format in :data:`WEIGHT_FORMATS` on the
    same workload through the chunked scheduler; each run is repeated and
    must give the same tokens (sub-int8 serving stays deterministic)."""
    if smoke:
        wl = dict(n_requests=8, prompt_len=64, short_new=8, long_new=16, spacing=2, slots=4,
                  chunk=32)
    else:
        wl = dict(n_requests=16, prompt_len=256, short_new=8, long_new=32, spacing=2,
                  slots=4, chunk=64)
    workload = make_workload(wl["n_requests"], wl["prompt_len"], wl["short_new"],
                             wl["long_new"], wl["spacing"], vocab, seed=seed)
    max_len = wl["prompt_len"] + wl["long_new"]
    out = {"workload": {**wl, "max_len": max_len, "weight_block": weight_block}}
    for name, spec in WEIGHT_FORMATS.items():
        eng = ServeEngine(model=model, params=params, max_len=max_len,
                          batch_slots=wl["slots"], weight_quant=spec,
                          weight_block=weight_block, device=device)
        res, st = eng.scheduler(chunk_size=wl["chunk"]).run(workload, seed=seed,
                                                            time_ticks=True)
        res2, _ = eng.scheduler(chunk_size=wl["chunk"]).run(workload, seed=seed)
        for r in workload:
            if res2[r.rid].tokens != res[r.rid].tokens:
                raise RuntimeError(f"weight format {name}: non-deterministic stream on "
                                   f"rid {r.rid}")
        pb = weight_payload_bytes(eng.params)
        out[name] = {"tok_s": round(st.steady_tok_s, 2), "repeat_identical": True, **pb}
        print(f"wfmt/{name:5s} {st.steady_tok_s:8.1f} tok/s | kernel payload "
              f"{pb['kernel_bytes']} B | scales {pb['scale_bytes']} B", flush=True)
    return out


def bench_chaos(model, params, vocab: int, *, smoke: bool = True, seed: int = 0,
                device=None) -> dict:
    """The hardening stack under an injected fault schedule
    (``benchmarks/serve_bench.py::bench_chaos``): for each engine of
    :data:`CHAOS_VARIANTS`, a fault-free audited run, then the same under the
    plan, checked by :func:`check_chaos_run`.  ``check_chaos`` gates the
    non-faulted completion rate at 1.0."""
    wl, reqs, plan = chaos_setup(vocab, smoke=smoke, seed=seed)
    max_len = wl["plen"] + wl["max_new"]
    out = {"workload": {**wl, "max_len": max_len}, "fault_plan": plan.to_json()}
    for name, kw in CHAOS_VARIANTS.items():
        eng = ServeEngine(model=model, params=params, max_len=max_len, batch_slots=wl["slots"],
                          paged_kv=True, page_size=wl["page"], kv_pool_pages=wl["pool_pages"],
                          device=device, **kw)
        ref_res, ref_st = chaos_scheduler(eng, wl).run(reqs, seed=seed)
        f_res, f_st = chaos_scheduler(eng, wl).run(reqs, seed=seed, fault_plan=plan)
        rec = out[name] = check_chaos_run(name, reqs, ref_res, ref_st, f_res, f_st)
        print(f"chaos/{name:6s} identity ok | {rec['fault_events']} fault events "
              f"({rec['swap_refusals']} swap refusals) | NaN victim rid {rec['nan_victim_rid']} "
              f"failed after {rec['victim_clean_tokens']} clean tokens | preempt "
              f"{rec['preemptions']} resume {rec['resumes']} | audited "
              f"{rec['audited_ticks_faulted']} ticks clean | non-faulted completion "
              f"{rec['nonfaulted_completion_rate']:.2f}", flush=True)
    return out


def check_chaos(results) -> bool:
    """The chaos gate: every request the plan did not poison completes
    ``ok`` (non-faulted completion rate exactly 1.0)."""
    ok = True
    for name, v in results.get("chaos", {}).items():
        if name in ("workload", "fault_plan"):
            continue
        rate = v["nonfaulted_completion_rate"]
        if rate < 1.0:
            print(f"REGRESSION chaos/{name}: non-faulted completion rate {rate:.2f} < 1.00 "
                  f"(statuses {v['statuses']})")
            ok = False
        else:
            print(f"ok chaos/{name}: non-faulted completion 1.00 ({v['fault_events']} fault "
                  f"events contained; NaN victim rid {v['nan_victim_rid']} failed cleanly; "
                  f"{v['audited_ticks_faulted']} audited ticks)")
    return ok
