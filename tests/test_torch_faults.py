"""Port parity for hardened serving: the drills of ``tests/test_faults.py``
(deadlines, cancellation, bounded queues, the fault plan's seams, the NaN
sentinel under ``audit=True``, deadlock-to-``failed``, the full chaos
scenario) through the port's ``Scheduler`` and repro's on the same seeded
workloads.  Each run is held to the reference's: every request's status,
greedy tokens and tick timeline, the hardened counters, and the printed
"serve:" messages.  Besides them, the chaos scenario on the ragged tick, a
sampled (temperature 0.7) NaN drill the port alone can run, the CLI's
hardening flags and ``bench_chaos``.

The SSM NaN drill (``test_faults.py:308``) runs on mamba-130m-smoke.  Not
mirrored: the TPU page-size guard (``test_faults.py:441``, a sublane rule
of compiled Pallas)."""
import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.serve.scheduler as j_sched
from repro.launch import serve as j_launch
from repro.models.registry import get_config as j_get_config
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bench.serve_bench import bench_chaos, check_chaos
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.serve import STATUSES, FaultPlan, Request, ServeEngine
from repro_torch.serve import scheduler as t_sched

torch.set_num_threads(2)

COUNTERS = ("completed", "timeouts", "cancellations", "rejections", "failed", "nan_evictions",
            "deadlock_failures", "fault_events", "swap_refusals", "preemptions", "resumes",
            "audited_ticks", "decode_steps", "tokens_out", "page_stalls")


def to_numpy(tree):
    from repro.core.qformat import QTensor as JQ

    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def smoke():
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_config("smollm-135m-smoke").build()
    return jm, jp, tm, params_from_numpy(to_numpy(jp), "cpu")


@pytest.fixture(scope="module")
def vocab():
    return get_config("smollm-135m-smoke").vocab


@pytest.fixture(scope="module")
def engines(smoke):
    """Memoized (JAX engine, port engine) pairs; the reference drills'
    geometry (max_len 48, 4 slots) by default."""
    jm, jp, tm, tp = smoke
    made = {}

    def get(max_len=48, batch_slots=4, **kw):
        key = (max_len, batch_slots, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = (JServeEngine(model=jm, params=jp, max_len=max_len,
                                      batch_slots=batch_slots, **kw),
                         ServeEngine(model=tm, params=tp, max_len=max_len,
                                     batch_slots=batch_slots, device="cpu", **kw))
        return made[key]

    return get


def _workload(vocab, *, n_requests=4, plen=16, max_new=8, spacing=1, seed=5, deadline=None):
    """``tests/test_faults.py``'s workload, as port requests."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=plen, dtype=np.int32),
                    max_new=max_new, arrival=i * spacing, deadline_steps=deadline)
            for i in range(n_requests)]


def _j_requests(reqs):
    return [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival,
                     deadline_steps=r.deadline_steps) for r in reqs]


def _captured(fn):
    """fn()'s result and the "serve:" lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [ln for ln in buf.getvalue().splitlines() if ln.startswith("serve:")]


@pytest.fixture(scope="module")
def runs(engines):
    """runs(eng_kw, sched_kw, reqs, plan=None, on_tick=None, **run_kw) ->
    ((port results, stats, lines), (reference results, stats, lines)).
    ``plan`` is a ``to_json`` dict given to each package's FaultPlan;
    ``on_tick(sched)`` builds a per-scheduler hook.  Runs without a hook are
    memoized."""
    done = {}

    def run(eng_kw, sched_kw, reqs, plan=None, on_tick=None, **run_kw):
        key = (tuple(sorted(eng_kw.items())), tuple(sorted(sched_kw.items())),
               tuple((r.rid, tuple(int(x) for x in r.prompt), r.max_new, r.arrival,
                      r.deadline_steps) for r in reqs),
               json.dumps(plan, sort_keys=True), json.dumps(run_kw, sort_keys=True))
        if on_tick is None and key in done:
            return done[key]
        je, te = engines(**eng_kw)
        out = []
        for eng, rq, plan_cls in ((te, reqs, FaultPlan), (je, _j_requests(reqs), JFaultPlan)):
            sched = eng.scheduler(**sched_kw)
            kw = dict(run_kw)
            if plan is not None:
                kw["fault_plan"] = plan_cls.from_json(plan)
            if on_tick is not None:
                kw["on_tick"] = on_tick(sched)
            (res, st), lines = _captured(lambda: sched.run(rq, warmup=False, **kw))
            out.append((res, st, lines))
        if on_tick is None:
            done[key] = tuple(out)
        return tuple(out)

    return run


def assert_same(pair):
    """Statuses, tokens, tick timelines, counters and messages all equal."""
    (g, gs, gl), (w, ws, wl) = pair
    assert sorted(g) == sorted(w)
    for rid in w:
        assert (g[rid].status, g[rid].tokens, g[rid].admitted_at, g[rid].finished_at,
                g[rid].eos) == (w[rid].status, w[rid].tokens, w[rid].admitted_at,
                                w[rid].finished_at, w[rid].eos), rid
    for key in COUNTERS:
        assert getattr(gs, key) == getattr(ws, key), key
    gsum, wsum = gs.summary(), ws.summary()
    for key in ("completion_rate", "p50_latency_steps", "p99_latency_steps",
                "p50_ttft_steps", "p99_ttft_steps", "grown_pages", "swapped_pages"):
        assert gsum[key] == wsum[key], key
    assert gl == wl


# --------------------------------------------------------------------------
# FaultPlan
# --------------------------------------------------------------------------

def test_faultplan_normalizes_and_validates():
    p = FaultPlan(alloc_fail=[3, 3, "5"], swap_fail=(2,), nan={np.int64(7): 1})
    assert p.alloc_fail == frozenset({3, 5})
    assert p.deny_alloc(5) and not p.deny_alloc(4)
    assert p.deny_swap(2) and not p.deny_admission(2)
    assert p.nan == {7: 1} and p.nan_events() == [(7, 1)]
    assert not p.empty and p.max_tick == 7
    assert FaultPlan().empty and FaultPlan().max_tick == -1
    assert p.to_json() == JFaultPlan(alloc_fail=[3, 3, "5"], swap_fail=(2,),
                                     nan={np.int64(7): 1}).to_json()
    with pytest.raises(ValueError):
        FaultPlan(alloc_fail={-1})
    with pytest.raises(ValueError):
        FaultPlan(nan={3: -2})


def test_faultplan_json_and_spec_roundtrip(tmp_path):
    p = FaultPlan(alloc_fail={4}, swap_fail={6}, admit_stall={1}, nan={9: 0, 3: 2})
    assert FaultPlan.from_json(p.to_json()) == p
    inline = json.dumps(p.to_json())
    assert inline == json.dumps(JFaultPlan.from_spec(inline).to_json())
    assert FaultPlan.from_spec(inline) == p
    f = tmp_path / "plan.json"
    f.write_text(inline)
    assert FaultPlan.from_spec(str(f)) == p
    with pytest.raises(ValueError, match="unknown FaultPlan keys"):
        FaultPlan.from_json({"alloc_fail": [1], "typo": []})


def test_faultplan_random_is_seed_deterministic():
    a = FaultPlan.random(11, ticks=64, slots=4, nan_events=2)
    b = FaultPlan.random(11, ticks=64, slots=4, nan_events=2)
    c = FaultPlan.random(12, ticks=64, slots=4, nan_events=2)
    assert a == b and a != c
    assert a.max_tick < 64
    for seed in (11, 12, 0):      # the reference's plan for the same seed
        kw = dict(ticks=96, slots=6, alloc_rate=0.1, nan_events=3)
        assert FaultPlan.random(seed, **kw).to_json() == JFaultPlan.random(seed, **kw).to_json()
    with pytest.raises(ValueError):
        FaultPlan.random(0, ticks=0, slots=4)


# --------------------------------------------------------------------------
# Deadlines
# --------------------------------------------------------------------------

def test_deadline_times_out_live_request(runs, vocab):
    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    (base, _, _), _ = runs({}, {"chunk_size": 8}, reqs)
    tight = [r if r.rid != 1 else dataclasses.replace(r, deadline_steps=8) for r in reqs]
    pair = runs({}, {"chunk_size": 8}, tight)
    assert_same(pair)
    got, st, _ = pair[0]
    assert got[1].status == "timeout"
    assert 0 < len(got[1].tokens) < len(base[1].tokens)
    assert got[1].tokens == base[1].tokens[:len(got[1].tokens)]
    for rid in (0, 2):
        assert got[rid].status == "ok" and got[rid].tokens == base[rid].tokens
    assert st.timeouts == 1 and st.completed == 2
    assert st.summary()["timeouts"] == 1
    assert 0 < st.completion_rate < 1


def test_deadline_times_out_queued_request(runs, vocab):
    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    reqs[2] = dataclasses.replace(reqs[2], deadline_steps=4)
    pair = runs({"batch_slots": 2}, {"chunk_size": 8}, reqs)     # rid 2 must wait
    assert_same(pair)
    got, st, _ = pair[0]
    assert got[2].status == "timeout"
    assert got[2].tokens == [] and got[2].admitted_at == -1
    assert got[0].status == "ok" and got[1].status == "ok"
    assert st.timeouts == 1


def test_deadline_validation(engines, vocab):
    je, te = engines()
    bad = _workload(vocab, n_requests=1, deadline=0)
    with pytest.raises(ValueError, match="deadline_steps"):
        te.scheduler(chunk_size=8).run(bad)
    with pytest.raises(ValueError, match="deadline_steps"):
        je.scheduler(chunk_size=8).run(_j_requests(bad))


# --------------------------------------------------------------------------
# Cancellation
# --------------------------------------------------------------------------

def test_cancellation_via_schedule_and_mid_run_hook(runs, vocab):
    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    (base, _, _), _ = runs({}, {"chunk_size": 8}, reqs)
    pair = runs({}, {"chunk_size": 8}, reqs, cancels={0: 6})
    assert_same(pair)
    got, st, _ = pair[0]
    assert got[0].status == "cancelled"
    assert got[0].tokens == base[0].tokens[:len(got[0].tokens)]
    assert len(got[0].tokens) < len(base[0].tokens)
    assert got[1].tokens == base[1].tokens
    assert st.cancellations == 1 and st.summary()["cancellations"] == 1

    pair = runs({}, {"chunk_size": 8}, reqs,
                on_tick=lambda sched: (lambda t: sched.cancel(2) if t == 6 else None))
    assert_same(pair)
    got2, st2, _ = pair[0]
    assert got2[2].status == "cancelled"
    assert got2[2].tokens == base[2].tokens[:len(got2[2].tokens)]
    assert got2[0].tokens == base[0].tokens
    assert st2.cancellations == 1


# --------------------------------------------------------------------------
# Bounded-queue backpressure
# --------------------------------------------------------------------------

def test_backpressure_reject(runs, vocab):
    reqs = _workload(vocab, n_requests=6, max_new=6, spacing=0)
    (base, _, _), _ = runs({"batch_slots": 2}, {"chunk_size": 8}, reqs)
    pair = runs({"batch_slots": 2}, {"chunk_size": 8, "max_queue": 2}, reqs)
    assert_same(pair)
    got, st, lines = pair[0]
    rejected = sorted(r for r in got if got[r].status == "rejected")
    kept = sorted(r for r in got if got[r].status == "ok")
    assert st.rejections == len(rejected) > 0
    assert any("queue full" in ln for ln in lines)
    for r in rejected:
        assert got[r].tokens == [] and got[r].admitted_at == -1
    for r in kept:
        assert got[r].tokens == base[r].tokens
    assert set(got) == {r.rid for r in reqs}
    assert st.completion_rate == pytest.approx(len(kept) / len(reqs))


def test_backpressure_shed_oldest(runs, engines, vocab):
    reqs = _workload(vocab, n_requests=6, max_new=6, spacing=0)
    rej = runs({"batch_slots": 2}, {"chunk_size": 8, "max_queue": 1,
                                    "reject_policy": "reject"}, reqs)
    shed = runs({"batch_slots": 2}, {"chunk_size": 8, "max_queue": 1,
                                     "reject_policy": "shed_oldest"}, reqs)
    assert_same(rej)
    assert_same(shed)
    (r_rej, _, _), (r_shed, st, _) = rej[0], shed[0]
    assert st.rejections > 0
    rej_reject = {r for r in r_rej if r_rej[r].status == "rejected"}
    rej_shed = {r for r in r_shed if r_shed[r].status == "rejected"}
    assert max(r.rid for r in reqs) not in rej_shed
    assert max(r.rid for r in reqs) in rej_reject
    assert len(rej_shed) == len(rej_reject)
    _, te = engines(batch_slots=2)
    with pytest.raises(ValueError, match="reject_policy"):
        te.scheduler(chunk_size=8, max_queue=1, reject_policy="drop")
    with pytest.raises(ValueError, match="max_queue"):
        te.scheduler(chunk_size=8, max_queue=0)


# --------------------------------------------------------------------------
# The fault plan's three denial seams
# --------------------------------------------------------------------------

def test_admission_stall_fault_shifts_schedule_not_streams(runs, vocab):
    reqs = _workload(vocab, n_requests=3, max_new=8, spacing=0)
    eng_kw = {"paged_kv": True, "page_size": 8}
    (base, _, _), _ = runs(eng_kw, {"chunk_size": 8}, reqs)
    pair = runs(eng_kw, {"chunk_size": 8}, reqs,
                plan=FaultPlan(admit_stall={0, 1, 2}).to_json())
    assert_same(pair)
    got, st, _ = pair[0]
    assert st.fault_events > 0
    for r in reqs:
        assert got[r.rid].status == "ok" and got[r.rid].tokens == base[r.rid].tokens
    assert got[0].admitted_at > base[0].admitted_at


def test_alloc_denial_fault_defers_and_preempts(runs, vocab):
    reqs = _workload(vocab, n_requests=4, max_new=16, spacing=0)
    eng_kw = {"paged_kv": True, "page_size": 8, "kv_pool_pages": 16}
    sched_kw = {"chunk_size": 8, "prefix_sharing": False, "oversubscribe": True}
    (base, _, _), _ = runs(eng_kw, sched_kw, reqs)
    pair = runs(eng_kw, sched_kw, reqs, plan=FaultPlan(alloc_fail={0, 1, 5}).to_json())
    assert_same(pair)
    got, st, _ = pair[0]
    assert st.fault_events > 0
    for r in reqs:
        assert got[r.rid].status == "ok"
        assert got[r.rid].tokens == base[r.rid].tokens, r.rid


@pytest.mark.parametrize("via", ["fault", "capacity"])
def test_swap_refusal_falls_back_to_recompute(runs, vocab, via):
    reqs = _workload(vocab, n_requests=4, plen=16, max_new=12, spacing=0)
    (base, _, _), _ = runs({"batch_slots": 3}, {"chunk_size": 8, "prefix_sharing": False},
                           reqs)
    kw = dict(chunk_size=8, prefix_sharing=False, oversubscribe=True, preempt_policy="swap")
    plan = None
    if via == "fault":
        plan = FaultPlan(swap_fail=frozenset(range(200))).to_json()
    else:
        kw["swap_bytes"] = 1          # no park ever fits
    pair = runs({"batch_slots": 3, "paged_kv": True, "page_size": 8, "kv_pool_pages": 9},
                kw, reqs, plan=plan)
    assert_same(pair)
    got, st, _ = pair[0]
    assert st.preemptions > 0 and st.swap_refusals > 0
    assert st.swapped_pages == 0
    for r in reqs:
        assert got[r.rid].status == "ok"
        assert got[r.rid].tokens == base[r.rid].tokens, (via, r.rid)


# --------------------------------------------------------------------------
# The NaN/Inf sentinel (audit=True)
# --------------------------------------------------------------------------

def test_nan_sentinel_evicts_exactly_the_poisoned_slot(runs, vocab):
    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    eng_kw = {"paged_kv": True, "page_size": 8}
    base_pair = runs(eng_kw, {"chunk_size": 8, "audit": True}, reqs)
    assert_same(base_pair)
    base, base_st, _ = base_pair[0]
    assert base_st.audited_ticks > 0
    pair = runs(eng_kw, {"chunk_size": 8, "audit": True}, reqs,
                plan=FaultPlan(nan={6: 1}).to_json())
    assert_same(pair)
    got, st, _ = pair[0]
    failed = [r for r in got if got[r].status == "failed"]
    assert len(failed) == 1 and st.nan_evictions == 1
    v = failed[0]
    assert got[v].tokens == base[v].tokens[:len(got[v].tokens)]
    assert len(got[v].tokens) < len(base[v].tokens)
    for r in reqs:
        if r.rid != v:
            assert got[r.rid].tokens == base[r.rid].tokens
    assert st.audited_ticks > 0 and st.failed == 1
    # two device-to-host copies per stepped tick: the health flags mid-tick,
    # the page table and lens at its end
    assert st.audit_reads == 2 * st.decode_steps


def test_nan_sentinel_on_ssm_state():
    """NaN injection against a recurrent (mamba) slot: the sentinel evicts
    exactly the poisoned slot, its zeroed rows pass every tick's recurrent
    audit, the survivors stream what they stream without the fault, and
    statuses, tokens, timelines and counters equal the reference's."""
    jm = j_get_config("mamba-130m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_config("mamba-130m-smoke").build()
    tp = params_from_numpy(to_numpy(jp), "cpu")
    vocab = get_config("mamba-130m-smoke").vocab
    reqs = _workload(vocab, n_requests=3, plen=8, max_new=10, spacing=0)
    out = {}
    for name, eng, rq, plan_cls in (
            ("port", ServeEngine(model=tm, params=tp, max_len=24, batch_slots=3, device="cpu"),
             reqs, FaultPlan),
            ("ref", JServeEngine(model=jm, params=jp, max_len=24, batch_slots=3),
             _j_requests(reqs), JFaultPlan)):
        sched = lambda: eng.scheduler(chunk_size=4, audit=True)  # noqa: E731
        base = _captured(lambda: sched().run(rq, warmup=False))
        got = _captured(lambda: sched().run(rq, warmup=False,
                                            fault_plan=plan_cls(nan={5: 1})))
        out[name] = (base, got)
    for i in (0, 1):
        (g, gs, ), gl = out["port"][i]
        (w, ws, ), wl = out["ref"][i]
        assert_same(((g, gs, gl), (w, ws, wl)))
    (base, base_st), _ = out["port"][0]
    (got, st), _ = out["port"][1]
    assert base_st.state_kinds == st.state_kinds == "recurrent"
    assert base_st.audited_ticks > 0 and st.audit_reads == st.decode_steps
    failed = [r for r in got if got[r].status == "failed"]
    assert len(failed) == 1 and st.nan_evictions == 1
    v = failed[0]
    assert got[v].tokens == base[v].tokens[:len(got[v].tokens)]
    assert len(got[v].tokens) < len(base[v].tokens)
    for r in reqs:
        if r.rid != v:
            assert got[r.rid].tokens == base[r.rid].tokens
    assert st.audited_ticks > 0 and st.failed == 1


def test_nan_plan_requires_audit(engines, vocab):
    je, te = engines()
    reqs = _workload(vocab, n_requests=1)
    for eng, rq, plan_cls in ((te, reqs, FaultPlan), (je, _j_requests(reqs), JFaultPlan)):
        with pytest.raises(ValueError, match="audit"):
            eng.scheduler(chunk_size=8).run(rq, fault_plan=plan_cls(nan={4: 0}))
        with pytest.raises(ValueError, match="slot"):
            eng.scheduler(chunk_size=8, audit=True).run(rq, fault_plan=plan_cls(nan={4: 99}))


@pytest.mark.parametrize("ragged", [False, True], ids=["mixed", "ragged"])
def test_nan_sentinel_at_temperature_raises_no_sampler_error(smoke, vocab, ragged):
    """A poisoned row at temperature 0.7 (the port samples with
    ``torch.multinomial``, which raises on NaN probabilities) ends its slot
    ``failed``; the run completes and every other request is served."""
    _, _, tm, tp = smoke
    eng = ServeEngine(model=tm, params=tp, max_len=48, batch_slots=4, device="cpu",
                      temperature=0.7, paged_kv=True, page_size=8)
    kw = {"ragged": True, "prefill_lanes": 2} if ragged else {}
    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    got, st = eng.scheduler(chunk_size=8, audit=True, **kw).run(
        reqs, fault_plan=FaultPlan(nan={6: 1}), seed=3)
    failed = [r for r in got if got[r].status == "failed"]
    assert len(failed) == 1 and st.nan_evictions == 1 and st.failed == 1
    for r in reqs:
        if r.rid != failed[0]:
            assert got[r.rid].status == "ok" and len(got[r.rid].tokens) == r.max_new
        assert all(0 <= x < vocab for x in got[r.rid].tokens)
    assert len(got[failed[0]].tokens) < reqs[failed[0]].max_new


# --------------------------------------------------------------------------
# The page-table breach drill (audit=True)
# --------------------------------------------------------------------------

def _corrupt_tables(cache, slot, page, in_place):
    """Entry 0 of ``slot``'s row set to ``page`` in every page table of
    ``cache`` (the port's one table in place, the reference's stacked tables
    as new arrays)."""
    if isinstance(cache, dict):
        if "page_table" in cache:
            pt = cache["page_table"]
            if in_place:
                pt[..., slot, 0] = page
                return cache
            return dict(cache, page_table=pt.at[..., slot, 0].set(page))
        return {k: _corrupt_tables(v, slot, page, in_place) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_corrupt_tables(v, slot, page, in_place) for v in cache)
    return cache


def _first_table(cache):
    if isinstance(cache, dict):
        if "page_table" in cache:
            return np.asarray(cache["page_table"]).reshape(-1, cache["page_table"].shape[-1])
        cache = list(cache.values())
    for v in cache if isinstance(cache, (list, tuple)) else ():
        found = _first_table(v)
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("ragged,breach_tick", [(False, 3), (False, 6), (True, 3)],
                         ids=["mixed-tick", "decode-tick", "ragged-tick"])
def test_page_table_breach_raises_in_its_own_tick(engines, vocab, ragged, breach_tick):
    """A live slot's device page table is corrupted by the step of one tick
    (entry 0 of slot 0 moved one page on); under ``audit=True`` both
    schedulers raise ``AuditError`` with the same message at the end of that
    tick."""
    from repro.serve.audit import AuditError as JAuditError
    from repro_torch.serve.audit import AuditError

    reqs = _workload(vocab, n_requests=3, max_new=16, spacing=0)
    je, te = engines(paged_kv=True, page_size=8)
    kw = {"ragged": True, "prefill_lanes": 2} if ragged else {}
    raised = []
    for eng, rq, err, in_place in ((te, reqs, AuditError, True),
                                   (je, _j_requests(reqs), JAuditError, False)):
        sched = eng.scheduler(chunk_size=8, audit=True, **kw)
        box = {"t": None, "done": False}

        def corrupting(step, box=box, in_place=in_place):
            def wrapped(*a, **k):
                out = step(*a, **k)
                if box["done"] or box["t"] is None or box["t"] < breach_tick:
                    return out
                box["done"] = True
                page = int(_first_table(out[-1])[0, 0])
                assert page >= 0, "slot 0 is not live at the breach tick"
                cache = _corrupt_tables(out[-1], 0, (page + 1) % eng.kv_num_pages, in_place)
                return (*out[:-1], cache)
            return wrapped

        for name in ("_masked_decode", "_masked_mixed", "_masked_ragged"):
            if hasattr(sched, name):
                setattr(sched, name, corrupting(getattr(sched, name)))

        def on_tick(t, box=box):
            box["t"] = t

        with pytest.raises(err) as info:
            sched.run(rq, warmup=False, on_tick=on_tick)
        assert box["done"]
        raised.append((box["t"], str(info.value)))
    assert raised[0] == raised[1] and raised[0][0] == breach_tick
    assert raised[0][1].startswith("slot 0: device table row")


# --------------------------------------------------------------------------
# Deadlock -> failed
# --------------------------------------------------------------------------

def _dying(base):
    class Dying(base):
        """A pool that runs dry for good after a fixed allocation budget."""

        budget = 10

        def alloc(self, n):
            cls = type(self)
            if cls.budget < n:
                return None
            out = super().alloc(n)
            if out is not None:
                cls.budget -= n
            return out
    return Dying


def test_deadlock_converts_victims_instead_of_raising(runs, vocab, monkeypatch):
    reqs = _workload(vocab, n_requests=4, plen=16, max_new=24, spacing=1)
    monkeypatch.setattr(j_sched, "PageAllocator", _dying(j_sched.PageAllocator))
    monkeypatch.setattr(t_sched, "PageAllocator", _dying(t_sched.PageAllocator))
    pair = runs({"paged_kv": True, "page_size": 8, "kv_pool_pages": 12},
                {"chunk_size": 8, "oversubscribe": True, "preempt_policy": "swap",
                 "audit": True}, reqs, on_tick=lambda sched: None)
    assert_same(pair)
    got, st, lines = pair[0]
    assert sorted(got) == [r.rid for r in reqs]
    assert all(got[r].status in STATUSES for r in got)
    assert st.deadlock_failures > 0
    assert st.failed == st.deadlock_failures == \
        sum(1 for r in got.values() if r.status == "failed")
    assert st.audited_ticks > 0
    assert any("unservable deadlock" in ln for ln in lines)
    assert any("can never be admitted" in ln for ln in lines)


# --------------------------------------------------------------------------
# The full chaos scenario
# --------------------------------------------------------------------------

CHAOS_PLAN = {"alloc_fail": [4, 5], "swap_fail": [4, 5, 6], "admit_stall": [2],
              "nan": [[9, 0]]}


@pytest.mark.parametrize("ragged", [False, True], ids=["mixed", "ragged"])
def test_full_chaos_scenario_contains_all_faults(runs, vocab, ragged):
    """Deadlines, a bounded queue, the auditor and a combined fault plan: the
    run completes, every request ends, the NaN victim alone fails and the
    other streams are the fault-free run's — on the mixed step (the
    reference's drill) and on the ragged tick with two lanes."""
    reqs = _workload(vocab, n_requests=5, plen=16, max_new=16, spacing=1, deadline=300)
    eng_kw = {"batch_slots": 4, "paged_kv": True, "page_size": 8, "kv_pool_pages": 12}
    sched_kw = dict(chunk_size=8, prefix_sharing=False, oversubscribe=True,
                    preempt_policy="swap", audit=True, max_queue=5)
    if ragged:
        sched_kw.update(ragged=True, prefill_lanes=2)
    base_pair = runs(eng_kw, sched_kw, reqs)
    assert_same(base_pair)
    base = base_pair[0][0]
    assert all(r.status == "ok" for r in base.values())
    pair = runs(eng_kw, sched_kw, reqs, plan=CHAOS_PLAN)
    assert_same(pair)
    got, st, _ = pair[0]
    assert sorted(got) == [r.rid for r in reqs]
    failed = [r for r in got if got[r].status == "failed"]
    assert len(failed) == 1 and st.nan_evictions == 1
    assert st.timeouts == 0 and st.rejections == 0
    for r in reqs:
        if r.rid in failed:
            assert got[r.rid].tokens == base[r.rid].tokens[:len(got[r.rid].tokens)]
        else:
            assert got[r.rid].status == "ok"
            assert got[r.rid].tokens == base[r.rid].tokens, r.rid
    assert st.fault_events > 0 and st.audited_ticks > 0
    s = st.summary()
    for key in ("rejections", "timeouts", "cancellations", "failed", "completion_rate",
                "steady_tok_s", "p99_latency_steps"):
        assert key in s
    assert s["completion_rate"] == pytest.approx((len(reqs) - 1) / len(reqs))


# --------------------------------------------------------------------------
# The CLI's hardening flags and the chaos lane
# --------------------------------------------------------------------------

def test_cli_hardening_flags_match_reference(capsys):
    """``launch.serve`` with the five flags: the same report line's counts
    as ``repro.launch.serve`` on the CPU (the schedule does not depend on
    the weights without an EOS id)."""
    plan = json.dumps({"alloc_fail": [6], "swap_fail": [6, 7], "admit_stall": [3],
                       "nan": [[10, 1]]})
    flags = ["--arch", "smollm-135m-smoke", "--policy", "chunked", "--paged",
             "--page-size", "8", "--chunk-size", "8", "--slots", "3", "--prompt-len", "16",
             "--requests", "8", "--max-new", "16", "--arrival-spacing", "1",
             "--oversubscribe", "--preempt-policy", "swap", "--pool-pages", "10",
             "--deadline-steps", "40", "--max-queue", "2", "--reject-policy", "shed_oldest",
             "--audit", "--fault-plan", plan, "--qkv"]
    t_res = t_launch.main(flags + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    j_res = j_launch.main(flags)
    j_out = capsys.readouterr().out

    def parts(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("[chunked]"))
        keep = ("completion", "audited", "faults", "latency p50/p99", "grown", "pages peak")
        return [p.strip() for p in line.split("|") if p.strip().startswith(keep)
                and "ms" not in p]

    assert parts(t_out) == parts(j_out)
    assert any(p.startswith("completion") for p in parts(t_out))
    assert any(p.startswith("audited") for p in parts(t_out))
    assert any(p.startswith("faults") for p in parts(t_out))
    # the two CLIs draw their own random weights: statuses and lengths agree
    assert {r: (t_res[r].status, len(t_res[r].tokens)) for r in t_res} == \
        {r: (j_res[r].status, len(j_res[r].tokens)) for r in j_res}
    with pytest.raises(SystemExit, match="audit"):
        t_launch.main(["--arch", "smollm-135m-smoke", "--policy", "chunked", "--device",
                       "cpu", "--fault-plan", '{"nan": [[1, 0]]}'])
    with pytest.raises(SystemExit, match="scheduler policy"):
        t_launch.main(["--arch", "smollm-135m-smoke", "--policy", "restart", "--device",
                       "cpu", "--fault-plan", '{"alloc_fail": [1]}'])


def test_bench_chaos_smoke_matches_reference_statuses(smoke):
    """``bench_chaos(smoke=True)`` on the port: the non-faulted completion
    rate is 1.0 and the statuses are those of the reference's lane."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "serve_bench.py"
    spec = importlib.util.spec_from_file_location("reference_serve_bench", path)
    j_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_bench)
    jm, jp, tm, tp = smoke
    vocab = get_config("smollm-135m-smoke").vocab
    got = bench_chaos(tm, tp, vocab, smoke=True, device="cpu")
    assert check_chaos({"chaos": got})
    want = _captured(lambda: j_bench.bench_chaos(jm, jp, vocab, smoke=True))[0]
    assert got["fault_plan"] == want["fault_plan"]
    for name in ("wq_qkv", "wq"):
        v = got[name]
        assert v["nonfaulted_completion_rate"] == 1.0
        for ref_name in ("fp32", "qkv"):
            w = want[ref_name]
            for key in ("statuses", "nan_victim_rid", "fault_events", "nan_evictions",
                        "swap_refusals", "preemptions", "resumes", "audited_ticks_faulted"):
                assert v[key] == w[key], (name, ref_name, key)
