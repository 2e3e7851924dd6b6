"""Port parity for paged serving: the port's ``Scheduler`` over a paged
engine against repro's on the same requests, the cases of
``tests/test_paged.py``, ``tests/test_prefix_sharing.py`` and
``tests/test_oversub.py``.  Tokens, tick timelines and every stat both
report (pages, sharing, growth, preemption, swap bytes) are held equal;
each case also keeps the assertions of the reference test it mirrors.

Not mirrored, being about JAX alone: buffer donation of the jitted steps
(``test_paged.py:413-453``) and the TPU's 128-row page rule
(``test_paged.py:454-488``); the port's own page-size default is tested
instead.  The reference's interpret-mode end-to-end runs have no CPU
counterpart here: the port's kernels run on the card only, where
``chip_smoke.py`` holds paged serving to the plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.registry import get_config as j_get_config
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import engine as t_engine
from repro_torch.serve import paging as t_paging
from repro_torch.serve import scheduler as t_sched

torch.set_num_threads(2)
VOCAB = 503

STAT_KEYS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
             "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
             "admission_stalls", "page_stalls", "peak_pages_in_use", "peak_live_slots",
             "page_occupancy", "prefix_hits", "shared_pages_mapped", "cow_copies",
             "grown_pages", "preemptions", "resumes", "swapped_pages", "swap_peak_bytes",
             "resume_stalls", "swap_refusals", "truncations", "p50_ttft_steps",
             "p99_ttft_steps", "failed", "deadlock_failures")


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
def engines(smoke):
    """Memoized (JAX engine, port engine) pairs of one geometry."""
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


def _key(eng_kw, sched_kw, reqs):
    return (tuple(sorted(eng_kw.items())), tuple(sorted(sched_kw.items())),
            tuple((r.rid, tuple(int(x) for x in r.prompt), r.max_new, r.arrival)
                  for r in reqs))


@pytest.fixture(scope="module")
def runs(engines):
    """run(eng_kw, sched_kw, reqs) -> (port run, reference run), memoized."""
    done = {}

    def run(eng_kw, sched_kw, reqs):
        key = _key(eng_kw, sched_kw, reqs)
        if key not in done:
            je, te = engines(**eng_kw)
            want = je.scheduler(**sched_kw).run(
                [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival)
                 for r in reqs], warmup=False)
            got = te.scheduler(**sched_kw).run(reqs, warmup=False)
            done[key] = (got, want)
        return done[key]

    return run


def assert_same_run(got, want):
    """Tokens, tick timelines and every stat both packages keep, all equal."""
    (g, gs), (w, ws) = got, want
    assert sorted(g) == sorted(w)
    for rid in w:
        assert g[rid].tokens == w[rid].tokens, rid
        assert (g[rid].admitted_at, g[rid].finished_at, g[rid].eos, g[rid].status,
                g[rid].prompt_len) == (w[rid].admitted_at, w[rid].finished_at, w[rid].eos,
                                       w[rid].status, w[rid].prompt_len), rid
    gsum, wsum = gs.summary(), ws.summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key
    assert gs.latencies_steps == ws.latencies_steps and gs.ttft_steps == ws.ttft_steps
    assert gs.preempted_rids == ws.preempted_rids and gs.completed == ws.completed
    assert gs.truncated_rids == ws.truncated_rids


def checked(runs, eng_kw, sched_kw, reqs):
    """The port's run, after holding it to the reference's."""
    got, want = runs(eng_kw, sched_kw, reqs)
    assert_same_run(got, want)
    return got


def _reqs(specs):
    return [Request(r, np.asarray(p, np.int32), m, a) for r, p, m, a in specs]


PAGED = {"paged_kv": True, "page_size": 8}


# --------------------------------------------------------------------------
# tests/test_paged.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_paged_scheduler_token_identical_to_dense(runs, quantized_kv):
    """test_paged.py:235-254: staggered arrivals, prompt lengths that divide
    neither the chunk size nor the page size."""
    rng = np.random.default_rng(3)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=5 + 3 * i), 6, i) for i in range(4)])
    kv = {"max_len": 48, "batch_slots": 2, "quantized_kv": quantized_kv}
    base, _ = checked(runs, kv, {"chunk_size": 7}, reqs)
    got, stats = checked(runs, dict(kv, **PAGED), {"chunk_size": 7}, reqs)
    for i in range(4):
        assert got[i].tokens == base[i].tokens, (quantized_kv, i)
    assert stats.page_stalls == 0 and stats.peak_pages_in_use > 0
    assert 0.0 < stats.page_occupancy <= 1.0


def test_page_exhaustion_defers_admission(runs):
    """test_paged.py:279-303: a pool of 3 pages holds one live request."""
    rng = np.random.default_rng(5)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=8), 8, 0) for i in range(5)])
    base, _ = checked(runs, {}, {"chunk_size": 4}, reqs)
    got, stats = checked(runs, dict(PAGED, kv_pool_pages=3), {"chunk_size": 4}, reqs)
    assert stats.page_stalls > 0 and stats.peak_pages_in_use <= 3
    for i in range(5):
        assert got[i].tokens == base[i].tokens


def test_paged_scheduler_churn_reuses_pages(runs):
    """test_paged.py:306-320: 24 requests through a 4-page pool."""
    rng = np.random.default_rng(7)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=6), 2, i) for i in range(24)])
    got, stats = checked(runs, {"batch_slots": 2, "paged_kv": True, "page_size": 4,
                                "kv_pool_pages": 4}, {"chunk_size": 6}, reqs)
    assert sorted(got) == list(range(24)) and stats.peak_pages_in_use <= 4
    assert all(len(got[i].tokens) == 2 for i in range(24))


def test_evict_unmap_enqueued_before_pages_freed(engines, monkeypatch):
    """test_paged.py:323-357: every free is preceded by an unmap."""
    _, te = engines(batch_slots=2, kv_pool_pages=4, **PAGED)
    events = []
    evict, free = t_sched.evict_cache_slot, t_paging.PageAllocator.free
    monkeypatch.setattr(t_sched, "evict_cache_slot",
                        lambda cache, slot: (events.append("evict"), evict(cache, slot))[1])
    monkeypatch.setattr(t_paging.PageAllocator, "free",
                        lambda self, pages: (events.append("free"), free(self, pages))[1])
    rng = np.random.default_rng(2)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=6), 3, i) for i in range(6)])
    got, _ = te.scheduler(chunk_size=4).run(reqs, warmup=False)
    assert sorted(got) == list(range(6)) and events.count("free") == 6
    for n, e in enumerate(events):
        if e == "free":
            assert events[:n].count("evict") >= events[:n + 1].count("free")


def test_same_tick_page_reuse_is_alias_free(runs):
    """test_paged.py:360-376: every admission reuses the last eviction's pages."""
    rng = np.random.default_rng(13)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=6), 4, 0) for i in range(6)])
    base, _ = checked(runs, {"batch_slots": 2}, {"chunk_size": 6}, reqs)
    got, stats = checked(runs, dict(PAGED, batch_slots=2, kv_pool_pages=2),
                         {"chunk_size": 6}, reqs)
    assert stats.peak_pages_in_use == 2 and stats.page_stalls > 0
    for i in range(6):
        assert got[i].tokens == base[i].tokens, i


def test_paged_token_budget_composes_with_page_stalls(runs):
    """test_paged.py:394-406."""
    rng = np.random.default_rng(9)
    reqs = _reqs([(i, rng.integers(0, VOCAB, size=8), 6, 0) for i in range(4)])
    got, stats = checked(runs, dict(PAGED, kv_pool_pages=4),
                         {"chunk_size": 4, "token_budget": 4}, reqs)
    assert all(len(got[i].tokens) == 6 for i in range(4)) and stats.stalled_chunks > 0


def test_paged_requires_chunked_admission_and_rejects_oversize_requests(engines):
    """test_paged.py:379-391, and the options only a paged engine takes."""
    _, te = engines(paged_kv=True)
    with pytest.raises(ValueError, match="chunked admission"):
        te.scheduler()
    _, small = engines(kv_pool_pages=2, **PAGED)
    with pytest.raises(ValueError, match="pool"):
        small.scheduler(chunk_size=4).run([Request(0, np.arange(20), 8)], warmup=False)
    _, dense = engines()
    with pytest.raises(ValueError, match="paged engine"):
        dense.scheduler(chunk_size=4, oversubscribe=True)
    for kw, match in (({"preempt_policy": "evict"}, "preempt_policy"),
                      ({"preempt_aging": 0}, "preempt_aging"),
                      ({"oversize": "clip"}, "oversize"), ({"swap_bytes": -1}, "swap_bytes")):
        with pytest.raises(ValueError, match=match):
            te.scheduler(chunk_size=4, **kw)


def test_page_size_default_and_bad_values(smoke):
    """The port's default off the card is the reference's off the TPU (16),
    for paged and dense engines; a page size below 1 is refused."""
    tm, tp = smoke[2], smoke[3]
    for paged in (True, False):
        eng = ServeEngine(model=tm, params=tp, max_len=48, batch_slots=2, device="cpu",
                          paged_kv=paged)
        assert eng.page_size == t_engine.CPU_PAGE_SIZE == 16
    eng = ServeEngine(model=tm, params=tp, max_len=48, batch_slots=2, device="cpu",
                      paged_kv=True, page_size=5)
    assert (eng.page_size, eng.kv_max_pages, eng.kv_num_pages) == (5, 10, 20)
    for bad in (0, -4):
        with pytest.raises(ValueError, match="page_size"):
            ServeEngine(model=tm, params=tp, max_len=48, batch_slots=2, device="cpu",
                        paged_kv=True, page_size=bad)


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_paged_cache_bytes_match_reference(engines, quantized_kv):
    """The pool as the reference stores it (one table and len per layer),
    what the scheduler's ``peak_cache_bytes`` reports."""
    je, te = engines(kv_pool_pages=9, quantized_kv=quantized_kv, **PAGED)
    leaves = jax.tree_util.tree_leaves(je.new_cache(per_slot=True))
    assert te.cache_bytes(per_slot=True) == sum(x.size * x.dtype.itemsize for x in leaves)
    assert te.cache_bytes() == je.cache_bytes()


# --------------------------------------------------------------------------
# tests/test_prefix_sharing.py
# --------------------------------------------------------------------------

def _shared_workload(*, n_prompts=1, n_requests=4, sys_len=24, suffix=8, max_new=8,
                     spacing=1, seed=3):
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, VOCAB, size=sys_len, dtype=np.int32)
                   for _ in range(n_prompts)]
    return [Request(i, np.concatenate([sys_prompts[i % n_prompts],
                                       rng.integers(0, VOCAB, size=suffix, dtype=np.int32)]),
                    max_new, i * spacing) for i in range(n_requests)]


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_shared_prefix_token_identity(runs, quantized_kv):
    """test_prefix_sharing.py:90-111: shared == unshared == dense."""
    reqs = _shared_workload()
    kv = {"quantized_kv": quantized_kv}
    base, _ = checked(runs, kv, {"chunk_size": 8}, reqs)
    shared, s_st = checked(runs, dict(kv, **PAGED), {"chunk_size": 8}, reqs)
    unshared, u_st = checked(runs, dict(kv, **PAGED),
                             {"chunk_size": 8, "prefix_sharing": False}, reqs)
    for i in range(len(reqs)):
        assert shared[i].tokens == base[i].tokens == unshared[i].tokens, (quantized_kv, i)
    assert s_st.prefix_hits > 0 and s_st.shared_pages_mapped > 0 and u_st.prefix_hits == 0
    assert s_st.peak_pages_in_use < u_st.peak_pages_in_use


def test_full_prompt_duplicate_triggers_cow(runs):
    """test_prefix_sharing.py:114-131."""
    p = np.random.default_rng(7).integers(0, VOCAB, size=16, dtype=np.int32)
    reqs = [Request(0, p, 6, 0), Request(1, p, 6, 1)]
    base, _ = checked(runs, {}, {"chunk_size": 8}, reqs)
    got, stats = checked(runs, PAGED, {"chunk_size": 8}, reqs)
    assert (stats.cow_copies, stats.prefix_hits, stats.shared_pages_mapped) == (1, 1, 1)
    assert got[0].tokens == base[0].tokens and got[1].tokens == base[1].tokens


def test_sharing_survives_donor_eviction(runs):
    """test_prefix_sharing.py:134-146."""
    reqs = _shared_workload(n_requests=6, max_new=4, spacing=3)
    base, _ = checked(runs, {"batch_slots": 6}, {"chunk_size": 8}, reqs)
    got, stats = checked(runs, dict(PAGED, batch_slots=6), {"chunk_size": 8}, reqs)
    for i in range(6):
        assert got[i].tokens == base[i].tokens, i
    assert stats.prefix_hits >= 2


def test_sharing_raises_concurrency_at_equal_pool(runs):
    """test_prefix_sharing.py:149-167."""
    reqs = _shared_workload(n_requests=6)
    kv = dict(PAGED, batch_slots=6, kv_pool_pages=11)
    shared, s_st = checked(runs, kv, {"chunk_size": 8}, reqs)
    unshared, u_st = checked(runs, kv, {"chunk_size": 8, "prefix_sharing": False}, reqs)
    for i in range(6):
        assert shared[i].tokens == unshared[i].tokens, i
    assert u_st.peak_live_slots == 2 and s_st.peak_live_slots >= 3
    assert s_st.page_stalls < u_st.page_stalls


def test_unshared_flag_disables_sharing(runs):
    """test_prefix_sharing.py:198-205."""
    _, stats = checked(runs, PAGED, {"chunk_size": 8, "prefix_sharing": False},
                       _shared_workload())
    assert (stats.prefix_hits, stats.shared_pages_mapped, stats.cow_copies) == (0, 0, 0)


# --------------------------------------------------------------------------
# tests/test_oversub.py
# --------------------------------------------------------------------------

def _workload(*, n_requests=4, plen=16, max_new=8, spacing=1, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, VOCAB, size=plen, dtype=np.int32), max_new,
                    i * spacing) for i in range(n_requests)]


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_lazy_growth_token_identity(runs, quantized_kv):
    """test_oversub.py:42-62."""
    reqs = _workload()
    kv = {"quantized_kv": quantized_kv}
    nosh = {"chunk_size": 8, "prefix_sharing": False}
    base, _ = checked(runs, kv, nosh, reqs)
    upfront, up_st = checked(runs, dict(kv, **PAGED), nosh, reqs)
    lazy, lz_st = checked(runs, dict(kv, **PAGED), dict(nosh, oversubscribe=True), reqs)
    for i in range(len(reqs)):
        assert lazy[i].tokens == base[i].tokens == upfront[i].tokens, (quantized_kv, i)
    assert lz_st.grown_pages > 0 and lz_st.preemptions == 0
    assert lz_st.page_occupancy > up_st.page_occupancy


def test_lazy_growth_never_maps_a_live_page(runs):
    """test_oversub.py:65-81."""
    reqs = _workload(n_requests=5, spacing=0)
    got, stats = checked(runs, dict(PAGED, kv_pool_pages=9, batch_slots=3),
                         {"chunk_size": 8, "prefix_sharing": False, "oversubscribe": True},
                         reqs)
    base, _ = checked(runs, {"batch_slots": 3}, {"chunk_size": 8, "prefix_sharing": False},
                      reqs)
    for i in range(5):
        assert got[i].tokens == base[i].tokens, i
    assert stats.grown_pages > 0


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("policy", ["recompute", "swap"])
def test_preempt_resume_token_identity(runs, policy, quantized_kv):
    """test_oversub.py:88-117: 3 slots x 4 pages > a pool of 7."""
    reqs = _workload(n_requests=4, plen=16, max_new=12, spacing=0)
    kv = {"batch_slots": 3, "quantized_kv": quantized_kv}
    base, _ = checked(runs, kv, {"chunk_size": 8, "prefix_sharing": False}, reqs)
    got, stats = checked(runs, dict(kv, kv_pool_pages=7, **PAGED),
                         {"chunk_size": 8, "prefix_sharing": False, "oversubscribe": True,
                          "preempt_policy": policy}, reqs)
    assert stats.preemptions > 0
    for i in range(4):
        assert got[i].tokens == base[i].tokens, (policy, quantized_kv, i)
    if policy == "swap":
        assert stats.swapped_pages > 0 and stats.resumes > 0 and stats.swap_peak_bytes > 0
    else:
        assert stats.resumes == 0


def test_swap_never_moves_shared_pages(runs):
    """test_oversub.py:120-146."""
    rng = np.random.default_rng(11)
    sysp = rng.integers(0, VOCAB, size=16, dtype=np.int32)
    reqs = [Request(i, np.concatenate([sysp, rng.integers(0, VOCAB, size=8, dtype=np.int32)]),
                    12, 0) for i in range(4)]
    base, _ = checked(runs, {"batch_slots": 3}, {"chunk_size": 8}, reqs)
    got, stats = checked(runs, dict(PAGED, batch_slots=3, kv_pool_pages=9),
                         {"chunk_size": 8, "oversubscribe": True, "preempt_policy": "swap"},
                         reqs)
    assert stats.preemptions > 0 and stats.prefix_hits > 0
    for i in range(4):
        assert got[i].tokens == base[i].tokens, i
    assert stats.swapped_pages < stats.preemptions * 4


def test_aging_bound_prevents_starvation(runs):
    """test_oversub.py:149-166."""
    reqs = _workload(n_requests=6, plen=16, max_new=12, spacing=0)
    base, _ = checked(runs, {"batch_slots": 3}, {"chunk_size": 8, "prefix_sharing": False},
                      reqs)
    got, stats = checked(runs, dict(PAGED, batch_slots=3, kv_pool_pages=7),
                         {"chunk_size": 8, "prefix_sharing": False, "oversubscribe": True,
                          "preempt_aging": 1, "preempt_policy": "recompute"}, reqs)
    for i in range(6):
        assert got[i].tokens == base[i].tokens, i
    assert stats.preemptions > 0
    assert max(stats.preempted_rids.values()) <= stats.preemptions


@pytest.mark.parametrize("swap_bytes", [0, 8192])
def test_swap_capacity_refusals_fall_back_to_recompute(runs, swap_bytes):
    """A swap area too small for a victim's padded pages recomputes it:
    refusals, swapped pages and peak bytes as the reference counts them."""
    reqs = _workload(n_requests=4, plen=16, max_new=12, spacing=0)
    base, _ = checked(runs, {"batch_slots": 3}, {"chunk_size": 8, "prefix_sharing": False},
                      reqs)
    got, stats = checked(runs, dict(PAGED, batch_slots=3, kv_pool_pages=7),
                         {"chunk_size": 8, "prefix_sharing": False, "oversubscribe": True,
                          "preempt_policy": "swap", "swap_bytes": swap_bytes}, reqs)
    for i in range(4):
        assert got[i].tokens == base[i].tokens, i
    assert stats.swap_refusals > 0 and stats.swap_peak_bytes <= swap_bytes


def test_oversize_request_rejected_loudly(engines):
    """test_oversub.py:212-234: at run() and in the plan itself."""
    _, te = engines(**PAGED)                                   # cap = 48
    r = Request(0, np.arange(16, dtype=np.int32), 40, 0)      # 56 > 48
    with pytest.raises(ValueError, match="decode garbage"):
        te.scheduler(chunk_size=8).run([r], warmup=False)
    sched = te.scheduler(chunk_size=8, prefix_sharing=False)
    alloc = t_paging.PageAllocator(te.kv_num_pages)
    with pytest.raises(ValueError, match="out-of-bounds sentinel"):
        sched._admission.plan(r, 16, alloc, None)
    assert alloc.pages_in_use == 0


def test_oversize_truncate_mode_grants_what_fits(runs):
    """test_oversub.py:237-251."""
    reqs = [Request(0, np.arange(16, dtype=np.int32), 40, 0),
            Request(1, np.arange(8, dtype=np.int32), 4, 0)]
    got, stats = checked(runs, PAGED, {"chunk_size": 8, "oversize": "truncate"}, reqs)
    assert stats.truncations == 1 and stats.truncated_rids == {0: 32}
    assert len(got[0].tokens) == 32 and len(got[1].tokens) == 4


def test_occupancy_bounded_under_prefix_sharing(runs):
    """test_oversub.py:258-273."""
    rng = np.random.default_rng(13)
    sysp = rng.integers(0, VOCAB, size=24, dtype=np.int32)
    reqs = [Request(i, np.concatenate([sysp, rng.integers(0, VOCAB, size=8, dtype=np.int32)]),
                    8, i) for i in range(4)]
    _, stats = checked(runs, PAGED, {"chunk_size": 8}, reqs)
    assert stats.prefix_hits > 0 and 0.0 < stats.page_occupancy <= 1.0


def test_prompt_digests_hashed_once_per_request(engines, monkeypatch):
    """test_oversub.py:276-295: page-stalled retries reuse the digests."""
    calls = []
    orig = t_paging.PrefixIndex.digests
    monkeypatch.setattr(t_paging.PrefixIndex, "digests",
                        lambda self, prompt: (calls.append(1), orig(self, prompt))[1])
    _, te = engines(kv_pool_pages=5, batch_slots=2, **PAGED)
    got, stats = te.scheduler(chunk_size=8).run(_workload(n_requests=4, spacing=0),
                                                warmup=False)
    assert sorted(got) == list(range(4)) and stats.page_stalls > 0 and len(calls) == 4


# --------------------------------------------------------------------------
# The launch CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--oversubscribe", "--preempt-policy", "swap",
                                        "--pool-pages", "9"],
                                   ["--no-prefix-sharing", "--oversubscribe",
                                    "--pool-pages", "9"]],
                         ids=["paged", "oversub-swap", "oversub-recompute"])
def test_launch_serve_paged_on_cpu(extra, capsys):
    argv = ["--arch", "smollm-135m-smoke", "--policy", "chunked", "--paged", "--page-size",
            "8", "--slots", "4", "--prompt-len", "16", "--requests", "8", "--max-new", "24",
            "--chunk-size", "16", "--arrival-spacing", "1", "--qkv", "--wq",
            "--device", "cpu"] + extra
    results = t_launch.main(argv)
    out = capsys.readouterr().out
    assert "[chunked] warmup(compile)" in out and "pages peak" in out
    assert ("grown" in out) == bool(extra)
    assert sorted(results) == list(range(8))
    assert all(r.status == "ok" for r in results.values())
    with pytest.raises(SystemExit, match="requires --policy chunked"):
        t_launch.main(["--arch", "smollm-135m-smoke", "--policy", "scheduler", "--paged",
                       "--device", "cpu"])
