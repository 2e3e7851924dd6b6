"""Port parity for ragged serving: the port's ``Scheduler(ragged=True,
prefill_lanes=L)`` against repro's on the same requests, the cases of
``tests/test_ragged.py`` and ``bench_burst``'s smoke workload
(``benchmarks/serve_bench.py``).  Tokens, tick timelines and every stat
both report are held equal; each case also keeps the assertions of the
reference test it mirrors.

The EncDec case (``test_ragged.py:132``) is mirrored in
``test_torch_encdec_serve.py``.  Not mirrored: the jit-compile count
(``test_ragged.py:157-178``) is JAX's, and its CPU stand-in here holds every
tick's step inputs to one shape.  The interpret-mode end-to-end runs have
no CPU counterpart: the port's kernel runs on the card only, where
``chip_smoke.py`` holds ragged serving to the plain versions.
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


def _jreqs(reqs):
    return [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival)
            for r in reqs]


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


def checked(engines, eng_kw, sched_kw, reqs):
    """The port's run, after holding it to the reference's."""
    je, te = engines(**eng_kw)
    want = je.scheduler(**sched_kw).run(_jreqs(reqs), warmup=False)
    got = te.scheduler(**sched_kw).run(reqs, warmup=False)
    assert_same_run(got, want)
    return got


def _reqs(n, *, seed=3, base_len=5, stride=3, max_new=6, spacing=1):
    """test_ragged.py:38-42."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, VOCAB, size=base_len + stride * i), max_new,
                    spacing * i) for i in range(n)]


# --------------------------------------------------------------------------
# tests/test_ragged.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("chunk", [4, 7])
def test_ragged_token_identical_to_mixed(engines, quantized_kv, chunk):
    """test_ragged.py:49-66: three lanes, staggered arrivals, readmission,
    chunk sizes that divide no prompt length."""
    reqs = _reqs(6)
    kv = {"quantized_kv": quantized_kv}
    base, _ = checked(engines, kv, {"chunk_size": chunk}, reqs)
    got, stats = checked(engines, kv, {"chunk_size": chunk, "ragged": True,
                                       "prefill_lanes": 3}, reqs)
    for i in range(6):
        assert got[i].tokens == base[i].tokens, (quantized_kv, chunk, i)
    assert stats.prefill_chunks == sum(-(-len(r.prompt) // chunk) for r in reqs)


def test_ragged_paged_prefix_sharing_identity(engines):
    """test_ragged.py:69-90: shared-prefix requests map resident pages."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, VOCAB, size=16, dtype=np.int32)
    reqs = [Request(i, np.concatenate([head, rng.integers(0, VOCAB, size=4, dtype=np.int32)]),
                    5, 0 if i == 0 else 8) for i in range(4)]
    kw = {"paged_kv": True, "page_size": 8, "quantized_kv": True}
    base, _ = checked(engines, kw, {"chunk_size": 8}, reqs)
    got, stats = checked(engines, kw, {"chunk_size": 8, "ragged": True, "prefill_lanes": 2},
                         reqs)
    for i in range(4):
        assert got[i].tokens == base[i].tokens, i
    assert stats.prefix_hits > 0 and stats.shared_pages_mapped > 0


@pytest.mark.parametrize("preempt", ["recompute", "swap"])
def test_ragged_oversubscribed_preemption_identity(engines, preempt):
    """test_ragged.py:93-114: the pool runs dry mid-decode in both runs."""
    rng = np.random.default_rng(9)
    reqs = [Request(i, rng.integers(0, VOCAB, size=8), 14, i) for i in range(4)]
    kw = {"max_len": 32, "batch_slots": 4, "paged_kv": True, "page_size": 8,
          "kv_pool_pages": 8, "quantized_kv": True}
    sk = {"chunk_size": 8, "oversubscribe": True, "preempt_policy": preempt}
    base, bstats = checked(engines, kw, sk, reqs)
    got, rstats = checked(engines, kw, dict(sk, ragged=True, prefill_lanes=2), reqs)
    for i in range(4):
        assert got[i].tokens == base[i].tokens, (preempt, i)
    assert bstats.preemptions > 0 and rstats.preemptions > 0
    if preempt == "swap":
        assert rstats.resumes > 0


def test_ragged_eos_evicts_and_readmits(engines):
    """test_ragged.py:117-127 (the chunked path has no stale free list, so
    the reference's run is the port's)."""
    prompt = np.arange(8, dtype=np.int32)
    kw = {"batch_slots": 1, "max_len": 32}
    free_run, _ = checked(engines, kw, {"chunk_size": 3, "ragged": True},
                          [Request(0, prompt, 8)])
    eos = free_run[0].tokens[2]
    reqs = [Request(0, prompt, 8), Request(1, prompt + 1, 3)]
    results, _ = checked(engines, kw, {"eos_id": eos, "chunk_size": 3, "ragged": True}, reqs)
    assert results[0].eos is True and results[0].tokens[-1] == eos
    assert len(results[0].tokens) <= 3
    assert results[1].admitted_at >= results[0].finished_at
    assert len(results[1].tokens) == 3


def test_ragged_requires_chunk_size_and_lanes_require_ragged(engines):
    """test_ragged.py:181-189."""
    _, te = engines()
    with pytest.raises(ValueError, match="chunk_size"):
        te.scheduler(ragged=True)
    with pytest.raises(ValueError, match="prefill_lanes"):
        te.scheduler(chunk_size=4, prefill_lanes=2)
    with pytest.raises(ValueError, match="prefill_lanes"):
        te.scheduler(chunk_size=4, ragged=True, prefill_lanes=0)


def test_ragged_step_shapes_are_fixed(engines):
    """Stands in for test_ragged.py:157-178: every tick of a run, warm-up
    and pure-decode ticks included, gives the step inputs of one shape,
    T = B + L*C token rows and B + L logit rows, whatever the prompt
    lengths."""
    _, te = engines(max_len=64)

    def shapes(lanes, lens):
        rng = np.random.default_rng(13)
        reqs = [Request(i, rng.integers(0, VOCAB, size=p), 3) for i, p in enumerate(lens)]
        sched = te.scheduler(chunk_size=8, ragged=True, prefill_lanes=lanes)
        step, seen = sched._ragged, []

        def recording(params, tok, cache, gen, ctok, sids, poss, lrows):
            seen.append(tuple(tuple(x.shape) for x in (tok, ctok, sids, poss, lrows)))
            return step(params, tok, cache, gen, ctok, sids, poss, lrows)

        sched._ragged = recording
        _, stats = sched.run(reqs)
        assert len(seen) == stats.decode_steps + 1           # the warm-up tick
        return set(seen)

    for lanes in (1, 2, 4):
        want = {((4, 1), (lanes, 8), (4 + 8 * lanes,), (4 + 8 * lanes,), (4 + lanes,))}
        assert shapes(lanes, [11]) == shapes(lanes, [3, 5, 8, 11, 14, 17, 21]) == want


def test_ragged_burst_ttft_matches_reference(engines):
    """``bench_burst``'s smoke workload (serve_bench.py:556-558): 8 requests
    of 96 tokens at tick 0, 8 slots, chunk 16, 4 lanes, budget 64, page 16.
    The ragged run and the single-lane paged mixed run equal repro's, tick
    for tick; ragged drains the burst sooner (p99 TTFT)."""
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, VOCAB, size=96, dtype=np.int32), 8, 0)
            for i in range(8)]
    kw = {"max_len": 104, "batch_slots": 8, "paged_kv": True, "page_size": 16,
          "quantized_kv": True}
    m_res, m_st = checked(engines, kw, {"chunk_size": 16, "token_budget": 64}, reqs)
    r_res, r_st = checked(engines, kw, {"chunk_size": 16, "token_budget": 64, "ragged": True,
                                        "prefill_lanes": 4}, reqs)
    for i in range(8):
        assert r_res[i].tokens == m_res[i].tokens, i
    assert r_st.summary()["p99_ttft_steps"] < m_st.summary()["p99_ttft_steps"]


# --------------------------------------------------------------------------
# The launch CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--paged", "--page-size", "8"],
                                   ["--paged", "--page-size", "8", "--oversubscribe",
                                    "--preempt-policy", "swap", "--pool-pages", "9"]],
                         ids=["dense", "paged", "paged-oversub-swap"])
def test_launch_serve_ragged_on_cpu(extra, capsys):
    argv = ["--arch", "smollm-135m-smoke", "--policy", "ragged", "--prefill-lanes", "2",
            "--slots", "4", "--prompt-len", "16", "--requests", "8", "--max-new", "24",
            "--chunk-size", "16", "--arrival-spacing", "1", "--qkv", "--wq",
            "--device", "cpu"] + extra
    results = t_launch.main(argv)
    out = capsys.readouterr().out
    assert "[ragged] warmup(compile)" in out and "chunks 8" in out
    assert ("pages peak" in out) == bool(extra)
    assert sorted(results) == list(range(8))
    assert all(r.status == "ok" and len(r.tokens) == 24 for r in results.values())
