"""Port parity for serving the MoE and hybrid archs: the port's
``Scheduler`` against repro's on phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b
(chunked dense and paged, ragged dense or paged) and jamba-v0.1-52b
(chunked, dense and paged, and one-shot ``scheduler``) at smoke size, int8
weights and an int8 KV cache, on the reference's parameters carried over
by ``repro_torch.convert``; each engine integerizes them (the reference's
integerization jitted, which gives its codes in a fraction of its op-by-op
time).

The workloads keep every expert's capacity under pressure: 4 slots at E =
4, top-2, so a decode step's 4 tokens (inactive slots included) share a
capacity of ceil(4 * 2 / 4 * 1.25) = 3, and the pad rows of a last chunk
and of a ragged tick compete with the live ones.  So the port's forward
must carry the reference's rows with the reference's values, not only the
live ones.  Tokens, tick timelines, every stat both report and
``state_kinds`` are held equal, and for the attention archs the KV cache
each step returns (codes, lengths, exponents, page tables) bit for bit,
tick by tick.  Also: the launcher on the three archs (jamba's ragged policy
raising the reference's ``ValueError``), and the reference's failure on
packed sub-int8 MoE weights pinned beside the port's refusal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.launch import serve as j_launch
from repro.serve import engine as j_engine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as t_launch
from repro_torch.serve import Request, ServeEngine, state_kinds
from repro_torch.serve import slot_state
from test_torch_archs import smoke

torch.set_num_threads(2)
STAT_KEYS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
             "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
             "admission_stalls", "page_stalls", "peak_pages_in_use", "peak_live_slots",
             "prefix_hits", "p50_ttft_steps", "p99_ttft_steps", "state_kinds")
PHI, KIMI, JAMBA = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"
SLOTS = 4


def workload(vocab, n=7, plen=11, max_new=8, seed=11):
    """n requests, two arriving each tick, prompts of ``plen`` (the last
    chunk of 8 padded), horizons alternating ``max_new`` and 3 fewer."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=plen, dtype=np.int32),
                    max_new=max_new if i % 2 == 0 else max_new - 3, arrival=i // 2)
            for i in range(n)]


def kv_snapshot(cache):
    """Every KV node's leaves (prelude first, then the body), numpy copies."""
    nodes = list(cache.get("prelude", [])) + list(cache["body"])
    return [{k: np.array(v, copy=True) for k, v in node["kv"].items()}
            for node in nodes if "kv" in node]


def recording(step, caches):
    def wrapped(*a, **k):
        out = step(*a, **k)
        caches.append(kv_snapshot(out[-1]))
        return out
    return wrapped


def same_kv(got, want):
    """The port's KV nodes against the reference's: equal leaves; the port's
    one table, lens and exponents against every layer's copy in the
    reference's stacked node (the frozen exponents held by value)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, wv in w.items():
            gv = g[key]
            if gv.shape != wv.shape:
                wv = wv.reshape(-1, *gv.shape)
                for layer in wv:
                    np.testing.assert_array_equal(gv, layer, err_msg=key)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=key)


_j_integerize = jax.jit(j_integerize, static_argnames=("bits", "per_channel", "block_size"))


@pytest.fixture(autouse=True)
def jitted_reference_integerize(monkeypatch):
    """The reference engine's ``integerize_weights_only`` jitted: the same
    codes (``tests/test_torch_moe.py`` holds its int8 trees bit for bit)
    where op by op it takes seconds an arch."""
    monkeypatch.setattr(j_engine, "integerize_weights_only", _j_integerize)


def serve_both(arch, policy, paged):
    """Run one workload through both packages' schedulers: the port's and
    the reference's (results, stats, KV snapshots per tick)."""
    jm, jp, tm, tp, cfg = smoke(arch)
    kw = dict(max_len=24, batch_slots=SLOTS, quantized_kv=True)
    if paged:
        kw.update(paged_kv=True, page_size=8)
    sched_kw = {"scheduler": {}, "chunked": {"chunk_size": 8},
                "ragged": {"chunk_size": 8, "ragged": True, "prefill_lanes": 2}}[policy]
    reqs = workload(cfg.vocab)
    runs = []
    for eng, rq in ((ServeEngine(model=tm, params=tp, device="cpu", weight_quant=True, **kw),
                     reqs),
                    (JServeEngine(model=jm, params=jp, weight_quant=True, **kw),
                     [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival)
                      for r in reqs])):
        sched = eng.scheduler(**sched_kw)
        caches = []
        for name in ("_masked_decode", "_masked_mixed", "_masked_ragged"):
            if hasattr(sched, name):
                setattr(sched, name, recording(getattr(sched, name), caches))
        runs.append(sched.run(rq, warmup=False) + (caches,))
    return reqs, runs


CASES = [(PHI, "chunked", False), (PHI, "chunked", True), (PHI, "ragged", False),
         (KIMI, "chunked", False), (KIMI, "ragged", True), (JAMBA, "chunked", False),
         (JAMBA, "chunked", True), (JAMBA, "scheduler", False)]


@pytest.mark.parametrize("arch,policy,paged", CASES,
                         ids=[f"{a.split('-')[0]}-{p}{'-paged' if g else ''}"
                              for a, p, g in CASES])
def test_scheduler_matches_reference(arch, policy, paged):
    reqs, ((g, gs, gc), (w, ws, wc)) = serve_both(arch, policy, paged)
    assert sorted(g) == sorted(w) == [r.rid for r in reqs]
    for rid in w:
        assert g[rid].status == w[rid].status == "ok"
        assert g[rid].tokens == w[rid].tokens, rid
        assert (g[rid].admitted_at, g[rid].finished_at) == \
            (w[rid].admitted_at, w[rid].finished_at), rid
    gsum, wsum = gs.summary(), ws.summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key
    assert gsum["state_kinds"] == ("kv+recurrent" if arch == JAMBA else "kv")
    assert gsum["peak_live_slots"] == SLOTS
    assert len(gc) == len(wc) == gs.decode_steps
    for tick, (a, b) in enumerate(zip(gc, wc)):
        try:
            same_kv(a, b)
        except AssertionError as e:
            raise AssertionError(f"tick {tick}: {e}") from None


def test_state_kinds_and_bytes():
    """jamba serves KV and recurrent state; kimi's prelude layer has its own
    KV node, counted in the cache bytes as the reference counts it."""
    assert state_kinds(smoke(JAMBA)[2]) == ("kv", "recurrent")
    assert [a.kind for a in slot_state.adapters_for(smoke(JAMBA)[2], paged=True)] == \
        ["kv-paged", "recurrent"]
    assert state_kinds(smoke(KIMI)[2]) == state_kinds(smoke(PHI)[2]) == ("kv",)
    jm, jp, tm, tp, _ = smoke(KIMI)
    kw = dict(max_len=24, batch_slots=SLOTS, quantized_kv=True)
    te = ServeEngine(model=tm, params=tp, device="cpu", **kw)
    cache = te.new_cache(per_slot=True)
    assert sorted(cache) == ["body", "prelude"] and "kv" in cache["prelude"][0]
    assert te.cache_bytes() == JServeEngine(model=jm, params=jp, **kw).cache_bytes()


@pytest.mark.parametrize("arch,policy", [(PHI, "chunked"), (KIMI, "ragged"),
                                         (JAMBA, "chunked")])
def test_launch_serve_matches_reference_schedule(arch, policy, monkeypatch):
    """``launch.serve`` on the archs' smoke configs: the report line ends in
    the reference's ``| state ...`` and its stats equal the reference's run
    (each package draws its own random weights: schedules compared)."""
    argv = ["--arch", arch + "-smoke", "--policy", policy, "--chunk-size", "4", "--slots",
            "4", "--prompt-len", "6", "--requests", "5", "--max-new", "5", "--wq", "--qkv"]
    stats = []
    for mod in (t_launch, j_launch):
        real = mod.report
        monkeypatch.setattr(mod, "report", lambda name, st, real=real: (stats.append(st),
                                                                         real(name, st)))
    got = t_launch.main(argv + ["--device", "cpu"])
    want = j_launch.main(argv)
    assert all(r.status == "ok" for r in got.values()) and sorted(got) == sorted(want)
    gsum, wsum = stats[0].summary(), stats[1].summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key


def test_jamba_ragged_raises_the_reference_error():
    argv = ["--arch", JAMBA + "-smoke", "--policy", "ragged", "--slots", "2",
            "--prompt-len", "6", "--requests", "2", "--max-new", "3", "--chunk-size", "4"]
    with pytest.raises(ValueError) as got:
        t_launch.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError) as want:
        j_launch.main(argv)
    assert str(got.value) == str(want.value)
    assert "ragged=True cannot serve recurrent-state" in str(got.value)


@pytest.mark.parametrize("wq", ["int4", "int4-block", "int2", "int2-block"])
def test_reference_fails_on_packed_moe_weights(wq):
    """Packed sub-int8 weights on an MoE model (ROADMAP.md section 3): the
    reference packs the expert stacks and its ``MoE._expert_w`` then fails
    at the first forward with ``AttributeError`` (run at int4-block, one
    packing of the tree: every format takes that path); the port refuses
    the engine with ``ValueError``, at construction and through the
    launcher."""
    jm, jp, tm, tp, cfg = smoke(PHI)
    kw = dict(max_len=24, batch_slots=2, weight_quant=wq, weight_block=16)
    if wq == "int4-block":
        je = JServeEngine(model=jm, params=jp, **kw)
        with pytest.raises(AttributeError, match="'PackedQTensor' object has no attribute"):
            je.generate(jnp.zeros((2, 4), jnp.int32), 2)
    with pytest.raises(ValueError, match=f"weight_quant='{wq}' on a model with MoE layers"):
        ServeEngine(model=tm, params=tp, device="cpu", **kw)
    with pytest.raises(ValueError, match="on a model with MoE layers"):
        t_launch.main(["--arch", KIMI + "-smoke", "--policy", "chunked", "--wq", wq,
                       "--requests", "1", "--slots", "2", "--device", "cpu"])
