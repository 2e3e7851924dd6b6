"""Port parity for continuous batching: the port's ``Scheduler`` against
repro's on the same requests (tokens, tick timelines and stats), the cases
of ``tests/test_scheduler.py``, the slot-state walkers, and the launch CLI's
scheduler and chunked policies on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.qformat import QTensor as JQ
from repro.models.registry import get_config as j_get_config
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.slot_state import admit_cache_slot as j_admit
from repro.serve.slot_state import evict_cache_slot as j_evict
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.serve import FaultPlan, Request, Scheduler, ServeEngine
from repro_torch.serve import slot_state

torch.set_num_threads(2)
VOCAB = 503


def to_numpy(tree):
    """The reference's tree as numpy leaves; QTensors become q/n/width dicts."""
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

    def get(max_len=32, batch_slots=2, **kw):
        key = (max_len, batch_slots, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = (JServeEngine(model=jm, params=jp, max_len=max_len,
                                      batch_slots=batch_slots, **kw),
                         ServeEngine(model=tm, params=tp, max_len=max_len,
                                     batch_slots=batch_slots, device="cpu", **kw))
        return made[key]

    return get


@pytest.fixture(scope="module")
def j_run(engines):
    """Memoized reference scheduler runs: (engine kw, scheduler kw, specs)."""
    done = {}

    def run(eng_kw, sched_kw, specs):
        key = (tuple(sorted(eng_kw.items())), tuple(sorted(sched_kw.items())),
               tuple((r, tuple(int(x) for x in p), m, a) for r, p, m, a in specs))
        if key not in done:
            je, _ = engines(**eng_kw)
            done[key] = je.scheduler(**sched_kw).run(
                [JRequest(r, np.asarray(p, np.int32), m, a) for r, p, m, a in specs],
                warmup=False)
        return done[key]

    return run


def t_run(engines, eng_kw, sched_kw, specs):
    _, te = engines(**eng_kw)
    return te.scheduler(**sched_kw).run(
        [Request(r, np.asarray(p, np.int32), m, a) for r, p, m, a in specs], warmup=False)


def assert_same_run(got, want):
    """Tokens, tick timelines and the stats the port keeps, all equal."""
    (g, gs), (w, ws) = got, want
    assert sorted(g) == sorted(w)
    for rid in w:
        assert g[rid].tokens == w[rid].tokens, rid
        assert (g[rid].admitted_at, g[rid].finished_at, g[rid].eos, g[rid].status,
                g[rid].prompt_len) == (w[rid].admitted_at, w[rid].finished_at, w[rid].eos,
                                       w[rid].status, w[rid].prompt_len), rid
    gsum, wsum = gs.summary(), ws.summary()
    for key in ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
                "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
                "admission_stalls", "peak_live_slots", "p50_ttft_steps", "p99_ttft_steps"):
        assert gsum[key] == wsum[key], key
    assert gs.latencies_steps == ws.latencies_steps and gs.ttft_steps == ws.ttft_steps
    assert gs.completed == ws.completed


def _lockstep_specs():
    prompts = (np.arange(16, dtype=np.int32).reshape(2, 8) * 7) % VOCAB
    return prompts, [(i, prompts[i], 10, 0) for i in range(2)]


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_scheduler_token_identical_to_lockstep_and_reference(engines, j_run, quantized_kv):
    """tests/test_scheduler.py:31-45: simultaneous equal-length arrivals."""
    prompts, specs = _lockstep_specs()
    eng_kw = {"quantized_kv": quantized_kv}
    got = t_run(engines, eng_kw, {}, specs)
    assert_same_run(got, j_run(eng_kw, {}, specs))
    base = engines(**eng_kw)[1].generate(prompts, 10).numpy()
    for i in range(2):
        assert got[0][i].tokens == list(base[i])
    assert got[1].occupancy == 1.0 and got[1].tokens_out == 20


def test_scheduler_weight_quant_variant_matches_reference(engines, j_run):
    """tests/test_scheduler.py:48-54, held to the reference's tokens."""
    specs = [(0, np.arange(6), 5, 0)]
    eng_kw = {"weight_quant": True, "quantized_kv": True}
    got = t_run(engines, eng_kw, {}, specs)
    assert_same_run(got, j_run(eng_kw, {}, specs))
    assert len(got[0][0].tokens) == 5 and max(got[0][0].tokens) < VOCAB


def test_queued_requests_admitted_into_freed_slots(engines, j_run):
    """tests/test_scheduler.py:61-79."""
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(0, VOCAB, size=8), 4, 0) for i in range(5)]
    got = t_run(engines, {}, {}, specs)
    assert_same_run(got, j_run({}, {}, specs))
    res = got[0]
    assert res[0].admitted_at == 0 and res[1].admitted_at == 0
    for i in (2, 3, 4):
        assert res[i].admitted_at >= min(res[0].finished_at, res[1].finished_at)
    live = [(r.admitted_at, r.finished_at) for r in res.values()]
    for t in range(max(f for _, f in live) + 1):
        assert sum(a <= t < f for a, f in live) <= 2


def test_staggered_arrivals_and_prompt_bucketing(engines, j_run):
    """tests/test_scheduler.py:82-93."""
    rng = np.random.default_rng(1)
    specs = [(i, rng.integers(0, VOCAB, size=3 + i), 3, 2 * i) for i in range(4)]
    got = t_run(engines, {}, {"prompt_bucket": 8}, specs)
    assert_same_run(got, j_run({}, {"prompt_bucket": 8}, specs))
    for i in range(4):
        assert len(got[0][i].tokens) == 3 and got[0][i].admitted_at >= 2 * i


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_prefill_token_identity(engines, j_run, quantized_kv, chunk):
    """tests/test_scheduler.py:100-119: chunked == one-shot admission, and
    both == the reference, with chunks that do not divide the prompts."""
    rng = np.random.default_rng(3)
    specs = [(i, rng.integers(0, VOCAB, size=5 + 3 * i), 6, i) for i in range(4)]
    eng_kw = {"max_len": 48, "quantized_kv": quantized_kv}
    base = t_run(engines, eng_kw, {}, specs)
    assert_same_run(base, j_run(eng_kw, {}, specs))
    got = t_run(engines, eng_kw, {"chunk_size": chunk}, specs)
    assert_same_run(got, j_run(eng_kw, {"chunk_size": chunk}, specs))
    for i in range(4):
        assert got[0][i].tokens == base[0][i].tokens
    assert got[1].prefill_chunks == sum(-(-(5 + 3 * i) // chunk) for i in range(4))
    assert got[1].admission_stalls == 0


def test_chunked_matches_lockstep_generate(engines, j_run):
    """tests/test_scheduler.py:122-134."""
    prompts, specs = _lockstep_specs()
    got = t_run(engines, {}, {"chunk_size": 3}, specs)
    assert_same_run(got, j_run({}, {"chunk_size": 3}, specs))
    base = engines()[1].generate(prompts, 10).numpy()
    for i in range(2):
        assert got[0][i].tokens == list(base[i])


def test_chunked_token_budget_defers_chunks(engines, j_run):
    """tests/test_scheduler.py:169-188."""
    rng = np.random.default_rng(5)
    specs = [(i, rng.integers(0, VOCAB, size=8), 8, 0) for i in range(6)]
    eng_kw = {"max_len": 48, "batch_slots": 4}
    base = t_run(engines, eng_kw, {}, specs)
    got = t_run(engines, eng_kw, {"chunk_size": 4, "token_budget": 4}, specs)
    assert_same_run(got, j_run(eng_kw, {"chunk_size": 4, "token_budget": 4}, specs))
    for i in range(6):
        assert got[0][i].tokens == base[0][i].tokens
    assert got[1].stalled_chunks > 0
    _, te = engines(**eng_kw)
    with pytest.raises(ValueError, match="token_budget"):
        te.scheduler(chunk_size=8, token_budget=4)
    with pytest.raises(ValueError, match="chunk_size"):
        te.scheduler(token_budget=4)


def test_chunked_rejects_overlong_prompt(engines):
    """tests/test_scheduler.py:212-218: 13 rows pad to 18 > max_len 16."""
    _, te = engines(max_len=16)
    with pytest.raises(ValueError, match="chunk-padded"):
        te.scheduler(chunk_size=6).run([Request(0, np.arange(13), 2)])


def _eos_case(engines, sched_kw):
    prompt = np.arange(8, dtype=np.int32)
    free = t_run(engines, {"batch_slots": 1}, sched_kw, [(0, prompt, 8, 0)])[0]
    eos = free[0].tokens[2]
    specs = [(0, prompt, 8, 0), (1, prompt + 1, 3, 0)]
    return free, eos, specs


def test_chunked_eos_evicts_and_readmits(engines, j_run):
    """tests/test_scheduler.py:221-236, held to the reference run."""
    _, eos, specs = _eos_case(engines, {"chunk_size": 3})
    kw = {"eos_id": eos, "chunk_size": 3}
    got = t_run(engines, {"batch_slots": 1}, kw, specs)
    assert_same_run(got, j_run({"batch_slots": 1}, kw, specs))
    res = got[0]
    assert res[0].eos is True and res[0].tokens[-1] == eos and len(res[0].tokens) <= 3
    assert res[1].admitted_at >= res[0].finished_at and len(res[1].tokens) == 3


def test_eos_evicts_slot_and_readmits(engines):
    """tests/test_scheduler.py:243-262 (one-shot EOS), as that test states it.

    Not compared with the reference: on this model request 0's first token
    is already the EOS id, so its slot is freed at admission.  The
    reference's one-shot loop keeps a stale free list there and fails
    request 1 as "can never be admitted" (the reference test fails).  The
    port refills the freed slot at once: request 1 is admitted and returns
    its 3 tokens.
    """
    free, eos, specs = _eos_case(engines, {})
    assert free[0].tokens.count(eos) >= 1
    res, stats = t_run(engines, {"batch_slots": 1}, {"eos_id": eos}, specs)
    assert res[0].eos is True and res[0].tokens[-1] == eos and len(res[0].tokens) <= 3
    assert res[1].status == "ok" and res[1].admitted_at >= res[0].finished_at
    assert len(res[1].tokens) == 3
    assert stats.completed == 2


@pytest.mark.parametrize("chunk_size", [None, 4])
def test_max_new_one_finishes_at_admission_and_frees_the_slot(engines, j_run, chunk_size):
    """A request whose only token is its first one leaves at admission; in
    the chunked policy the reference agrees tick for tick."""
    rng = np.random.default_rng(9)
    specs = [(i, rng.integers(0, VOCAB, size=6), 1 if i < 2 else 3, 0) for i in range(4)]
    kw = {} if chunk_size is None else {"chunk_size": chunk_size}
    res, stats = t_run(engines, {"batch_slots": 1}, kw, specs)
    assert [len(res[i].tokens) for i in range(4)] == [1, 1, 3, 3]
    assert all(r.status == "ok" for r in res.values()) and stats.completed == 4
    if chunk_size is not None:
        assert_same_run((res, stats), j_run({"batch_slots": 1}, kw, specs))


@pytest.mark.parametrize("kw,err,where", [
    ({"ragged": True}, ValueError, "requires chunked admission"),
    ({"prefill_lanes": 2}, ValueError, "requires ragged=True"),
    ({"reject_policy": "shed"}, ValueError, "reject_policy must be"),
    ({"prefill_lanes": 3}, ValueError, "requires ragged=True"),
    ({"max_queue": 0}, ValueError, "max_queue must be >= 1"),
    ({"audit": True}, None, "runs")])
def test_scheduler_options_of_later_slices_raise(engines, kw, err, where):
    """Misused options raise the reference's validation errors; hardened
    serving's ``audit=True`` serves (an audited tick per step)."""
    _, te = engines()
    if err is None:
        res, stats = te.scheduler(**kw).run([Request(0, np.arange(4), 3)], warmup=False)
        assert res[0].status == "ok" and stats.audited_ticks == stats.decode_steps > 0
    else:
        with pytest.raises(err, match=where):
            te.scheduler(**kw)
    te.scheduler(**{k: v for k, v in (("ragged", False), ("prefill_lanes", 1))})
    te.scheduler(chunk_size=4, ragged=True, prefill_lanes=3)
    with pytest.raises(TypeError, match="unexpected keyword"):
        Scheduler(te, chunk=4)


@pytest.mark.parametrize("run_kw,req_kw,err,where", [
    ({"cancels": {0: 2}}, {}, None, "cancelled"),
    ({"fault_plan": FaultPlan(nan={1: 0})}, {}, ValueError, "requires Scheduler"),
    ({"on_tick": lambda t: None}, {}, None, "ok"),
    ({}, {"deadline_steps": 0}, ValueError, "must be >= 1"),
    ({}, {"enc": np.zeros((2, 4))}, ValueError, "the model has no encoder")])
def test_run_inputs_of_later_slices_raise(engines, run_kw, req_kw, err, where):
    """Hardened serving's inputs run (``cancels``, ``on_tick``) or raise the
    reference's validation errors; an encoder output given to a causal
    model raises the reference's ``ValueError``
    (``src/repro/serve/scheduler.py:988``)."""
    _, te = engines()
    reqs = [Request(0, np.arange(4), 6, **req_kw)]
    if err is None:
        res, _ = te.scheduler().run(reqs, warmup=False, **run_kw)
        assert res[0].status == where
    else:
        with pytest.raises(err, match=where):
            te.scheduler().run(reqs, warmup=False, **run_kw)


def test_time_ticks_records_wall_latency(engines):
    _, te = engines()
    res, stats = te.scheduler(chunk_size=4).run(
        [Request(i, np.arange(5) + i, 3, i) for i in range(3)], time_ticks=True)
    assert len(stats.latencies_s) == 3 and min(stats.latencies_s) > 0
    assert stats.summary()["p99_latency_ms"] > 0 and stats.compile_s > 0


# --------------------------------------------------------------------------
# Slot-state walkers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_admit_and_evict_cache_slot_match_reference(engines, quantized_kv):
    je, te = engines(max_len=12, batch_slots=3, quantized_kv=quantized_kv)
    jc, tc = je.new_cache(per_slot=True), te.new_cache(per_slot=True)
    rng = np.random.default_rng(2)
    js, ts = je.new_cache(batch=1), te.new_cache(batch=1)
    for jn, tn in ((js["body"][0]["kv"], ts["body"][0]["kv"]),):
        for name in ("k", "v"):
            x = rng.integers(-128, 128, tn[name].shape) if quantized_kv \
                else rng.normal(0, 1, tn[name].shape)
            x = x.astype(np.int8 if quantized_kv else np.float32)
            jn[name] = jnp.asarray(x)
            tn[name] = torch.from_numpy(x.copy())
    jc, tc = j_admit(jc, js, jnp.int32(1), jnp.int32(7)), \
        slot_state.admit_cache_slot(tc, ts, 1, 7)
    jc, tc = j_evict(jc, jnp.int32(0)), slot_state.DenseKVState().evict(tc, 0)
    jkv, tkv = jc["body"][0]["kv"], tc["body"][0]["kv"]
    for name in ("k", "v"):
        np.testing.assert_array_equal(tkv[name].numpy(), np.asarray(jkv[name]))
    jlen = np.asarray(jkv["len"])
    for row in jlen.reshape(-1, 3):            # one (B,) row per stacked layer
        np.testing.assert_array_equal(tkv["len"].numpy(), row)
    assert tkv["len"].tolist() == [0, 7, 0]


def test_state_kinds_and_adapters_name_their_slices(smoke):
    tm = smoke[2]
    assert slot_state.state_kinds(tm) == ("kv",)
    assert [a.kind for a in slot_state.adapters_for(tm)] == ["kv"]
    assert [a.kind for a in slot_state.adapters_for(tm, paged=True)] == ["kv-paged"]

    # the EncDec decoder serves KV and cross-attention state
    from repro_torch.models.registry import get_config

    whisper = get_config("whisper-tiny-smoke").build()
    assert slot_state.state_kinds(whisper) == ("kv", "cross")
    assert [a.kind for a in slot_state.adapters_for(whisper)] == ["kv", "cross"]
    assert [a.kind for a in slot_state.adapters_for(whisper, paged=True)] == \
        ["kv-paged", "cross"]
    assert [a.kind for a in slot_state.adapters_for(whisper, cross_attn_cache=False)] == ["kv"]
    # an ssm node: eviction zeroes the slot's row in a copy, as the reference does
    h = torch.ones(3, 2, 2)
    out = slot_state.evict_cache_slot({"body": [{"ssm": {"h": h, "conv": None}}]}, 1)
    got = out["body"][0]["ssm"]
    assert got["conv"] is None and bool((h == 1).all())
    assert got["h"][1].abs().sum() == 0 and bool((got["h"][[0, 2]] == 1).all())
    with pytest.raises(ValueError, match="dense KV cache"):
        slot_state.set_cache_page_row({"k": 0, "len": 0}, 0, [0])


# --------------------------------------------------------------------------
# The launch CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["scheduler", "chunked"])
def test_launch_serve_scheduler_policies_on_cpu(policy, capsys):
    argv = ["--arch", "smollm-135m-smoke", "--policy", policy, "--chunk-size", "4",
            "--slots", "2", "--prompt-len", "6", "--requests", "4", "--max-new", "5",
            "--max-new-min", "3", "--arrival-spacing", "1", "--wq", "--qkv", "--device", "cpu"]
    results = t_launch.main(argv)
    out = capsys.readouterr().out
    assert f"[{policy}] warmup(compile)" in out and "tok/s" in out and "ttft" in out
    assert ("chunks 8" in out) == (policy == "chunked")
    assert sorted(results) == [0, 1, 2, 3]
    assert [len(results[i].tokens) for i in range(4)] == [3, 5, 3, 5]
