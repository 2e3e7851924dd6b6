"""Port parity for EncDec serving (whisper-tiny-smoke): the port's
``ServeEngine`` and ``Scheduler`` with ``Request.enc`` against repro's on the
reference's parameters (carried over by ``repro_torch.convert``) and the same
encoder outputs, the greedy streams, tick timelines and stats held equal:

* the cases of ``tests/test_encdec_serve.py``: chunked serving equal to
  lockstep ``generate()``, the encoder context changing the stream, paged
  equal to dense, and the guard rails (one-shot admission, a missing
  ``enc``, one encoder shape per run, ``enc_len``);
* the EncDec cases of ``tests/test_slot_state.py``: ``state_kinds``, the
  same streams with and without the cross-attention cache, an audited run
  clean; the per-slot state bytes and the cache bytes the report prints;
* ``tests/test_ragged.py:132``: ragged ticks equal to the mixed step;
* int8 KV, dense and paged, chunked and ragged;
* a slot reused by a request with another encoder length than the run's
  earlier one, across two runs of one engine;
* the every-tick auditor: a live slot's ``xlen`` corrupted by one step
  raises the reference's ``AuditError``, message for message, in its own
  tick in both schedulers, and an audited tick makes one read-back (two
  paged);
* the reference's EncDec failures pinned beside the port's refusals: int8
  weights (``TypeError`` at the first step in the reference, ``ValueError``
  at construction here), lockstep and restart batching without an encoder
  output (``AttributeError`` there, ``ValueError`` here) and each policy of
  ``launch.serve --arch whisper-tiny-smoke``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_launch
from repro.nn.module import eval_context
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import run_restart_batching as j_restart
from repro.serve import state_bytes_per_slot as j_state_bytes
from repro_torch.launch import serve as t_launch
from repro_torch.serve import (Request, ServeEngine, run_restart_batching, slot_state,
                               state_bytes_per_slot, state_kinds)
from test_torch_encdec import whisper

torch.set_num_threads(2)
STAT_KEYS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
             "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
             "page_stalls", "peak_pages_in_use", "p50_ttft_steps", "p99_ttft_steps",
             "audited_ticks", "state_kinds", "completion_rate", "peak_live_slots")
_engines = {}


def engines(**kw):
    """Memoized (reference engine, port engine) on whisper-tiny-smoke's
    reference parameters; max_len 24 and 2 slots by default."""
    kw.setdefault("max_len", 24)
    kw.setdefault("batch_slots", 2)
    key = tuple(sorted(kw.items()))
    if key not in _engines:
        jm, jp, tm, tp, _ = whisper()
        _engines[key] = (JServeEngine(model=jm, params=jp, **kw),
                         ServeEngine(model=tm, params=tp, device="cpu", **kw))
    return _engines[key]


def encode(seed, s_enc=6, scale=0.1):
    """A request's encoder output (1, S_enc, D) through the reference's
    encoder (numpy; the port is handed the same array)."""
    jm, jp, _, _, _ = whisper()
    emb = scale * jax.random.normal(jax.random.PRNGKey(seed), (1, s_enc, jm.d_model))
    return np.asarray(jm.encode(jp, emb, eval_context()))


def workload(n=3, seed=5, plen=4, max_new=5, spacing=1, s_enc=6, enc_seed=30):
    rng = np.random.default_rng(seed)
    cfg = whisper()[4]
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=plen + i).astype(np.int32),
                    max_new=max_new, arrival=i * spacing,
                    enc=encode(enc_seed + i, s_enc, scale=20.0)) for i in range(n)]


def j_requests(reqs):
    return [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival,
                     enc=None if r.enc is None else jnp.asarray(r.enc)) for r in reqs]


def both(reqs, eng_kw=None, **sched_kw):
    """((port results, stats), (reference results, stats)) of one workload."""
    je, te = engines(**(eng_kw or {}))
    return te.scheduler(**sched_kw).run(reqs), je.scheduler(**sched_kw).run(j_requests(reqs))


def assert_same(pair):
    (g, gs), (w, ws) = pair
    assert sorted(g) == sorted(w)
    for rid in w:
        assert (g[rid].status, g[rid].tokens, g[rid].admitted_at, g[rid].finished_at,
                g[rid].eos) == (w[rid].status, w[rid].tokens, w[rid].admitted_at,
                                w[rid].finished_at, w[rid].eos), rid
    gsum, wsum = gs.summary(), ws.summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key
    return g, gs


def test_chunked_serving_matches_generate_and_reference():
    """``test_encdec_chunked_serving_matches_generate``: two requests with
    different encoder contexts; the scheduler's streams equal lockstep
    ``generate()`` fed the same per-slot rows, in the port and in the
    reference, and the reference's run."""
    je, te = engines()
    cfg = whisper()[4]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 5)).astype(np.int32)
    encs = [encode(seed, scale=20.0) for seed in (10, 20)]
    enc = np.concatenate(encs, axis=0)
    want = np.asarray(je.generate(jnp.asarray(prompts), 6, enc=jnp.asarray(enc)))
    np.testing.assert_array_equal(te.generate(prompts, 6, enc=enc).numpy(), want)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=6, enc=encs[i]) for i in range(2)]
    got, stats = assert_same(both(reqs, chunk_size=3))
    assert stats.state_kinds == "kv+cross"
    for i in range(2):
        assert got[i].tokens == want[i].tolist(), i


def test_encoder_context_changes_the_stream():
    """``test_encdec_enc_actually_matters``: the same prompt under two
    encoder outputs decodes two streams, each the reference's."""
    prompt = np.arange(5, dtype=np.int32) + 3
    streams = []
    for seed in (10, 20):
        reqs = [Request(rid=0, prompt=prompt, max_new=8, enc=encode(seed, scale=20.0))]
        got, _ = assert_same(both(reqs, chunk_size=3))
        streams.append(got[0].tokens)
    assert streams[0] != streams[1]


@pytest.mark.parametrize("eng_kw,sched_kw", [
    ({"paged_kv": True, "page_size": 8}, {"chunk_size": 4}),
    ({"quantized_kv": True}, {"chunk_size": 4}),
    ({"quantized_kv": True, "paged_kv": True, "page_size": 8}, {"chunk_size": 4}),
    ({}, {"chunk_size": 4, "ragged": True, "prefill_lanes": 2}),
    ({"quantized_kv": True, "paged_kv": True, "page_size": 8},
     {"chunk_size": 4, "ragged": True, "prefill_lanes": 2})],
    ids=["paged", "int8kv", "int8kv-paged", "ragged", "ragged-int8kv-paged"])
def test_paged_int8_and_ragged_match_dense_and_reference(eng_kw, sched_kw):
    """``test_encdec_paged_chunked_matches_dense`` and
    ``test_ragged.py::test_ragged_encdec_matches_mixed``: three staggered
    requests over two slots; each variant equal to the reference's run, and
    the float ones to the dense chunked run."""
    reqs = workload()
    got, _ = assert_same(both(reqs, eng_kw, **sched_kw))
    if not eng_kw.get("quantized_kv"):
        base, _ = engines()[1].scheduler(chunk_size=4).run(reqs)
        for i in range(3):
            assert got[i].tokens == base[i].tokens, i


def test_streams_equal_with_and_without_the_cross_cache():
    """``test_encdec_serving_identical_with_and_without_cache``: the cached
    rows are a FLOP cut, not another result; ``state_kinds`` reads
    ``kv+cross`` with the cache and ``kv`` without, as in the reference."""
    reqs = workload()
    off_pair = both(reqs, {"cross_attn_cache": False}, chunk_size=4)
    off, st_off = assert_same(off_pair)
    on, st_on = assert_same(both(reqs, chunk_size=4))
    assert (st_on.state_kinds, st_off.state_kinds) == ("kv+cross", "kv")
    for i in range(3):
        assert on[i].tokens == off[i].tokens, i
    rag = assert_same(both(reqs, {"cross_attn_cache": False}, chunk_size=4, ragged=True,
                           prefill_lanes=2))[0]
    assert all(rag[i].tokens == on[i].tokens for i in range(3))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_audited_run_clean_with_one_read_back_a_tick(paged):
    """``test_encdec_cached_audit_clean``: every tick audited, the cross
    lengths read with the health flags (one read-back a tick, plus the
    table and lens at the tick's end when paged)."""
    rng = np.random.default_rng(6)
    cfg = whisper()[4]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5).astype(np.int32),
                    max_new=4, arrival=i, enc=encode(40 + i, s_enc=5)) for i in range(3)]
    eng_kw = {"paged_kv": True, "page_size": 8} if paged else {}
    got, stats = assert_same(both(reqs, eng_kw, chunk_size=3, audit=True))
    assert stats.audited_ticks == stats.decode_steps > 0
    assert stats.audit_reads == (2 if paged else 1) * stats.decode_steps
    assert all(got[i].status == "ok" for i in range(3))


@pytest.mark.parametrize("where", ["slot", "layers"])
def test_xlen_corruption_raises_in_its_own_tick(where):
    """One step hands back a cache whose live slot 0 reads ``xlen`` 3 in
    every layer (``slot``) or in the last layer only (``layers``).  Under
    ``audit=True`` both schedulers raise ``AuditError`` with the same
    message at the end of that tick."""
    from repro.serve.audit import AuditError as JAuditError
    from repro_torch.serve.audit import AuditError

    reqs = workload(n=1, max_new=10)
    je, te = engines()
    raised = []
    for eng, rq, err, torch_side in ((te, reqs, AuditError, True),
                                     (je, j_requests(reqs), JAuditError, False)):
        sched = eng.scheduler(chunk_size=4, audit=True)
        box = {"t": None, "done": False}

        def corrupting(step, box=box, torch_side=torch_side):
            def wrapped(*a, **k):
                out = step(*a, **k)
                if box["done"] or box["t"] is None or box["t"] < 4:
                    return out
                box["done"] = True
                cache = out[-1]
                node = cache["body"][0]["xkv"]
                at = (slice(None) if where == "slot" else -1, 0)
                if torch_side:
                    xlen = node["xlen"].clone()
                    xlen[at] = 3
                else:
                    xlen = node["xlen"].at[at].set(3)
                body = [dict(cache["body"][0], xkv=dict(node, xlen=xlen))]
                return (*out[:-1], dict(cache, body=body))
            return wrapped

        for name in ("_masked_decode", "_masked_mixed"):
            setattr(sched, name, corrupting(getattr(sched, name)))

        def on_tick(t, box=box):
            box["t"] = t

        with pytest.raises(err) as info:
            sched.run(rq, warmup=False, on_tick=on_tick)
        assert box["done"]
        raised.append((box["t"], str(info.value)))
    assert raised[0] == raised[1] and raised[0][0] == 4
    if where == "slot":
        assert raised[0][1] == "slot 0: cached cross-attention xlen 3 != expected 6 (live slot)"
    else:
        assert raised[0][1].startswith("cross-attention xlen disagrees across stacked layers")


def test_check_cross_lens_agrees_with_reference():
    """The auditor on hand-made caches: clean, a dead slot's stale length, a
    live slot's wrong one, layers that disagree; the same outcome and
    message as the reference's ``check_cross_lens``."""
    from repro.serve.audit import AuditError as JAuditError
    from repro.serve.audit import check_cross_lens as j_check
    from repro_torch.serve.audit import AuditError, check_cross_lens

    cases = [([[6, 0, 4], [6, 0, 4]], {0: 6, 2: 4}), ([[6, 5, 4], [6, 5, 4]], {0: 6, 2: 4}),
             ([[6, 0, 3], [6, 0, 3]], {0: 6, 2: 4}), ([[6, 0, 4], [6, 0, 5]], {0: 6, 2: 4}),
             ([[0, 0, 0], [0, 0, 0]], {})]
    for xl, want in cases:
        xl = np.asarray(xl, np.int32)
        cache = {"body": [{"kv": {"k": 0, "len": 0},
                           "xkv": {"xk": 0, "xv": 0, "xlen": xl}}]}
        outcome = []
        for check, err, conv in ((check_cross_lens, AuditError, torch.from_numpy),
                                 (j_check, JAuditError, jnp.asarray)):
            node = dict(cache["body"][0], xkv=dict(cache["body"][0]["xkv"], xlen=conv(xl)))
            try:
                check({"body": [node]}, want)
                outcome.append(None)
            except err as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (xl.tolist(), outcome)


def test_state_bytes_and_cache_bytes_match_reference():
    """The ``cross`` entry of ``state_bytes_per_slot`` (2 x L x enc_len x
    Hkv x D x 4 bytes plus the L ``xlen`` words) equals the reference's, and
    so do ``cache_bytes`` (lockstep, the report's ``peak_cache_bytes``) and
    the per-slot cache's leaves, with and without the cross cache."""
    jm, _, tm, _, cfg = whisper()
    for cross in (True, False):
        got = state_bytes_per_slot(tm.init_cache(2, 24, per_slot_len=True, device="meta",
                                                 cross_attn_cache=cross), 2)
        want = j_state_bytes(jm.init_cache(2, 24, per_slot_len=True, kv_dtype=jnp.float32,
                                           cross_attn_cache=cross), 2)
        assert got["cross"] == want["cross"] == \
            (2 * 2 * cfg.enc_seq * cfg.n_kv_heads * cfg.head_dim * 4 + 2 * 4 if cross else 0)
        assert got["recurrent"] == want["recurrent"] == 0
        for qkv in (False, True):
            je, te = engines(quantized_kv=qkv, cross_attn_cache=cross)
            assert te.cache_bytes() == je.cache_bytes()
            assert te.cache_bytes(per_slot=True) == sum(
                x.size * x.dtype.itemsize
                for x in jax.tree_util.tree_leaves(je.new_cache(per_slot=True)))
    assert state_kinds(tm) == ("kv", "cross")
    assert [a.kind for a in slot_state.adapters_for(tm)] == ["kv", "cross"]


def test_a_reused_slot_takes_a_shorter_encoder_output():
    """One engine: a run at 16 encoder frames, then a run at 5 in the same
    slots; the second run's rows past 5 still hold the first's projection,
    masked by ``xlen``.  Each run equals the reference's, and the second
    equals a run on a fresh engine."""
    reqs16 = workload(n=2, s_enc=16, enc_seed=50)
    reqs5 = workload(n=2, s_enc=5, enc_seed=60, seed=9)
    je, te = engines()
    sched = te.scheduler(chunk_size=4)
    got16, _ = sched.run(reqs16)
    got5, _ = sched.run(reqs5)
    want16, _ = je.scheduler(chunk_size=4).run(j_requests(reqs16))
    want5, _ = je.scheduler(chunk_size=4).run(j_requests(reqs5))
    fresh = ServeEngine(model=te.model, params=te.params, max_len=24, batch_slots=2,
                        device="cpu")
    again, _ = fresh.scheduler(chunk_size=4).run(reqs5)
    for i in range(2):
        assert got16[i].tokens == want16[i].tokens
        assert got5[i].tokens == want5[i].tokens == again[i].tokens
    with pytest.raises(ValueError, match="one encoder shape per run"):
        sched.run([reqs16[0], reqs5[1]])
    for s, r in ((te, Request(0, np.arange(4), 2, enc=encode(1, s_enc=17))),
                 (je, JRequest(0, np.arange(4), 2, enc=jnp.asarray(encode(1, s_enc=17))))):
        with pytest.raises(ValueError, match="enc_len=16"):
            s.scheduler(chunk_size=4).run([r])


def test_validation_matches_reference():
    """``test_encdec_one_shot_admission_raises`` and
    ``test_encdec_requests_require_enc``: both packages' errors."""
    je, te = engines(max_len=16, batch_slots=1)
    for eng in (je, te):
        with pytest.raises(ValueError, match="chunked admission.*chunk_size"):
            eng.scheduler()
    with pytest.raises(ValueError, match="encoder output"):
        te.scheduler(chunk_size=3).run([Request(rid=0, prompt=np.arange(4), max_new=2)])
    with pytest.raises(ValueError, match="encoder output"):
        je.scheduler(chunk_size=3).run([JRequest(rid=0, prompt=np.arange(4), max_new=2)])
    with pytest.raises(ValueError, match=r"enc must be \(S_enc, D\)"):
        te.scheduler(chunk_size=3).run([Request(0, np.arange(4), 2, enc=np.zeros((2, 3, 64)))])


def test_reference_failures_are_pinned():
    """What the reference does with whisper where the port refuses loudly
    (ROADMAP.md section 3): int8 weights fail at the reference's first step
    with ``TypeError`` (its ``pos_embed`` table becomes a ``QTensor``) and
    at the port's construction; lockstep ``generate()`` and restart batching
    without an encoder output crash with ``AttributeError`` in the
    reference and raise ``ValueError`` in the port."""
    jm, jp, tm, tp, _ = whisper()
    reqs = workload(n=1)
    jw = JServeEngine(model=jm, params=jp, max_len=24, batch_slots=2, weight_quant=True)
    with pytest.raises(TypeError, match="take requires ndarray"):
        jw.scheduler(chunk_size=4).run(j_requests(reqs))
    with pytest.raises(ValueError, match="weight_quant='int4' on an EncDec model"):
        ServeEngine(model=tm, params=tp, max_len=24, batch_slots=2, weight_quant="int4",
                    device="cpu")
    je, te = engines()
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):
        je.generate(jnp.asarray(prompts), 3)
    with pytest.raises(ValueError, match="needs enc"):
        te.generate(prompts, 3)
    plain = [Request(0, np.arange(4), 3)]
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):
        j_restart(je, j_requests(plain))
    with pytest.raises(ValueError, match="cannot serve an EncDec model"):
        run_restart_batching(te, plain)


@pytest.mark.parametrize("policy,ref_err,ref_match,port_match", [
    ("chunked", ValueError, "needs the request's encoder output", None),
    ("ragged", ValueError, "needs the request's encoder output", None),
    ("scheduler", ValueError, "requires chunked admission", None),
    ("restart", AttributeError, "has no attribute 'shape'", "cannot serve an EncDec model"),
    ("lockstep", AttributeError, "has no attribute 'shape'", "needs enc")])
def test_launch_serve_ends_as_the_reference_does(policy, ref_err, ref_match, port_match):
    """``launch.serve --arch whisper-tiny-smoke``: the workload carries no
    encoder output, so no policy serves it, in either package; the
    scheduler policies raise the same ``ValueError``, restart and lockstep
    the port's ``ValueError`` where the reference crashes."""
    argv = ["--arch", "whisper-tiny-smoke", "--policy", policy, "--requests", "2",
            "--slots", "2", "--prompt-len", "6", "--max-new", "3", "--chunk-size", "4"]
    with pytest.raises(ref_err, match=ref_match):
        j_launch.main(argv)
    with pytest.raises(ValueError, match=port_match or ref_match):
        t_launch.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="on an EncDec model"):
        t_launch.main(argv + ["--device", "cpu", "--wq"])
