"""Port parity for serving recurrent state (Mamba, RWKV-6): the analogues of
the recurrent tests of ``tests/test_slot_state.py``, each run through the
port's ``Scheduler`` and repro's on the reference's parameters carried over
by ``repro_torch.convert``, the greedy streams and tick timelines held
equal to the reference's own run:

* ``state_kinds`` by family (the hybrid jamba's ``("kv", "recurrent")``
  included; whisper's is in ``test_torch_encdec_serve.py``) and the
  ``state_kinds`` field of ``ServeStats``;
* per-slot state bytes constant in ``max_len`` and the cache bytes the
  report line prints;
* mamba serving equal to lockstep ``generate()``, float and int8 weights;
  rwkv serving; one-shot admission equal to chunked;
* EOS eviction and readmission (``test_ssm_eos_evicts_and_readmits``, red
  in the reference, see its port test below);
* forced preemption by recompute, audited;
* the validation ladder (ragged, prompt_bucket, paged);
* the every-tick auditor: a dead slot's recurrent row corrupted by one
  step raises the reference's ``AuditError`` at the end of that tick in
  both schedulers, and an audited tick makes one read-back;
* the launcher on ``mamba-130m-smoke`` and ``rwkv6-7b-smoke``, and the
  ``| state kv`` field of smollm's report line.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_launch
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import state_bytes_per_slot as j_state_bytes
from repro_torch.launch import serve as t_launch
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine, slot_state, state_bytes_per_slot, state_kinds
from test_torch_archs import smoke

torch.set_num_threads(2)
STAT_KEYS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
             "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
             "preemptions", "p50_ttft_steps", "p99_ttft_steps", "audited_ticks",
             "state_kinds", "completion_rate")

_engines = {}


def engines(arch, **kw):
    """Memoized (reference engine, port engine) on ``arch``-smoke's
    reference parameters; max_len 32 and 2 slots by default."""
    kw.setdefault("max_len", 32)
    kw.setdefault("batch_slots", 2)
    key = (arch, tuple(sorted(kw.items())))
    if key not in _engines:
        jm, jp, tm, tp, _ = smoke(arch)
        _engines[key] = (JServeEngine(model=jm, params=jp, **kw),
                         ServeEngine(model=tm, params=tp, device="cpu", **kw))
    return _engines[key]


def j_requests(reqs):
    return [JRequest(r.rid, np.asarray(r.prompt, np.int32), r.max_new, r.arrival)
            for r in reqs]


def both(arch, reqs, eng_kw=None, run_kw=None, **sched_kw):
    """((port results, stats), (reference results, stats)) of one workload."""
    je, te = engines(arch, **(eng_kw or {}))
    return (te.scheduler(**sched_kw).run(reqs, **(run_kw or {})),
            je.scheduler(**sched_kw).run(j_requests(reqs), **(run_kw or {})))


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


def test_state_kinds_by_family():
    assert state_kinds(smoke("smollm-135m")[2]) == ("kv",)
    assert state_kinds(smoke("mamba-130m")[2]) == ("recurrent",)
    assert state_kinds(smoke("rwkv6-7b")[2]) == ("recurrent",)
    assert [a.kind for a in slot_state.adapters_for(smoke("rwkv6-7b")[2])] == ["recurrent"]
    assert state_kinds(smoke("jamba-v0.1-52b")[2]) == ("kv", "recurrent")


def test_recurrent_bytes_per_slot_constant_in_length():
    """Recurrent state is O(1) per slot while a KV cache grows with max_len;
    the recurrent archs' per-kind bytes equal the reference's, and so do the
    cache bytes ``peak_cache_bytes`` reports (per-slot and lockstep)."""
    for arch in ("mamba-130m", "rwkv6-7b", "smollm-135m"):
        jm, _, tm, _, _ = smoke(arch)
        got, want = {}, {}
        for max_len in (32, 64):
            got[max_len] = state_bytes_per_slot(
                tm.init_cache(2, max_len, per_slot_len=True, device="meta"), 2)
            want[max_len] = j_state_bytes(
                jm.init_cache(2, max_len, per_slot_len=True, kv_dtype=jnp.float32), 2)
            if arch != "smollm-135m":
                # (a KV node's one ``len`` serves its stacked layers in the
                # port, one per layer in the reference)
                assert got[max_len] == want[max_len], (arch, max_len)
        if arch == "smollm-135m":
            assert got[64]["kv"] > 1.9 * got[32]["kv"] > 0 and got[32]["recurrent"] == 0
        else:
            assert got[32]["kv"] == got[64]["kv"] == 0
            assert got[32]["recurrent"] == got[64]["recurrent"] > 0
            je, te = engines(arch)
            assert te.cache_bytes() == je.cache_bytes()
            assert te.cache_bytes(per_slot=True) == sum(
                x.size * x.dtype.itemsize
                for x in jax.tree_util.tree_leaves(je.new_cache(per_slot=True)))


@pytest.mark.parametrize("weight_quant", [False, True], ids=["fp32", "int8w"])
def test_ssm_serving_token_identical_to_lockstep(weight_quant):
    """Staggered arrivals, more requests than slots, through the chunked
    loop: the reference's streams, which equal per-request lockstep
    ``generate()``."""
    cfg = get_config("mamba-130m-smoke")
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, size=(4, 8), dtype=np.int32)
    _, lock = engines("mamba-130m", batch_slots=4, weight_quant=weight_quant)
    base = lock.generate(prompts, 6).numpy()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=6, arrival=i) for i in range(4)]
    pair = both("mamba-130m", reqs, {"weight_quant": weight_quant}, chunk_size=4)
    assert_same(pair)
    (got, stats), _ = pair
    assert stats.state_kinds == "recurrent"
    for i in range(4):
        assert got[i].status == "ok" and got[i].tokens == base[i].tolist(), (weight_quant, i)


def test_rwkv_serving_token_identical_to_lockstep():
    cfg = get_config("rwkv6-7b-smoke")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 8), dtype=np.int32)
    _, te = engines("rwkv6-7b")
    base = te.generate(prompts, 6).numpy()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=6) for i in range(2)]
    pair = both("rwkv6-7b", reqs, chunk_size=4)
    assert_same(pair)
    (got, stats), _ = pair
    assert stats.state_kinds == "recurrent"
    for i in range(2):
        assert got[i].tokens == base[i].tolist(), i


def test_ssm_one_shot_admission_matches_chunked():
    """One-shot admission carries the recurrence through the batch-1 prefill
    and the scatter-admission walker."""
    cfg = get_config("mamba-130m-smoke")
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=6 + i), max_new=5)
            for i in range(3)]
    chunked = both("mamba-130m", reqs, chunk_size=3)
    one_shot = both("mamba-130m", reqs)
    assert_same(chunked)
    assert_same(one_shot)
    for i in range(3):
        assert one_shot[0][0][i].tokens == chunked[0][0][i].tokens, i


def test_ssm_eos_evicts_and_readmits():
    """EOS eviction zeroes the slot's recurrent rows, and the readmitted
    request decodes from fresh state: its stream is its solo stream under
    the same ``eos_id``.

    The reference's test of this name is red: its solo run has no
    ``eos_id``, and request 1's first token (86) is the EOS id (request 0's
    third token), so under ``eos_id`` request 1 rightly stops at once,
    streaming [86], the first token of its solo stream [86, 359, 386].
    Both schedulers stream [86]; this test holds that, the reference's run,
    and the no-EOS solo stream's first token."""
    cfg = get_config("mamba-130m-smoke")
    je, te = engines("mamba-130m", batch_slots=1)
    prompt = np.arange(8, dtype=np.int32) % cfg.vocab
    free_run, _ = te.scheduler(chunk_size=3).run([Request(rid=0, prompt=prompt, max_new=8)])
    eos = free_run[0].tokens[2]
    solo, _ = te.scheduler(chunk_size=3).run([Request(rid=1, prompt=prompt + 1, max_new=3)])
    solo_eos, _ = te.scheduler(eos_id=eos, chunk_size=3).run(
        [Request(rid=1, prompt=prompt + 1, max_new=3)])
    reqs = [Request(rid=0, prompt=prompt, max_new=8), Request(rid=1, prompt=prompt + 1, max_new=3)]
    pair = both("mamba-130m", reqs, {"batch_slots": 1}, eos_id=eos, chunk_size=3, audit=True)
    assert_same(pair)
    results = pair[0][0]
    assert results[0].eos is True and results[0].tokens[-1] == eos
    assert len(results[0].tokens) <= 3
    assert results[1].admitted_at >= results[0].finished_at
    assert results[1].tokens == solo_eos[1].tokens == solo[1].tokens[:len(results[1].tokens)]
    assert (eos, solo[1].tokens, results[1].tokens) == (86, [86, 359, 386], [86])


def test_ssm_forced_preemption_recompute_identity():
    """The ``preempts=`` drill mid-decode: the victim's recurrence is
    discarded, its continuation re-prefills prompt + tokens from zeros, and
    the greedy streams are unchanged."""
    cfg = get_config("mamba-130m-smoke")
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 8), dtype=np.int32)
    _, te = engines("mamba-130m")
    base = te.generate(prompts, 8).numpy()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=8) for i in range(2)]
    pair = both("mamba-130m", reqs, run_kw={"preempts": {0: 6}}, chunk_size=4, audit=True)
    assert_same(pair)
    (got, stats), _ = pair
    assert stats.preemptions >= 1 and stats.preempted_rids.get(0, 0) >= 1
    for i in range(2):
        assert got[i].status == "ok" and got[i].tokens == base[i].tolist(), i
    assert stats.audited_ticks > 0 and stats.audit_reads == stats.decode_steps


def test_recurrent_validation_ladder():
    """Unsupported recurrent combinations fail at construction with the
    reference's messages."""
    for eng in engines("mamba-130m"):
        with pytest.raises(ValueError, match="ragged") as a:
            eng.scheduler(chunk_size=4, ragged=True)
        assert "recurrence must consume its slot's tokens in order" in str(a.value)
        with pytest.raises(ValueError, match="prompt_bucket"):
            eng.scheduler(prompt_bucket=8)
    msgs = []
    for eng in engines("mamba-130m", paged_kv=True, page_size=8):
        with pytest.raises(ValueError, match="paged") as a:
            eng.scheduler(chunk_size=4)
        msgs.append(str(a.value))
    assert msgs[0] == msgs[1] and "no KV cache to page" in msgs[0]


@pytest.mark.parametrize("arch", ["mamba-130m", "rwkv6-7b"])
def test_dead_row_corruption_raises_in_its_own_tick(arch):
    """Slot 1 idles while slot 0 serves; one step's returned cache gets a
    nonzero value in slot 1's row of the mixer's ``h`` (``s``).  Under ``audit=True``
    both schedulers raise ``AuditError`` with the same message (down to the
    max |x|) at the end of that tick."""
    from repro.serve.audit import AuditError as JAuditError
    from repro_torch.serve.audit import AuditError

    cfg = get_config(arch + "-smoke")
    reqs = [Request(rid=0, prompt=np.arange(6, dtype=np.int32) % cfg.vocab, max_new=10)]
    je, te = engines(arch)
    raised = []
    for eng, rq, err, torch_side in ((te, reqs, AuditError, True),
                                     (je, j_requests(reqs), JAuditError, False)):
        sched = eng.scheduler(chunk_size=4, audit=True)
        box = {"t": None, "done": False}

        def corrupting(step, box=box, torch_side=torch_side, arch=arch):
            def wrapped(*a, **k):
                out = step(*a, **k)
                if box["done"] or box["t"] is None or box["t"] < 4:
                    return out
                box["done"] = True
                cache = out[-1]
                node = cache["body"][0]["ssm"]
                key = "h" if arch == "mamba-130m" else "s"
                # every layer's slot-1 row, one element (the layer axis leads)
                at = (slice(None), 1) + tuple(int(i) for i in np.unravel_index(
                    3, tuple(node[key].shape[2:])))
                if torch_side:
                    leaf = node[key].clone()
                    leaf[at] = 0.375
                else:
                    leaf = node[key].at[at].set(0.375)
                body = [dict(cache["body"][0], ssm=dict(node, **{key: leaf}))]
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
    assert raised[0][1].startswith("recurrent leaf ") and "dead slot 1" in raised[0][1]
    assert "max |x| = 0.375" in raised[0][1]


def _report(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [ln for ln in buf.getvalue().splitlines() if ln.startswith("[")]


@pytest.mark.parametrize("arch,policy", [("mamba-130m-smoke", "chunked"),
                                         ("rwkv6-7b-smoke", "scheduler"),
                                         ("smollm-135m-smoke", "chunked")])
def test_launch_serve_report_carries_state_kinds(arch, policy, monkeypatch):
    """``launch.serve`` on the recurrent archs (``--qkv`` taken and changing
    nothing, as in the reference) and on smollm: the report line carries
    ``| state recurrent`` / ``| state kv`` where the reference's does, and
    its stats (the cache bytes included) equal the reference's run (each
    package draws its own random weights: the schedule is compared, not the
    tokens)."""
    argv = ["--arch", arch, "--policy", policy, "--chunk-size", "4", "--slots", "2",
            "--prompt-len", "8", "--requests", "4", "--max-new", "6", "--wq", "--qkv",
            "--audit"]
    stats = []
    for mod in (t_launch, j_launch):
        real = mod.report
        monkeypatch.setattr(mod, "report", lambda name, st, real=real: (stats.append(st),
                                                                         real(name, st)))
    _, tlines = _report(lambda: t_launch.main(argv + ["--device", "cpu"]))
    _, jlines = _report(lambda: j_launch.main(argv))
    kinds = "kv" if arch.startswith("smollm") else "recurrent"
    for line in (tlines[-1], jlines[-1]):
        assert f"| state {kinds} | audited" in line, line
    gsum, wsum = stats[0].summary(), stats[1].summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key


def test_launch_serve_refuses_paged_and_ragged_for_recurrent_state():
    for extra in (["--policy", "chunked", "--paged"], ["--policy", "ragged"]):
        argv = ["--arch", "mamba-130m-smoke", "--slots", "2", "--prompt-len", "8",
                "--requests", "2", "--max-new", "4", "--chunk-size", "4"] + extra
        with pytest.raises(ValueError) as got:
            t_launch.main(argv + ["--device", "cpu"])
        with pytest.raises(ValueError) as want:
            j_launch.main(argv)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(6))
def test_check_recurrent_rows_agrees_with_reference(seed):
    """Both auditors on one seeded cache tree (a stacked mamba node and a
    stacked rwkv pair, 3 slots): dead rows left zero, or one to three dead
    (leaf, slot) rows given a value (a NaN in one draw); the same verdict
    and the same message, down to the max |x|."""
    from repro.serve.audit import AuditError as JAuditError
    from repro.serve.audit import check_recurrent_rows as j_check
    from repro_torch.serve.audit import AuditError, check_recurrent_rows

    rng = np.random.default_rng(seed)
    shapes = {"ssm": {"h": (2, 3, 4, 5), "conv": (2, 3, 3, 4)},
              "rwkv": {"s": (2, 3, 2, 4, 4), "shift": (2, 3, 1, 8)},
              "cm": {"shift": (2, 3, 1, 8)}}
    live = set(rng.choice(3, size=rng.integers(0, 3), replace=False).tolist())
    tree = {}
    for node, leaves_ in shapes.items():
        tree[node] = {}
        for k, shape in leaves_.items():
            a = rng.normal(0, 1, shape).astype(np.float32)
            for j in range(3):
                if j not in live:
                    a[:, j] = 0
            tree[node][k] = a
    dead = [j for j in range(3) if j not in live]
    for _ in range(rng.integers(0, 4) if dead else 0):
        node = list(shapes)[rng.integers(3)]
        k = list(shapes[node])[rng.integers(len(shapes[node]))]
        j = dead[rng.integers(len(dead))]
        flat = tree[node][k][:, j].reshape(-1).copy()
        flat[rng.integers(flat.size)] = np.nan if seed == 5 else rng.normal(0, 3)
        tree[node][k][:, j] = flat.reshape(tree[node][k][:, j].shape)
    # keys inserted sorted: the reference's scheduler hands its auditor jitted,
    # key-sorted trees, and walks plain dicts in insertion order
    cache = {"body": [{"ssm": dict(sorted(tree["ssm"].items()))},
                      {"cm": tree["cm"], "ssm": dict(sorted(tree["rwkv"].items()))}]}
    verdicts = []
    for check, err, conv in ((check_recurrent_rows, AuditError, torch.from_numpy),
                             (j_check, JAuditError, jnp.asarray)):
        conv_tree = {"body": [{n: {k: conv(v.copy()) for k, v in d.items()}
                               for n, d in layer.items()} for layer in cache["body"]]}
        try:
            check(conv_tree, live)
            verdicts.append(None)
        except err as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
