"""Port parity for serving the dense-family archs: the port's ``Scheduler``
against repro's on glm4-9b, qwen2.5-14b, command-r-plus-104b and
internvl2-2b at smoke size (internvl serves its text backbone, as the
reference does), int8 weights and an int8 KV cache, dense chunked and paged
chunked admission.  The greedy token streams, tick timelines and stats are
held equal, and the cache every step returns (K/V slabs or pools, lengths,
exponents, page tables) bit for bit, tick by tick.
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
from repro_torch.models.registry import get_config
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(2)
ARCHS = ["glm4-9b", "qwen2.5-14b", "command-r-plus-104b", "internvl2-2b"]
STAT_KEYS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps",
             "p99_latency_steps", "peak_cache_bytes", "prefill_chunks", "stalled_chunks",
             "page_stalls", "peak_pages_in_use", "peak_live_slots", "prefix_hits",
             "p50_ttft_steps", "p99_ttft_steps")


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


def snapshot(cache):
    """Each layer position's KV node as {key: numpy copy}."""
    return [{k: np.array(v, copy=True) for k, v in node["kv"].items()}
            for node in cache["body"]]


def recording(step, caches):
    """``step`` (a scheduler's masked step, its cache last in the output)
    that also appends a copy of each cache it returns to ``caches``."""
    def wrapped(*a, **k):
        out = step(*a, **k)
        caches.append(snapshot(out[-1]))
        return out
    return wrapped


def assert_same_cache(got, want):
    """The port's KV node against the reference's: the K/V slabs or pools
    equal; the port's one table, lens and exponents equal to every layer's
    copy in the reference's stacked node (the port keeps the frozen KV
    exponent as a host int: its value is held, not its dtype)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, wv in w.items():
            gv = g[key]
            if gv.shape != wv.shape:
                assert wv.shape[1:] == gv.shape, key
                wv = wv.reshape(-1, *gv.shape)
                for layer in wv:
                    np.testing.assert_array_equal(gv, layer, err_msg=key)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=key)
            if key not in ("k_n", "v_n"):
                assert gv.dtype == wv.dtype, key


def _workload(vocab, n=6, plen=12, max_new=8, spacing=1, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=plen, dtype=np.int32),
                    max_new=max_new if i % 2 == 0 else max_new - 3, arrival=i * spacing)
            for i in range(n)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_scheduler_matches_reference(arch, paged):
    jm = j_get_config(arch + "-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(arch + "-smoke")
    tm, tp = cfg.build(), params_from_numpy(to_numpy(jp), "cpu")
    kw = dict(max_len=24, batch_slots=3, weight_quant=True, quantized_kv=True)
    if paged:
        kw.update(paged_kv=True, page_size=8)
    je = JServeEngine(model=jm, params=jp, **kw)
    te = ServeEngine(model=tm, params=tp, device="cpu", **kw)
    reqs = _workload(cfg.vocab)
    runs = []
    for eng, rq in ((te, reqs), (je, [JRequest(r.rid, np.asarray(r.prompt, np.int32),
                                                r.max_new, r.arrival) for r in reqs])):
        sched = eng.scheduler(chunk_size=8)
        caches = []
        sched._masked_decode = recording(sched._masked_decode, caches)
        sched._masked_mixed = recording(sched._masked_mixed, caches)
        res, st = sched.run(rq, warmup=False)
        runs.append((res, st, caches))
    (g, gs, gc), (w, ws, wc) = runs
    assert sorted(g) == sorted(w) == [r.rid for r in reqs]
    for rid in w:
        assert g[rid].status == w[rid].status == "ok"
        assert g[rid].tokens == w[rid].tokens, rid
        assert (g[rid].admitted_at, g[rid].finished_at) == \
            (w[rid].admitted_at, w[rid].finished_at), rid
    gsum, wsum = gs.summary(), ws.summary()
    for key in STAT_KEYS:
        assert gsum[key] == wsum[key], key
    assert gs.prefill_chunks > 0 and len(gc) == len(wc) == gs.decode_steps
    for tick, (a, b) in enumerate(zip(gc, wc)):
        try:
            assert_same_cache(a, b)
        except AssertionError as e:
            raise AssertionError(f"tick {tick}: {e}") from None
