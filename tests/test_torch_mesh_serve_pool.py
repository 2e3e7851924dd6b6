"""The page pool's features under a (2, 2) mesh: four gloo ranks on the
CPU, smollm-135m-smoke with 4 slots (2 a data rank), page 4, chunk 4, an
int8 KV cache and float or int8 weights, against the reference's
one-device scheduler on the same requests, pool and policy.

Cases (``_torch_dist_ranks.POOL_CASES``): oversubscription at half the
dense-parity pool (16 pages, 8 a data rank's block) under ``chunked`` and
``ragged`` paged, recompute and swap, on requests that run each block dry;
forced preemptions of one victim on each data rank, recompute and swap; a
2-page shared prefix whose sharers land on both data ranks.  Every rank's
streams and statuses equal the reference's; every page a slot maps lies in
its data rank's block; every rank's counters are the same.  A block is a
rank's own, so where pages lie can change some counters against one
device (``ROADMAP.md`` §3 pins them): the ``light`` load (no block runs
dry) and the ``local`` prefix (every sharer on the prefix's rank) hold
them equal to the reference's.

The reference runs once in a subprocess (``PRNGKey(0)`` params, saved for
the ranks), then one ``torchrun`` launch of the ``mesh_pool`` suite.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist_ranks import COUNTERS, MESH_MAX_LEN, MESH_SLOTS, POOL_CASES, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = range(4)
#: the counters where a rank's block may differ from one device's pool
#: (``ROADMAP.md`` §3), held equal on the contained loads only
PLACED = ("page_stalls", "preemptions", "resumes", "swapped_pages", "resume_stalls",
          "prefix_hits", "shared_pages_mapped", "grown_pages", "peak_pages_in_use",
          "prefill_chunks", "decode_steps", "occupancy", "page_occupancy", "p50_latency_steps",
          "p99_latency_steps", "p50_ttft_steps", "p99_ttft_steps")
#: the counters a rank's cache changes (its own slots' bytes), or the
#: reference lacks
UNSHARED = ("peak_cache_bytes", "audit_reads")
CONTAINED = ("oversub/light", "prefix/local")

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.registry import get_config
from repro.serve import FaultPlan, Request, ServeEngine

def flat(tree, prefix, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {f"{prefix}/{path}": np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix, f"{path}.{k}" if path else str(k)))
    return out

def requests(d, prefix):
    return [Request(rid=int(r), prompt=d[prefix + "/prompts"][i, :d[prefix + "/plens"][i]],
                    max_new=int(d[prefix + "/max_new"][i]), arrival=int(d[prefix + "/arrival"][i]))
            for i, r in enumerate(d[prefix + "/rids"])]

def run_kwargs(kw):
    out = {}
    if "preempts" in kw:
        out["preempts"] = {int(r): int(t) for r, t in kw["preempts"]}
    if "fault_plan" in kw:
        out["fault_plan"] = FaultPlan.from_json(kw["fault_plan"])
    return out

d = dict(np.load(sys.argv[1]))
cases, slots, max_len, temperature = json.loads(sys.argv[3])
model = get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
params = model.init(jax.random.PRNGKey(0))
out = flat(params, "params")
for name, (rq, wq, eng_kw, sched_kw, run_kw) in cases.items():
    reqs = requests(d, rq)
    eng = ServeEngine(model=model, params=params, max_len=max_len, batch_slots=slots,
                      quantized_kv=True, weight_quant=wq, temperature=temperature, **eng_kw)
    res, stats = eng.scheduler(**sched_kw).run(reqs, warmup=False, **run_kwargs(run_kw))
    width = max(r.max_new for r in reqs)
    toks = np.full((len(reqs), width), -1, np.int64)
    for i, r in enumerate(reqs):
        toks[i, :len(res[r.rid].tokens)] = res[r.rid].tokens
    out[f"{name}/tokens"] = toks
    out[f"{name}/status"] = np.array([res[r.rid].status for r in reqs])
    out[f"{name}/summary"] = np.array(json.dumps(stats.summary()))
np.savez(sys.argv[2], **out)
print("reference ok")
"""


def request_arrays(prefix, plens, max_new, arrival, seed, shared=None):
    """Requests as arrays; ``shared[i]`` puts one 8-token prefix (2 pages)
    in front of request i's own tokens."""
    rng = np.random.default_rng(seed)
    head = np.random.default_rng(99).integers(1, 500, size=8)
    prompts = np.full((len(plens), max(plens)), -1, np.int32)
    for i, p in enumerate(plens):
        prompts[i, :p] = rng.integers(1, 500, size=p)
        if shared is not None and shared[i]:
            prompts[i, :8] = head
    return {f"{prefix}/rids": np.arange(len(plens)), f"{prefix}/prompts": prompts,
            f"{prefix}/plens": np.array(plens), f"{prefix}/max_new": np.array(max_new),
            f"{prefix}/arrival": np.array(arrival)}


#: the workloads of the cases (``POOL_CASES``' first field)
WORKLOADS = {
    "base": ([5, 11, 7, 9, 13, 6], [6, 8, 5, 7, 6, 8], [0, 0, 1, 2, 2, 5], 1, None),
    # 6 requests of 6-10 + 12-20 tokens: two slots of a block grow past its 8 pages
    "grow": ([8, 9, 7, 10, 6, 8], [18, 16, 20, 14, 18, 12], [0] * 6, 2, None),
    "light": ([5, 7, 6, 5, 6, 7], [5, 6, 7, 5, 6, 5], [0, 0, 0, 0, 12, 13], 3, None),
    # slots 0-1 are data rank 0's, 2-3 data rank 1's: rid 0 (slot 0) holds
    # the prefix; rid 1 (slot 1) shares it; rids 2 and 3 (slots 2, 3) share
    # it on data rank 1, where the first of them prefills it again
    "split": ([11, 10, 12, 9, 7], [7, 6, 8, 6, 5], [0, 3, 3, 3, 4], 4, [1, 1, 1, 1, 0]),
    "local": ([11, 10, 7, 9, 6], [7, 6, 8, 6, 5], [0, 3, 3, 3, 4], 5, [1, 1, 0, 0, 0]),
}


def reference_runs(tmp_path_factory, name, cases, workloads, *, temperature=0.0):
    """The reference's one-device runs of ``cases`` in a subprocess and the
    ranks' inputs (requests and the reference's params): (reference
    arrays, the inputs' path, the directory)."""
    d = tmp_path_factory.mktemp(name)
    inputs = {}
    for key, (plens, max_new, arrival, seed, shared) in workloads.items():
        inputs.update(request_arrays(key, plens, max_new, arrival, seed, shared))
    np.savez(d / "requests.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(d / "requests.npz"), str(d / "reference.npz"),
                        json.dumps([cases, MESH_SLOTS, MESH_MAX_LEN, temperature])],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = dict(np.load(d / "reference.npz"))
    np.savez(d / "inputs.npz", **inputs, **{k: v for k, v in ref.items()
                                              if k.startswith("params/")})
    return ref, d / "inputs.npz", d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, inputs, d = reference_runs(tmp_path_factory, "mesh_pool", POOL_CASES, WORKLOADS)
    return ref, launch(4, "mesh_pool", inputs, d)


def reference_counters(ref, name):
    summary = json.loads(str(ref[f"{name}/summary"]))
    return {k: summary[k] for k in COUNTERS if k in summary}


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_streams_equal_the_reference_one_device(runs, case, rank):
    from repro_torch.serve.scheduler import STATUSES

    ref, ranks = runs
    got = ranks[rank][f"{case}/streams"]
    np.testing.assert_array_equal(got[:, :-1], ref[f"{case}/tokens"])
    assert [STATUSES[s] for s in got[:, -1]] == list(ref[f"{case}/status"])


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_every_rank_counts_the_same(runs, case):
    _, ranks = runs
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case}/counters"], ranks[0][f"{case}/counters"])


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_mapped_pages_lie_in_their_slots_block(runs, case):
    """Every page a slot's row or a growth maps is its data rank's, by
    local id on that rank; a rank writes no other rank's slot."""
    _, ranks = runs
    for r in ranks:
        d, n = int(r["data_rank"]), int(r[f"{case}/local_pages"])
        slots, rows, local = (r[f"{case}/page_slots"], r[f"{case}/page_rows"],
                              r[f"{case}/page_local"])
        assert len(slots) > 0
        assert ((slots // (MESH_SLOTS // 2)) == d).all()
        mapped = rows >= 0
        assert ((rows[mapped] // n) == d).all()
        np.testing.assert_array_equal(local[mapped], rows[mapped] - d * n)
        assert (local[~mapped] == -1).all()


@pytest.mark.parametrize("case", [c for c in POOL_CASES if c.startswith("oversub/")
                                  and c != "oversub/light"])
def test_oversubscribed_load_runs_each_block_dry(runs, case):
    """The ``grow`` load finds each data rank's block dry at least once and
    preempts; the reference preempts too."""
    ref, ranks = runs
    for r in ranks:
        assert set(r[f"{case}/dry_blocks"].tolist()) == {0, 1}
        assert r[f"{case}/counters"][COUNTERS.index("preemptions")] > 0
    assert reference_counters(ref, case)["preemptions"] > 0


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_counters_equal_the_reference_but_where_pages_lie(runs, case):
    """Every counter but those a block moves (``PLACED``) equals the
    reference's; on the contained loads those too."""
    ref, ranks = runs
    want = reference_counters(ref, case)
    got = dict(zip(COUNTERS, ranks[0][f"{case}/counters"]))
    skip = set(UNSHARED) | (set() if case in CONTAINED else set(PLACED))
    for k, v in want.items():
        if k not in skip:
            assert got[k] == pytest.approx(v, abs=1e-4), (case, k)


def test_the_split_prefix_is_prefilled_again_on_the_other_rank(runs):
    """One device maps the prefix into rids 1, 2 and 3; the mesh into rid 1
    (data rank 0) and rid 3 (data rank 1, from rid 2's copy): one hit less,
    one prompt prefilled whole again."""
    ref, ranks = runs
    want = reference_counters(ref, "prefix/split")
    got = dict(zip(COUNTERS, ranks[0]["prefix/split/counters"]))
    assert (want["prefix_hits"], got["prefix_hits"]) == (3, 2)
    assert (want["shared_pages_mapped"], got["shared_pages_mapped"]) == (6, 4)


def test_forced_preemptions_take_one_victim_on_each_data_rank(runs):
    ref, ranks = runs
    for case in ("preempts/recompute", "preempts/swap"):
        want = reference_counters(ref, case)
        assert want["preemptions"] == 2
        for r in ranks:
            got = dict(zip(COUNTERS, r[f"{case}/counters"]))
            assert got["preemptions"] == 2
            assert got["resumes"] == (2 if case.endswith("swap") else 0)


def test_page_zero_mirror_refreshes_only_on_some_ticks(runs):
    """Under ``chunked`` over a paged pool the ranks broadcast data rank
    0's page 0, a layer at a time, only on the ticks that may have written
    it; the ragged tick reads no unmapped entry and never does."""
    _, ranks = runs
    for r in ranks:
        layers = int(r["layers"])
        for case in POOL_CASES:
            ticks = int(r[f"{case}/counters"][COUNTERS.index("decode_steps")])
            calls = int(r[f"{case}/calls/data/page0"][0]) if f"{case}/calls/data/page0" in r \
                else 0
            assert int(r[f"{case}/calls/data/host"][0]) == ticks
            if "ragged" in case:
                assert calls == 0
            else:
                assert calls % layers == 0 and 0 < calls < layers * ticks, (case, calls, ticks)


def test_a_ragged_ticks_local_addressing_is_int32():
    """A data rank's share of a ragged tick goes up to the card in one
    int32 array (the kernels take int32 slot ids and positions only): every
    array ``localize_ragged_tick`` adds is int32."""
    from repro_torch.serve.lanes import RaggedTick, localize_ragged_tick
    from repro_torch.serve.slot_state import SlotShard

    b, lanes, c = 8, 2, 4
    rt = RaggedTick(sids=np.zeros(b + lanes * c, np.int32),
                    poss=np.full(b + lanes * c, -1, np.int32),
                    ctok=np.zeros((lanes, c), np.int32), lrows=np.zeros(b + lanes, np.int32),
                    ran=[], stalled=0)
    for rank in (0, 1):
        loc = localize_ragged_tick(rt, [1, 5], SlotShard(rank, b // 2), nslots=b,
                                   n_lanes=lanes, chunk=c, pad_id=0)
        for name in ("select", "take", "owners", "sampled"):
            assert getattr(loc, name).dtype == np.int32, name
        np.testing.assert_array_equal(loc.sampled, np.r_[rank * 4 + np.arange(4), b, b + 1])
