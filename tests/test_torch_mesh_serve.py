"""``ServeEngine`` and the scheduler's policies under a (2, 2) mesh: four
gloo ranks on the CPU, smollm-135m-smoke with 4 slots (2 a data rank), an
int8 KV cache and float or int8 weights, against the reference's
one-device scheduler, ``run_restart_batching`` and ``generate()``.

The reference runs once in a subprocess on one device (``PRNGKey(0)``
params, saved for the ranks), then one ``torchrun`` launch of
``_torch_dist_ranks.py``'s ``mesh_serve`` suite serves the same requests
on every rank.  Every rank's greedy token streams must equal the
reference's, request for request; each tick reads the host's values in one
gather over ``data``; a paged slot's pages lie in its data rank's block,
by local id in its table; and what a mesh does not serve yet raises.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist_ranks import MESH_MAX_LEN, MESH_POLICIES, MESH_SLOTS, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = range(4)
VARIANTS = ("float", "int8")

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.registry import get_config
from repro.serve import Request, ServeEngine, run_restart_batching

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

def streams(res, reqs):
    width = max(r.max_new for r in reqs)
    out = np.full((len(reqs), width), -1, np.int64)
    for i, r in enumerate(reqs):
        out[i, :len(res[r.rid].tokens)] = res[r.rid].tokens
    return out

d = dict(np.load(sys.argv[1]))
policies, slots, max_len = json.loads(sys.argv[3])
model = get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
params = model.init(jax.random.PRNGKey(0))
out = flat(params, "params")
reqs, rreqs = requests(d, "req"), requests(d, "rreq")
for label, wq in (("float", False), ("int8", True)):
    for name, (eng_kw, sched_kw) in policies.items():
        eng = ServeEngine(model=model, params=params, max_len=max_len, batch_slots=slots,
                          quantized_kv=True, weight_quant=wq, **eng_kw)
        res, _ = eng.scheduler(**sched_kw).run(reqs, warmup=False)
        out[f"{label}/{name}"] = streams(res, reqs)
    eng = ServeEngine(model=model, params=params, max_len=max_len, batch_slots=slots,
                      quantized_kv=True, weight_quant=wq)
    res, _ = run_restart_batching(eng, rreqs, warmup=False)
    out[f"{label}/restart"] = streams(res, rreqs)
    out[f"{label}/lockstep"] = np.asarray(eng.generate(jnp.asarray(d["lock/prompts"]),
                                                       int(d["lock/new"])))
    out[f"{label}/cache_bytes"] = np.array(ServeEngine(
        model=model, params=params, max_len=max_len, batch_slots=slots // 2,
        quantized_kv=True, weight_quant=wq).cache_bytes())
np.savez(sys.argv[2], **out)
print("reference ok")
"""


def _request_arrays(prefix, plens, max_new, arrival):
    rng = np.random.default_rng(len(prefix) + len(plens))
    prompts = np.full((len(plens), max(plens)), -1, np.int32)
    for i, p in enumerate(plens):
        prompts[i, :p] = rng.integers(1, 500, size=p)
    return {f"{prefix}/rids": np.arange(len(plens)), f"{prefix}/prompts": prompts,
            f"{prefix}/plens": np.array(plens), f"{prefix}/max_new": np.array(max_new),
            f"{prefix}/arrival": np.array(arrival)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    inputs = {**_request_arrays("req", [5, 11, 7, 9, 13, 6, 8], [6, 8, 5, 7, 6, 8, 4],
                                [0, 0, 1, 2, 2, 5, 6]),
              **_request_arrays("rreq", [8] * 5, [4, 7, 5, 6, 3], [0, 1, 1, 3, 9])}
    inputs["lock/prompts"] = np.random.default_rng(7).integers(
        1, 500, size=(MESH_SLOTS, 10)).astype(np.int32)
    inputs["lock/new"] = np.array(9)
    np.savez(d / "requests.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(d / "requests.npz"), str(d / "reference.npz"),
                        json.dumps([MESH_POLICIES, MESH_SLOTS, MESH_MAX_LEN])],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = dict(np.load(d / "reference.npz"))
    np.savez(d / "inputs.npz", **inputs, **{k: v for k, v in ref.items()
                                              if k.startswith("params/")})
    return ref, launch(4, "mesh_serve", d / "inputs.npz", d)


def _streams(got):
    """A rank's streams without the status column, and the statuses."""
    return got[:, :-1], got[:, -1]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("policy", list(MESH_POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_scheduler_streams_equal_the_reference_one_device(runs, variant, policy, rank):
    ref, ranks = runs
    toks, status = _streams(ranks[rank][f"{variant}/{policy}/streams"])
    np.testing.assert_array_equal(toks, ref[f"{variant}/{policy}"])
    assert (status == 0).all()


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_restart_batching_streams_equal_the_reference(runs, variant, rank):
    ref, ranks = runs
    toks, status = _streams(ranks[rank][f"{variant}/restart/streams"])
    np.testing.assert_array_equal(toks, ref[f"{variant}/restart"])
    assert (status == 0).all()


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_lockstep_generate_equals_the_reference(runs, variant, rank):
    ref, ranks = runs
    np.testing.assert_array_equal(ranks[rank][f"{variant}/lockstep/tokens"],
                                  ref[f"{variant}/lockstep"])


@pytest.mark.parametrize("policy", list(MESH_POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_one_host_read_gather_a_tick(runs, variant, policy):
    """Every rank reads the tick's sampled values in one gather over
    ``data`` (``shard_ops.gather_host``), and nothing else of the host's
    crosses ``model``."""
    _, ranks = runs
    for r in ranks:
        ticks = int(r[f"{variant}/{policy}/ticks"])
        assert ticks > 0
        assert int(r[f"{variant}/{policy}/calls/data/host"][0]) == ticks
        assert f"{variant}/{policy}/calls/model/host" not in r


@pytest.mark.parametrize("policy", [p for p, (e, _) in MESH_POLICIES.items() if e])
def test_paged_slots_take_pages_from_their_data_ranks_block(runs, policy):
    _, ranks = runs
    for r in ranks:
        d, n = int(r["data_rank"]), int(r[f"int8/{policy}/local_pages"])
        slots = r[f"int8/{policy}/page_slots"]
        rows, local = r[f"int8/{policy}/page_rows"], r[f"int8/{policy}/page_local"]
        assert len(slots) > 0
        assert ((slots // (MESH_SLOTS // 2)) == d).all()
        mapped = rows >= 0
        assert ((rows[mapped] // n) == d).all()
        np.testing.assert_array_equal(local[mapped], rows[mapped] - d * n)
        assert ((local[mapped] >= 0) & (local[mapped] < n)).all()
        assert (local[~mapped] == -1).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_cache_bytes_count_one_ranks_slots(runs, variant):
    """A rank's lockstep cache is the reference's of its 2 slots; its
    scheduler cache adds a length a slot."""
    ref, ranks = runs
    for r in ranks:
        lock, per_slot = (int(x) for x in r[f"{variant}/cache_bytes"])
        assert lock == int(ref[f"{variant}/cache_bytes"])
        assert per_slot > lock


@pytest.mark.parametrize("mode", ["recurrent", "jamba", "whisper", "embeds", "int4"])
def test_the_refused_modes_name_the_next_item(runs, mode):
    """What a mesh does not serve yet (a recurrent model, the hybrid
    jamba, the EncDec whisper, a VLM prefix, packed int4 weights) raises,
    naming the item that queues it."""
    _, ranks = runs
    for r in ranks:
        assert "ROADMAP.md queue 1, item 3b.7" in str(r[f"refused/{mode}"])
