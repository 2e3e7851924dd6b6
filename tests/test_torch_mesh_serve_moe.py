"""The MoE archs served under a (2, 2) mesh (four gloo ranks on the CPU,
int8 weights and an int8 KV cache, 4 slots, 2 a data rank), and sampling
at temperature 0.7.

Every slot's decode token, a chunk's tokens and a ragged tick's flat batch
compete for an expert's capacity, so the mesh's MoE routes the one
device's tokens as the one device does (the weight-stationary dispatch
over ``Context.rows``): greedy streams under ``chunked`` and ``ragged``
(dense and paged) equal the port's one-device run, request for request.
Under ``chunked_paged`` an idle slot's decode row reads pool page 0
through its unmapped entries, and that row competes for capacity too: the
ranks read the one device's page 0 (data rank 0's, mirrored on the
others: ``nn/attention.py`` ``PageZero``), so those streams equal the one
device's as well, and the ranks agree.  At temperature 0.7 every rank
draws every row from one generator over the gathered logit rows: the
ranks' streams are identical
(the scheduler's policies and ``generate()``), every request ends
``ok``, and the draws are the port's one device's.
"""
import numpy as np
import pytest

from _torch_dist_ranks import launch

RANKS = range(4)
ARCHS = {"phi": ("phi3.5-moe-42b-a6.6b-smoke", ["scheduler", "chunked", "chunked_paged",
                                                "ragged", "ragged_paged"]),
         "kimi": ("kimi-k2-1t-a32b-smoke", ["chunked", "ragged"])}
#: the cases the ranks are also held equal to each other on
AGREE_ONLY = {"phi": ["chunked_paged"]}
SAMPLED = ["scheduler", "chunked", "ragged_paged"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_moe")
    rng = np.random.default_rng(11)
    plens, max_new = [6, 10, 7, 9, 5, 8], [5, 7, 6, 4, 7, 5]
    prompts = np.full((len(plens), max(plens)), -1, np.int32)
    for i, p in enumerate(plens):
        prompts[i, :p] = rng.integers(1, 500, size=p)
    inputs = {"req/rids": np.arange(len(plens)), "req/prompts": prompts,
              "req/plens": np.array(plens), "req/max_new": np.array(max_new),
              "req/arrival": np.array([0, 0, 1, 1, 3, 4]), "sampled": np.array(",".join(SAMPLED))}
    for name, (arch, policies) in ARCHS.items():
        inputs[f"arch/{name}"] = np.array(arch)
        inputs[f"policies/{name}"] = np.array(",".join(dict.fromkeys(
            policies + AGREE_ONLY.get(name, []))))
    np.savez(d / "inputs.npz", **inputs)
    return launch(4, "mesh_moe", d / "inputs.npz", d)


CASES = [(a, p) for a, (_, ps) in ARCHS.items() for p in ps]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("arch,policy", CASES)
def test_moe_streams_equal_the_ports_one_device(runs, arch, policy, rank):
    got = runs[rank][f"{arch}/{policy}/mesh"]
    np.testing.assert_array_equal(got, runs[rank][f"{arch}/{policy}/one"])
    assert (got[:, -1] == 0).all()


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("arch,policy", CASES)
def test_every_decode_row_is_the_one_devices(runs, arch, policy, rank):
    """Every decode step's logit rows, the idle slots' too, are the one
    device's rows of this rank's slots.  An idle row is never sampled, but
    it competes for expert capacity; under ``chunked_paged`` it reads pool
    page 0 through its unmapped entries, which the mirror makes the one
    device's page on every rank.  The sums over ``data`` add the experts'
    partial products in another order, hence the tolerance."""
    r = runs[rank]
    got, one = r[f"{arch}/{policy}/mesh/rows"], r[f"{arch}/{policy}/one/rows"]
    n = one.shape[1] // 2
    d = rank // 2
    np.testing.assert_allclose(got, one[:, d * n:(d + 1) * n], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,policy", [(a, p) for a, ps in AGREE_ONLY.items() for p in ps])
def test_moe_paged_chunked_ranks_agree(runs, arch, policy):
    got = [r[f"{arch}/{policy}/mesh"] for r in runs]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert (got[0][:, -1] == 0).all()


@pytest.mark.parametrize("arch,policy", CASES)
def test_moe_ticks_sum_activations_over_data_and_read_once(runs, arch, policy):
    """The weight-stationary MoE sums partial products over ``data`` (two
    sums a layer a forward, the same on every rank) and moves no expert
    weight over it; the host reads once a tick."""
    for r in runs:
        ticks = int(r[f"{arch}/{policy}/ticks"])
        assert int(r[f"{arch}/{policy}/calls/data/host"][0]) == ticks
        assert int(r[f"{arch}/{policy}/calls/data/psum"][0]) > 0
    for key in ("psum", "gather"):
        assert len({tuple(r[f"{arch}/{policy}/calls/data/{key}"]) for r in runs}) == 1


@pytest.mark.parametrize("policy", SAMPLED + ["lockstep"])
def test_temperature_sampling_ranks_agree(runs, policy):
    got = [r[f"sampled/{policy}/mesh"] for r in runs]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    if policy != "lockstep":
        assert (got[0][:, -1] == 0).all()
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("policy", SAMPLED + ["lockstep"])
def test_temperature_sampling_draws_the_one_devices_tokens(runs, policy):
    """Every row is drawn from the gathered logit rows with one generator,
    in the one device's order and calls, so the draws are its draws."""
    np.testing.assert_array_equal(runs[0][f"sampled/{policy}/mesh"],
                                  runs[0][f"sampled/{policy}/one"])


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("policy", SAMPLED)
def test_eos_decisions_follow_the_gathered_tokens(runs, policy, rank):
    """With an ``eos_id`` each host reads the tick's gathered tokens and
    evicts and refills as the one device does: the same streams, cut at
    the same EOS."""
    r = runs[rank]
    np.testing.assert_array_equal(r[f"eos/{policy}/mesh"], r[f"eos/{policy}/one"])
    np.testing.assert_array_equal(r[f"eos/{policy}/mesh/flags"], r[f"eos/{policy}/one/flags"])
    assert r[f"eos/{policy}/mesh/flags"].any()
