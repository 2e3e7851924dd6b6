"""The int8 gradient all-reduce and GPipe of ``repro_torch.dist`` against
``repro.dist``, over gloo ranks on the CPU.

One launch of the ranks per world size (2 and 4, ``torchrun
--standalone``, a thread a rank) computes every case; the tests read the
ranks' results.  The reference runs in this process: ``compressed_psum_mean``
and ``compressed_grad_allreduce`` under ``jax.vmap(..., axis_name="data")``,
where ``pmax`` and ``psum`` reduce over the mapped axis, from the same
per-rank numpy arrays.

* every rank's mean and new error equal the reference's bit for bit, and
  all ranks' means are equal; the bounds of
  ``tests/test_dist.py::test_int8_gradient_compression_allreduce`` (within
  one grid step of the exact mean, the residual within one step);
* error feedback over 20 steps, bit for bit at every step, and the
  cumulative relative error < 0.02 of
  ``tests/test_dist.py::test_error_feedback_converges``;
* an all-zero leaf (the exponent clamps at ``N_MAX``), leaves at 2^20 (n =
  -13) and at 2^40 (clamped at ``N_MIN``), a tree of leaves on their own
  grids, 4 and 16 bits;
* GPipe over 4 stages and 8 microbatches of (2, 16), ``tanh(x @ W)``:
  bit for bit the port's sequential composition on every rank, and within
  rtol 2e-5 of the reference's jnp composition (its test's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_ranks import launch
from repro.dist.compress import compressed_grad_allreduce as j_tree
from repro.dist.compress import compressed_psum_mean as j_single
from repro_torch.core.qformat import N_MIN, exp2

WORLDS = (2, 4)


def _cases(world: int) -> dict:
    """name -> dict(g={leaf: (world, ...)}, e=None or {leaf: ...}, bits,
    steps, single)."""
    rng = np.random.default_rng(world)
    f32 = np.float32
    return {
        "int8": dict(g={"g": (rng.normal(size=(world, 64)) * 0.01).astype(f32)},
                     e={"g": np.zeros((world, 64), f32)}, bits=8, steps=1, single=True),
        "int8 no error": dict(g={"g": (rng.normal(size=(world, 5, 7)) * 3).astype(f32)},
                              e=None, bits=8, steps=1, single=True),
        "feedback": dict(g={"w": rng.normal(size=(world, 32)).astype(f32)},
                         e={"w": np.zeros((world, 32), f32)}, bits=8, steps=20, single=False),
        "zeros": dict(g={"z": np.zeros((world, 16), f32)}, e=None, bits=8, steps=2,
                      single=True),
        "at 2^20": dict(g={"h": (rng.uniform(-1, 1, size=(world, 16)) * 2.0 ** 20).astype(f32)},
                        e=None, bits=8, steps=2, single=True),
        "at 2^40": dict(g={"h": (rng.uniform(-1, 1, size=(world, 16)) * 2.0 ** 40).astype(f32)},
                        e=None, bits=8, steps=2, single=True),
        "tree": dict(g={"a": (rng.normal(size=(world, 3, 4)) * 1e-3).astype(f32),
                        "b": (rng.normal(size=(world, 9)) * 40).astype(f32),
                        "c": np.zeros((world, 2), f32)},
                     e={"a": (rng.normal(size=(world, 3, 4)) * 1e-5).astype(f32),
                        "b": (rng.normal(size=(world, 9)) * 0.1).astype(f32),
                        "c": np.zeros((world, 2), f32)}, bits=8, steps=3, single=False),
        "int4": dict(g={"w": rng.normal(size=(world, 40)).astype(f32)}, e=None, bits=4,
                     steps=3, single=False),
        "int16": dict(g={"w": (rng.normal(size=(world, 40)) * 1e-2).astype(f32)}, e=None,
                      bits=16, steps=3, single=False),
    }


def _pipe_inputs():
    """``tests/test_dist.py:96-121``'s weights and microbatches."""
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    keys = jax.random.split(jax.random.PRNGKey(0), n_stages)
    ws = jnp.stack([jax.random.normal(k, (d, d)) / np.sqrt(d) for k in keys])
    x = jax.random.normal(jax.random.PRNGKey(1), (n_micro, mb, d))
    return np.asarray(ws), np.asarray(x)


def _reference(case) -> tuple:
    """The reference's means and errors of every step, (steps, world, ...)
    a leaf."""
    names = sorted(case["g"])
    g = {n: jnp.asarray(case["g"][n]) for n in names}
    e = None if case["e"] is None else {n: jnp.asarray(case["e"][n]) for n in names}
    bits = case["bits"]
    single = jax.vmap(lambda a: j_single(a, "data", bits=bits), axis_name="data")
    single_e = jax.vmap(lambda a, b: j_single(a, "data", bits=bits, error=b), axis_name="data")
    tree = jax.vmap(lambda a, b: j_tree(a, "data", bits=bits, error_state=b), axis_name="data")
    means, errs = {n: [] for n in names}, {n: [] for n in names}
    for _ in range(case["steps"]):
        if case["single"]:
            (n,) = names
            m, ne = single(g[n]) if e is None else single_e(g[n], e[n])
            m, e = {n: m}, {n: ne}
        else:
            m, e = tree(g, e)
        for n in names:
            means[n].append(np.asarray(m[n]))
            errs[n].append(np.asarray(e[n]))
    return ({n: np.stack(v) for n, v in means.items()},
            {n: np.stack(v) for n, v in errs.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (cases, the ranks' results)."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"compress_w{world}")
        cases = _cases(world)
        inputs = {}
        for name, c in cases.items():
            key = name.replace(" ", "_")
            inputs.update({f"{key}/g/{n}": v for n, v in c["g"].items()})
            if c["e"] is not None:
                inputs.update({f"{key}/e/{n}": v for n, v in c["e"].items()})
            inputs.update({f"{key}/bits": c["bits"], f"{key}/steps": c["steps"],
                           f"{key}/single": c["single"]})
        if world == 4:
            inputs["pipe/Ws"], inputs["pipe/x"] = _pipe_inputs()
        np.savez(d / "inputs.npz", **inputs)
        out[world] = (cases, launch(world, "compress", d / "inputs.npz", d))
    return out


def _got(ranks, name, what, leaf):
    """(steps, world, ...) of one case's output, stacked over the ranks."""
    key = name.replace(" ", "_")
    return np.stack([r[f"{key}/{what}/{leaf}"] for r in ranks], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(_cases(2)))
def test_compressed_mean_and_error_equal_the_reference_bit_for_bit(runs, world, name):
    cases, ranks = runs[world]
    case = cases[name]
    want_m, want_e = _reference(case)
    for leaf in case["g"]:
        got_m, got_e = _got(ranks, name, "mean", leaf), _got(ranks, name, "err", leaf)
        assert got_m.dtype == want_m[leaf].dtype == np.float32
        np.testing.assert_array_equal(got_m, want_m[leaf])
        np.testing.assert_array_equal(got_e, want_e[leaf])
        # every rank holds the same mean
        np.testing.assert_array_equal(got_m, np.broadcast_to(got_m[:, :1], got_m.shape))


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_mean_within_one_grid_step(runs, world):
    """``test_int8_gradient_compression_allreduce``'s bounds."""
    cases, ranks = runs[world]
    g = cases["int8"]["g"]["g"]
    mean = _got(ranks, "int8", "mean", "g")[0]
    err = _got(ranks, "int8", "err", "g")[0]
    exact = g.sum(0, dtype=np.float32) / np.float32(world)
    step = float(np.abs(g).max()) / 2 ** 6
    assert float(np.abs(mean - exact).max()) < step
    assert np.all(np.abs(err) <= step)


@pytest.mark.parametrize("world", WORLDS)
def test_error_feedback_converges(runs, world):
    """``test_error_feedback_converges``: over 20 steps of one gradient the
    cumulative compressed mean tracks the cumulative exact mean."""
    cases, ranks = runs[world]
    g = cases["feedback"]["g"]["w"]
    means = _got(ranks, "feedback", "mean", "w")            # (20, world, 32)
    tot_c = means.astype(np.float64).sum(0)
    tot_x = 20 * (g.sum(0, dtype=np.float32) / np.float32(world)).astype(np.float64)
    rel = np.abs(tot_c - tot_x).mean() / (np.abs(tot_x).mean() + 1e-9)
    assert rel < 0.02, rel


@pytest.mark.parametrize("world", WORLDS)
def test_edge_leaves_clamp_their_exponent(runs, world):
    """An all-zero leaf sits at N_MAX: mean and error zero.  Values near 2^40
    put the exponent below N_MIN = -30 (a leaf at 2^20 takes n = -13 or -14,
    inside the clamp): at n = N_MIN the 8-bit codes saturate at -128 / 127
    on the grid step 2^30 and the error carries the rest."""
    cases, ranks = runs[world]
    assert not _got(ranks, "zeros", "mean", "z").any()
    assert not _got(ranks, "zeros", "err", "z").any()
    v = cases["at 2^40"]["g"]["h"]
    # the reference's float32 exp2 (the port's table), not the exact powers
    up, down = np.float32(exp2(N_MIN)), np.float32(exp2(-N_MIN))
    q = np.clip(np.trunc(v * up), -128, 127).astype(np.float32)
    assert (q == 127).any() and (q == -128).any()
    want_mean = q.sum(0, dtype=np.float32) * down / np.float32(world)
    np.testing.assert_array_equal(_got(ranks, "at 2^40", "mean", "h")[0],
                                  np.broadcast_to(want_mean, v.shape))
    np.testing.assert_array_equal(_got(ranks, "at 2^40", "err", "h")[0], v - q * down)


def test_gpipe_equals_the_sequential_composition(runs):
    """4 stages, 8 microbatches of (2, 16): every rank's output is the
    port's sequential composition bit for bit, and the reference's jnp
    composition within its test's rtol 2e-5."""
    _, ranks = runs[4]
    seq = ranks[0]["pipe/seq"]
    for r in ranks:
        np.testing.assert_array_equal(r["pipe/y"], seq)
    ws, x = _pipe_inputs()
    ref = jnp.asarray(x)
    for i in range(ws.shape[0]):
        ref = jax.vmap(lambda xb, w=jnp.asarray(ws[i]): jnp.tanh(xb @ w))(ref)
    np.testing.assert_allclose(seq, np.asarray(ref), rtol=2e-5, atol=2e-5)
