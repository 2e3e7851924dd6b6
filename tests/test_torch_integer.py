"""Port parity for the integer engine's modules: Qm.n requantization and
alignment, fake-quantization, integerization, calibration (observers,
``ranges_to_qstate``), the ``Context`` and the layers' float, fake-quant
and integer paths, against repro on the same numpy inputs.

Integer results are held bit for bit; float ones at rtol 1e-5 (f32 sums in
another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integerize as j_int
from repro.core import observers as j_obs
from repro.core import ptq as j_ptq
from repro.core import qformat as jq
from repro.core.policy import Granularity as JG
from repro.core.policy import QMode as JM
from repro.core.policy import QuantPolicy as JP
from repro.nn import layers as jl
from repro.nn.module import Context as JC
from repro.nn.module import param_bytes as j_param_bytes
from repro.nn.module import param_count as j_param_count
from repro_torch.convert import params_from_numpy
from repro_torch.core import integerize as t_int
from repro_torch.core import observers as t_obs
from repro_torch.core import ptq as t_ptq
from repro_torch.core import qformat as tq
from repro_torch.core.policy import Granularity, QMode, QuantPolicy
from repro_torch.core.qformat import QTensor
from repro_torch.nn import layers as tl
from repro_torch.nn.module import Context, eval_context, param_bytes, param_count

torch.set_num_threads(2)
RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _policy_pair(mode, **kw):
    """The same policy in both packages."""
    jkw = dict(kw)
    if "granularity" in kw:
        jkw["granularity"] = JG(kw["granularity"].value)
    return JP(mode=JM(mode.value), **jkw), QuantPolicy(mode=mode, **kw)


# ---- requantize and align ---------------------------------------------------------

def _requant_both(acc, n_in, n_out, width):
    want = np.asarray(jq.requantize(jnp.asarray(acc, jnp.int32), jnp.asarray(n_in, jnp.int32),
                                    jnp.asarray(n_out, jnp.int32), width))
    got = tq.requantize(_t(np.asarray(acc, np.int32)), _t(np.asarray(n_in, np.int32)),
                        _t(np.asarray(n_out, np.int32)), width)
    assert got.dtype == tq.storage_dtype(width)
    return got.numpy(), want


@pytest.mark.parametrize("acc,n_in,n_out,width", [
    (-5, 1, 0, 8), (5, 1, 0, 8), (1000, 0, 4, 8), (-1000, 0, 4, 8), (2 ** 30, 0, 30, 8),
    (-(2 ** 30), 0, 30, 8), (3, 0, 4, 8), (-7, 2, 4, 16), (2 ** 31 - 1, 40, 0, 16),
    (-(2 ** 31) + 1, 0, 62, 8), (12345, 70, 3, 8), (1, -20, 50, 16)])
def test_requantize_edges_match_reference(acc, n_in, n_out, width):
    """The cases of test_qformat_edge.py plus shifts past the bit width:
    floors on the right, saturation before any overflow on the left."""
    got, want = _requant_both(acc, n_in, n_out, width)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [8, 16])
def test_requantize_random_matches_reference(width):
    """The property of test_properties.py: shifts in [-16, 16], accumulators
    within 2^20, scalar and per-channel exponents."""
    rng = np.random.default_rng(width)
    acc = rng.integers(-2 ** 20, 2 ** 20, (64, 12)).astype(np.int32)
    for n_in, n_out in ((rng.integers(-8, 9), rng.integers(-8, 9)) for _ in range(12)):
        np.testing.assert_array_equal(*_requant_both(acc, n_in, n_out, width))
    n_ch = rng.integers(-8, 9, (12,)).astype(np.int32)
    np.testing.assert_array_equal(*_requant_both(acc, n_ch, 3, width))


def test_requantize_saturates_int32_min_where_the_reference_wraps():
    """The reference works at "int64", which without jax's x64 mode is int32:
    at acc = -2^31 its |acc| wraps negative, the pre-saturation guard misses,
    and the left shift wraps to 0.  The port works in int64 as the
    reference's docstring says and saturates.  This is the only input where
    the two differ (every other |acc| <= lim check agrees)."""
    got, want = _requant_both(-(2 ** 31), 0, 2, 8)
    assert int(want) == 0
    assert int(got) == -128


@pytest.mark.parametrize("n_x,n_common", [(4, 8), (8, 4), (0, 0), (-4, 10), (3, 40),
                                          (40, 3), (0, 31), (0, 32)])
def test_align_matches_reference(n_x, n_common):
    """Left shifts (exact in range, wrapping past it, 0 from 32 on) and
    right shifts (floors, the sign fill from 32 on)."""
    q = np.asarray([-128, -3, -1, 0, 1, 7, 127], np.int8)
    want = np.asarray(jq.align(jnp.asarray(q), jnp.int32(n_x), jnp.int32(n_common)))
    got = tq.align(_t(q), torch.tensor(n_x, dtype=torch.int32),
                   torch.tensor(n_common, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_align_then_requantize_roundtrip():
    q = torch.tensor([-3, 0, 7], dtype=torch.int8)
    acc = tq.align(q, 4, 8)
    np.testing.assert_array_equal(acc.numpy(), [-48, 0, 112])
    np.testing.assert_array_equal(tq.requantize(acc, 8, 4, 8).numpy(), q.numpy())


def test_align_with_a_vector_exponent_matches_reference():
    rng = np.random.default_rng(7)
    q = rng.integers(-32768, 32768, (5, 6)).astype(np.int16)
    n_x, n_c = np.int32(3), rng.integers(-2, 12, (6,)).astype(np.int32)
    want = np.asarray(jq.align(jnp.asarray(q), jnp.asarray(n_x), jnp.asarray(n_c)))
    np.testing.assert_array_equal(tq.align(_t(q), _t(n_x), _t(n_c)).numpy(), want)


# ---- quantize_dequantize, quantize_tensor(n_override) -------------------------------

@pytest.mark.parametrize("width", [8, 9, 16])
def test_quantize_dequantize_matches_reference(width):
    rng = np.random.default_rng(width)
    x = rng.normal(0, 3, 2048).astype(np.float32)
    for n in (-20, -13, -2, 0, 5, 12, 13, 17, 20):
        xs = (x * np.float32(2.0 ** -n)).astype(np.float32)
        want = np.asarray(jq.quantize_dequantize(jnp.asarray(xs), jnp.int32(n), width))
        np.testing.assert_array_equal(tq.quantize_dequantize(_t(xs), n, width).numpy(), want)
        np.testing.assert_array_equal(
            tq.quantize_dequantize(_t(xs), torch.tensor(n, dtype=torch.int32), width).numpy(),
            want)


def test_fake_quant_twice_follows_the_reference_which_is_not_idempotent():
    """Mirrors test_properties.py::test_fake_quant_idempotent and follows the
    reference: at x = 2^-14, width 8, n = 20 and XLA's exp2(-20) lies just
    below 2^-20, so a second pass truncates 64 to 63.  The port gives the
    reference's values on both passes."""
    x = np.asarray([2.0 ** -14, -(2.0 ** -14), 0.0], np.float32)
    n = jq.frac_bits_for(jq.max_abs(jnp.asarray(x)), 8)
    assert int(n) == 20
    j1 = np.asarray(jq.quantize_dequantize(jnp.asarray(x), n, 8))
    j2 = np.asarray(jq.quantize_dequantize(jnp.asarray(j1), n, 8))
    tn = tq.frac_bits_for(tq.max_abs(_t(x)), 8)
    t1 = tq.quantize_dequantize(_t(x), tn, 8)
    t2 = tq.quantize_dequantize(t1, tn, 8)
    np.testing.assert_array_equal(t1.numpy(), j1)
    np.testing.assert_array_equal(t2.numpy(), j2)
    assert not np.array_equal(j1, j2)


@pytest.mark.parametrize("n_override,channel_axis", [(9, None), (9, 1), ("vector", 1)])
def test_quantize_tensor_n_override_matches_reference(n_override, channel_axis):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (6, 5)).astype(np.float32)
    n = rng.integers(3, 12, (5,)).astype(np.int32) if n_override == "vector" else n_override
    want = jq.quantize_tensor(jnp.asarray(x), 16, channel_axis=channel_axis,
                              n_override=jnp.asarray(n))
    got = tq.quantize_tensor(_t(x), 16, channel_axis=channel_axis,
                             n_override=_t(np.asarray(n, np.int32)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    assert got.channel_axis == want.channel_axis
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


def test_widths_and_scales_match_reference():
    for w in (2, 4, 8, 9, 16, 32):
        assert str(tq.accumulator_dtype(w)).split(".")[-1] == jnp.dtype(jq.accumulator_dtype(w)).name
    for n in (-3, 5, 15, -15):
        assert tq.scale_from_n(n) == float(jq.scale_from_n(jnp.int32(n)))
    assert tq.quantize_tensor(torch.ones(4, 8), 9).nbytes_model == 36


# ---- integerize, quantize_input, model_rom_bytes ------------------------------------

def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, jq.QTensor):
        assert isinstance(got, QTensor) and got.width == want.width
        assert got.channel_axis == want.channel_axis
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _dense_conv_params(seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"dense": jl.Dense(12, 5).init(k[0]),
              "conv": jl.Conv1D(5, 7, 3).init(k[1]),
              "norm": {"scale": jnp.ones((5,))}}
    params["dense"]["bias"] = jax.random.normal(k[2], (5,)) * 0.1
    return params


@pytest.mark.parametrize("policy_kw", [
    dict(weight_bits=8, act_bits=8),
    dict(weight_bits=16, act_bits=16, granularity=Granularity.PER_NETWORK, network_frac_bits=9),
    dict(weight_bits=8, act_bits=8, granularity=Granularity.PER_CHANNEL),
    dict(weight_bits=9, act_bits=9)])
def test_integerize_matches_reference(policy_kw):
    """Kernels, biases and baked n_out (by the layer's site, the suffix rule
    and the per-network exponent), norms left float."""
    jp, tp = _policy_pair(QMode.EVAL, **policy_kw)
    params = _dense_conv_params()
    qstate = {"net/dense/out": np.int32(4), "net/conv/out": np.int32(6)}
    want = j_int.integerize(params, jp, {k: jnp.asarray(v) for k, v in qstate.items()})
    got = t_int.integerize(params_from_numpy(_np(params), "cpu"), tp,
                           {k: _t(v) for k, v in qstate.items()})
    _assert_trees_equal(got, want)
    assert t_int.model_rom_bytes(got) == j_int.model_rom_bytes(want)
    assert param_count(got) == j_param_count(want)
    assert param_bytes(got) == j_param_bytes(want)


def test_integerize_keeps_norms_float_and_bakes_n_out():
    params = {"dense": {"kernel": torch.ones(4, 4) * 0.5, "bias": torch.ones(4)},
              "norm": {"scale": torch.ones(4)}, "router": {"kernel": torch.ones(4, 2)}}
    out = t_int.integerize(params, QuantPolicy.int8_qat(), qstate={"dense/out": 4})
    assert isinstance(out["dense"]["kernel"], QTensor)
    assert isinstance(out["dense"]["bias"], QTensor)
    assert int(out["dense"]["n_out"]) == 4
    assert not isinstance(out["norm"]["scale"], QTensor)
    assert not isinstance(out["router"]["kernel"], QTensor)
    assert "n_out" not in out["router"]


def test_rom_bytes_count_logical_width():
    ones = torch.ones(4, 8)
    assert t_int.model_rom_bytes({"l": {"kernel": tq.quantize_tensor(ones, 8)}}) == 36
    assert t_int.model_rom_bytes({"l": {"kernel": tq.quantize_tensor(ones, 9)}}) == 40
    assert t_int.model_rom_bytes({"dense": {"kernel": tq.quantize_tensor(ones, 8)},
                                  "norm": {"scale": torch.ones(8)}}) == 36 + 32


def test_quantize_input_matches_reference():
    x = np.asarray([0.5, -1.25, 3.96875, 0.0, 100.0, -100.0], np.float32)
    for n, width in ((5, 8), (9, 16), (13, 16)):
        want = j_int.quantize_input(jnp.asarray(x), {"in": n}, "in", width)
        got = t_int.quantize_input(_t(x), {"in": n}, "in", width)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        assert int(got.n) == n and got.q.dtype == tq.storage_dtype(width)
    with pytest.raises(KeyError):
        t_int.quantize_input(torch.ones(3), {}, "absent", 8)


# ---- calibration: ranges_to_qstate and the observers ---------------------------------

def _stat_batches(seed=0, n=5):
    rng = np.random.default_rng(seed)
    sites = ["a/out", "b/in", "c/out"]
    return [{s: np.float32(np.exp(rng.uniform(-6, 6))) for s in sites} for _ in range(n)]


@pytest.mark.parametrize("kind,kw", [("minmax", {}), ("ema", {}), ("ema", {"decay": 0.5})])
@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_observers_give_the_reference_exponents(kind, kw, policy):
    jp, tp = ((JP(mode=JM.EVAL), QuantPolicy(mode=QMode.EVAL)) if policy == "int8"
              else (JP.int16_ptq(), QuantPolicy.int16_ptq()))
    jo, to = j_obs.make_observer(kind, **kw), t_obs.make_observer(kind, **kw)
    for st in _stat_batches():
        jo.observe({k: jnp.asarray(v) for k, v in st.items()})
        to.observe({k: _t(v) for k, v in st.items()})
    for k in jo.ranges:
        np.testing.assert_allclose(to.ranges[k].numpy(), np.asarray(jo.ranges[k]), rtol=1e-6)
    want, got = jo.qstate(jp), to.qstate(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert int(got[k]) == int(want[k]) and got[k].dtype == torch.int32


def test_make_observer_refuses_unknown_kinds():
    obs = t_obs.EMAObserver(decay=0.7)
    assert t_obs.make_observer(obs) is obs
    with pytest.raises(ValueError, match="unknown observer"):
        t_obs.make_observer("median")


def test_ranges_to_qstate_at_powers_of_two():
    ranges = {f"s{i}": np.float32(2.0 ** k) for i, k in enumerate(range(-20, 20, 3))}
    for jp, tp in ((JP(act_bits=8), QuantPolicy(act_bits=8)),
                   (JP(act_bits=16), QuantPolicy(act_bits=16)),
                   (JP.int16_ptq(), QuantPolicy.int16_ptq())):
        want = j_ptq.ranges_to_qstate({k: jnp.asarray(v) for k, v in ranges.items()}, jp)
        got = t_ptq.ranges_to_qstate({k: _t(v) for k, v in ranges.items()}, tp)
        assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


# ---- Context ----------------------------------------------------------------------

def test_context_scopes_share_stats_and_read_frozen_exponents():
    ctx = Context(policy=QuantPolicy(mode=QMode.CALIB), qstate={"net/a/out": 3})
    child = ctx.scope("net").scope("a")
    assert child.key("out") == "net/a/out" and child.frozen("out") == 3
    assert child.frozen("in") is None and eval_context().frozen("x") is None
    assert child.collecting and not eval_context().collecting
    child.record("in", torch.tensor([1.0, -4.0]))
    child.record("in", torch.tensor([3.0]))
    assert ctx.stats["net/a/in"].item() == 4.0
    assert not eval_context().train


# ---- layers: float (OFF) ------------------------------------------------------------

def _layer_pair(kind, **kw):
    return getattr(jl, kind)(**kw), getattr(tl, kind)(**kw)


_LAYERS = [("Dense", dict(in_features=12, out_features=5), (3, 4, 12)),
           ("Conv1D", dict(in_channels=6, out_channels=7, kernel_size=3), (2, 20, 6)),
           ("Conv1D", dict(in_channels=6, out_channels=7, kernel_size=4, stride=2), (2, 21, 6)),
           ("Conv1D", dict(in_channels=6, out_channels=7, kernel_size=3, padding="VALID"),
            (2, 20, 6)),
           ("Conv2D", dict(in_channels=3, out_channels=5, kernel_size=3), (2, 9, 8, 3)),
           ("Conv2D", dict(in_channels=3, out_channels=4, kernel_size=(3, 2), stride=2),
            (1, 9, 7, 3))]


def _bias(params, seed):
    p = dict(params)
    p["bias"] = jnp.asarray(np.random.default_rng(seed).normal(0, 0.2, p["bias"].shape),
                            jnp.float32)
    return p


@pytest.mark.parametrize("kind,kw,shape", _LAYERS)
def test_layer_float_path_matches_reference(kind, kw, shape):
    jlay, tlay = _layer_pair(kind, **kw)
    jp = _bias(jlay.init(jax.random.PRNGKey(1)), 2)
    x = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(jlay.apply(jp, jnp.asarray(x), JC()))
    got = tlay.apply(params_from_numpy(_np(jp), "cpu"), _t(x), Context())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("kind,kw,shape", _LAYERS[:2] + _LAYERS[4:5])
@pytest.mark.parametrize("policy_kw", [
    dict(weight_bits=8, act_bits=8),
    dict(weight_bits=16, act_bits=16, granularity=Granularity.PER_NETWORK, network_frac_bits=9),
    dict(weight_bits=8, act_bits=8, granularity=Granularity.PER_CHANNEL)])
def test_layer_fake_quant_and_calib_paths_match_reference(kind, kw, shape, policy_kw):
    """EVAL on frozen exponents and QAT on live ranges: the outputs' codes
    (output times 2^n_out) equal the reference's up to a truncation edge;
    CALIB records the same sites with the same exponents."""
    jlay, tlay = _layer_pair(kind, **kw)
    jp = _bias(jlay.init(jax.random.PRNGKey(4)), 5)
    tp = params_from_numpy(_np(jp), "cpu")
    x = np.random.default_rng(6).normal(0, 1, shape).astype(np.float32)
    jpol, tpol = _policy_pair(QMode.CALIB, **policy_kw)
    jctx, tctx = JC(policy=jpol), Context(policy=tpol)
    jlay.apply(jp, jnp.asarray(x), jctx)
    tlay.apply(tp, _t(x), tctx)
    assert sorted(tctx.stats) == sorted(jctx.stats)
    for k, v in jctx.stats.items():
        np.testing.assert_allclose(tctx.stats[k].numpy(), np.asarray(v), rtol=RTOL)
    bits = policy_kw["act_bits"]
    qstate = {k: jq.frac_bits_for(v, bits) for k, v in jctx.stats.items()}
    for mode in (QMode.EVAL, QMode.QAT):
        jpol, tpol = _policy_pair(mode, **policy_kw)
        want = np.asarray(jlay.apply(jp, jnp.asarray(x), JC(policy=jpol, qstate=qstate)))
        got = tlay.apply(tp, _t(x), Context(policy=tpol, qstate={k: _t(np.asarray(v))
                                                                 for k, v in qstate.items()}))
        step = np.abs(np.diff(np.unique(want))).min() if want.size > 1 else 1.0
        flips = np.abs(got.numpy() - want) > RTOL * np.abs(want) + 1e-7
        assert flips.mean() <= 0.02, f"{mode}: {flips.sum()} of {flips.size} codes differ"
        assert np.abs(got.numpy() - want).max() <= step * 1.0001 + 1e-7


def test_embedding_fake_quant_path_matches_reference():
    jemb, temb = jl.Embedding(20, 8), tl.Embedding(20, 8)
    jp = jemb.init(jax.random.PRNGKey(2))
    ids = np.asarray([[0, 3, 19], [7, 7, 1]], np.int32)
    for mode in (QMode.EVAL, QMode.CALIB, QMode.OFF):
        jpol, tpol = _policy_pair(mode, weight_bits=8, act_bits=8)
        want = np.asarray(jemb.apply(jp, jnp.asarray(ids), JC(policy=jpol)))
        got = temb.apply(params_from_numpy(_np(jp), "cpu"), _t(ids).long(), Context(policy=tpol))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_folded_matches_reference(train):
    rng = np.random.default_rng(8)
    jbn, tbn = jl.BatchNormFolded(6), tl.BatchNormFolded(6)
    p = {"gamma": rng.uniform(0.5, 2, 6), "beta": rng.normal(0, 1, 6),
         "mean": rng.normal(0, 1, 6), "var": rng.uniform(0.1, 3, 6)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 2, (4, 10, 6)).astype(np.float32)
    want = np.asarray(jbn.apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                JC(train=train)))
    got = tbn.apply({k: _t(v) for k, v in p.items()}, _t(x), Context(train=train))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("ndim,shape,window,stride", [(1, (2, 16, 3), 4, None),
                                                     (1, (2, 17, 3), 3, 2),
                                                     (2, (2, 8, 9, 3), 2, None),
                                                     (2, (1, 9, 9, 2), 3, 2)])
def test_pools_match_reference(ndim, shape, window, stride):
    """Float pools at rtol 1e-5; integer max/avg/global-avg pools and relu on
    QTensors bit for bit (window sizes 2^k take the shift, others the
    integer divide)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 1, shape).astype(np.float32)
    for name in ("max_pool", "avg_pool"):
        want = np.asarray(getattr(jl, name)(jnp.asarray(x), window, stride, ndim))
        got = getattr(tl, name)(_t(x), window, stride, ndim)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tl.global_avg_pool(_t(x), ndim).numpy(),
                               np.asarray(jl.global_avg_pool(jnp.asarray(x), ndim)), rtol=RTOL,
                               atol=1e-6)
    q = rng.integers(-128, 128, shape).astype(np.int8)
    jx, tx = jq.QTensor(jnp.asarray(q), jnp.int32(5), 8), QTensor(_t(q), torch.tensor(5), 8)
    for fn in (lambda m, a: m.max_pool(a, window, stride, ndim),
               lambda m, a: m.avg_pool(a, window, stride, ndim),
               lambda m, a: m.global_avg_pool(a, ndim), lambda m, a: m.relu(a)):
        want, got = fn(jl, jx), fn(tl, tx)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        assert got.q.dtype == torch.int8 and int(got.n) == 5


# ---- layers: the integer engine -------------------------------------------------------

@pytest.mark.parametrize("kind,kw,shape", _LAYERS)
@pytest.mark.parametrize("policy_kw", [
    dict(weight_bits=8, act_bits=8),
    dict(weight_bits=16, act_bits=16, granularity=Granularity.PER_NETWORK, network_frac_bits=9),
    dict(weight_bits=8, act_bits=8, granularity=Granularity.PER_CHANNEL)])
def test_layer_integer_path_matches_reference(kind, kw, shape, policy_kw):
    """Integerized by the reference and carried across leaf by leaf: output
    codes and exponents bit for bit.  Per-channel layers run without a bias:
    the reference's ``align`` cannot broadcast a (C,) bias to the
    per-channel accumulator exponent (ROADMAP.md §3); the port's can."""
    jlay, tlay = _layer_pair(kind, **kw)
    jp = _bias(jlay.init(jax.random.PRNGKey(9)), 10)
    if policy_kw.get("granularity") is Granularity.PER_CHANNEL:
        del jp["bias"]
    jpol, tpol = _policy_pair(QMode.EVAL, **policy_kw)
    ji = j_int.integerize({"l": jp}, jpol, {"l/out": jnp.int32(3)})["l"]
    ti = params_from_numpy(_np(ji), "cpu")
    bits = policy_kw["act_bits"]
    rng = np.random.default_rng(11)
    hi = 2 ** (bits - 1)
    q = rng.integers(-hi, hi, shape).astype(np.int8 if bits == 8 else np.int16)
    jx = jq.QTensor(jnp.asarray(q), jnp.int32(6), bits)
    tx = QTensor(_t(q), torch.tensor(6, dtype=torch.int32), bits)
    want = jlay.apply(ji, jx, JC(policy=jpol.with_mode(JM.INTEGER)))
    got = tlay.apply(ti, tx, Context(policy=tpol.with_mode(QMode.INTEGER)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert int(got.n) == int(want.n) and got.width == want.width


def test_per_channel_bias_aligns_where_the_reference_raises():
    """The reference's per-channel integer Dense with a bias fails in
    ``align`` (a (C,) bias against a broadcast-shaped exponent); the port
    aligns each channel's bias to its own accumulator format."""
    jlay, tlay = _layer_pair("Dense", in_features=6, out_features=4)
    jp = _bias(jlay.init(jax.random.PRNGKey(12)), 13)
    jpol, tpol = _policy_pair(QMode.EVAL, granularity=Granularity.PER_CHANNEL)
    ji = j_int.integerize({"l": jp}, jpol, {"l/out": jnp.int32(3)})["l"]
    q = np.random.default_rng(14).integers(-128, 128, (2, 6)).astype(np.int8)
    with pytest.raises(ValueError, match="broadcast"):
        jlay.apply(ji, jq.QTensor(jnp.asarray(q), jnp.int32(6), 8),
                   JC(policy=jpol.with_mode(JM.INTEGER)))
    ti = params_from_numpy(_np(ji), "cpu")
    got = tlay.apply(ti, QTensor(_t(q), torch.tensor(6, dtype=torch.int32), 8),
                     Context(policy=tpol.with_mode(QMode.INTEGER)))
    n_acc = 6 + ti["kernel"].n.to(torch.int64)
    acc = q.astype(np.int64) @ ti["kernel"].q.numpy().astype(np.int64)
    acc = acc + ti["bias"].q.numpy().astype(np.int64) * 2 ** (n_acc - int(ti["bias"].n)).numpy()
    want = np.clip(np.floor(acc / 2.0 ** (n_acc.numpy() - 3)), -128, 127)
    np.testing.assert_array_equal(got.q.numpy(), want.astype(np.int8))


def test_integer_layer_without_a_calibrated_exponent_raises():
    tlay = tl.Dense(4, 3)
    p = t_int.integerize({"l": tlay.init(torch.Generator().manual_seed(0), "cpu")},
                         QuantPolicy(mode=QMode.EVAL))["l"]
    x = QTensor(torch.ones(2, 4, dtype=torch.int8), torch.tensor(3), 8)
    with pytest.raises(ValueError, match="calibrated output exponent"):
        tlay.apply(p, x, Context(policy=QuantPolicy.serve_int8()))


@pytest.mark.parametrize("na,nb,n_out", [(5, 5, 4), (7, 2, 3), (2, 9, 6), (0, 30, 1)])
def test_qadd_matches_reference(na, nb, n_out):
    rng = np.random.default_rng(na + nb)
    a = rng.integers(-128, 128, (3, 16, 4)).astype(np.int8)
    b = rng.integers(-128, 128, (3, 16, 4)).astype(np.int8)
    jpol, tpol = _policy_pair(QMode.INTEGER, weight_bits=8, act_bits=8)
    want = jl.qadd(jq.QTensor(jnp.asarray(a), jnp.int32(na), 8),
                   jq.QTensor(jnp.asarray(b), jnp.int32(nb), 8),
                   JC(policy=jpol, qstate={"add/out": jnp.int32(n_out)}))
    got = tl.qadd(QTensor(_t(a), torch.tensor(na, dtype=torch.int32), 8),
                  QTensor(_t(b), torch.tensor(nb, dtype=torch.int32), 8),
                  Context(policy=tpol, qstate={"add/out": torch.tensor(n_out,
                                                                       dtype=torch.int32)}))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    with pytest.raises(ValueError, match="calibrated exponent"):
        tl.qadd(QTensor(_t(a), torch.tensor(na), 8), QTensor(_t(b), torch.tensor(nb), 8),
                Context(policy=tpol))
    x = rng.normal(0, 1, (2, 5)).astype(np.float32)
    np.testing.assert_allclose(tl.qadd(_t(x), _t(x), Context()).numpy(), 2 * x, rtol=RTOL)
