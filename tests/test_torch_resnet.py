"""The integer-engine slice as a whole: ResNetv1-6 (UCI-HAR shape, 128 x 9,
6 classes) with JAX-initialized parameters converted leaf by leaf, through
calibrate -> integerize -> full-integer inference, against repro.

* integer logits bit-identical to ``QMode.INTEGER`` in repro, int8
  per-layer and int16 Q7.9, filters 8 and 80, on the reference's qstate;
* float logits at rtol 1e-5;
* the port's own calibration gives the reference's exponents;
* ``model_rom_bytes`` equal; one GTSRB (2-D) integer forward at filters 8;
* on the CPU no kernel launches; on the card (``cuda`` marker) 6 ``qconv1d``
  and 1 ``qmm`` per forward;
* the paper's MCU cost model (op counts, cycles, energy, ROM, the RAM-pool
  allocator) equal to repro's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.microai_resnet import build_resnet as j_build
from repro.core import integerize as j_int
from repro.core import ptq as j_ptq
from repro.core.policy import QMode as JM
from repro.core.policy import QuantPolicy as JP
from repro.nn.module import Context as JC
from repro_torch.configs.microai_resnet import DATASETS, build_resnet
from repro_torch.convert import params_from_numpy
from repro_torch.core import integerize, ptq
from repro_torch.core.policy import QMode, QuantPolicy
from repro_torch.kernels import ops
from repro_torch.nn.module import Context

torch.set_num_threads(2)
RTOL = 1e-5
BATCH = 64
SITE = "resnet6/conv1/in"
POLICIES = {"int8": (JP(mode=JM.EVAL, weight_bits=8, act_bits=8),
                     QuantPolicy(mode=QMode.EVAL, weight_bits=8, act_bits=8)),
            "int16": (JP.int16_ptq(), QuantPolicy.int16_ptq())}


def _inputs(dataset, seed=0):
    shape = DATASETS[dataset].in_shape
    return np.random.default_rng(seed).normal(0, 1, (BATCH, *shape)).astype(np.float32)


def _calib_batches(x):
    return [x[i * 16:(i + 1) * 16] for i in range(4)]


def _reference(dataset, filters, policy):
    """repro's pipeline, as test_system.py runs it: calibrate on 4 batches,
    integerize, quantize the input, integer forward."""
    model = j_build(dataset, filters=filters)
    params = model.init(jax.random.PRNGKey(filters))
    x = _inputs(dataset)
    jpol = POLICIES[policy][0]

    @jax.jit
    def calib_step(p, xb):
        ctx = JC(policy=jpol.with_mode(JM.CALIB), train=False)
        model.apply(p, xb, ctx)
        return ctx.stats

    stats = {}
    for xb in _calib_batches(x):
        for k, v in calib_step(params, jnp.asarray(xb)).items():
            stats[k] = jnp.maximum(stats[k], v) if k in stats else v
    qstate = j_ptq.ranges_to_qstate(stats, jpol)
    iparams = j_int.integerize(params, jpol, qstate)
    xq = j_int.quantize_input(jnp.asarray(x), qstate, SITE, jpol.act_bits)
    logits = model.apply(iparams, xq, JC(policy=jpol.with_mode(JM.INTEGER), qstate=qstate))
    return dict(params=params, x=x, qstate=qstate, iparams=iparams,
                int_logits=np.asarray(logits),
                float_logits=np.asarray(model.apply(params, jnp.asarray(x), JC())),
                eval_logits=np.asarray(model.apply(params, jnp.asarray(x),
                                                   JC(policy=jpol, qstate=qstate))))


_CACHE = {}


def reference(dataset, filters, policy):
    key = (dataset, filters, policy)
    if key not in _CACHE:
        _CACHE[key] = _reference(*key)
    return _CACHE[key]


def _port(dataset, filters, ref):
    model = build_resnet(dataset, filters=filters, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref["params"]), "cpu")
    qstate = {k: torch.from_numpy(np.array(v)) for k, v in ref["qstate"].items()}
    return model, params, qstate


@pytest.mark.parametrize("filters", [8, 80])
@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_integer_logits_bit_identical_to_reference(filters, policy):
    ref = reference("uci-har", filters, policy)
    model, params, qstate = _port("uci-har", filters, ref)
    tpol = POLICIES[policy][1]
    iparams = integerize.integerize(params, tpol, qstate)
    xq = integerize.quantize_input(torch.from_numpy(ref["x"]), qstate, SITE, tpol.act_bits)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model.apply(iparams, xq, Context(policy=tpol.with_mode(QMode.INTEGER),
                                                  qstate=qstate))
    assert logits.shape == (BATCH, 6) and logits.dtype == torch.float32
    np.testing.assert_array_equal(logits.numpy(), ref["int_logits"])
    assert set(ops.launch_counts().values()) == {0}, "a CPU run launched a kernel"
    assert integerize.model_rom_bytes(iparams) == j_int.model_rom_bytes(ref["iparams"])
    assert integerize.model_rom_bytes(params) == j_int.model_rom_bytes(ref["params"])


@pytest.mark.parametrize("filters", [8, 80])
@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_float_and_eval_logits_match_reference(filters, policy):
    """Float logits at rtol 1e-5; the EVAL fake-quant logits carry a code
    flip wherever an f32 sum in another order crosses a truncation edge,
    so they are held by argmax (all rows) and within one output step."""
    ref = reference("uci-har", filters, policy)
    model, params, qstate = _port("uci-har", filters, ref)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        got = model.apply(params, x, Context()).numpy()
        ev = model.apply(params, x, Context(policy=POLICIES[policy][1], qstate=qstate)).numpy()
    np.testing.assert_allclose(got, ref["float_logits"], rtol=RTOL, atol=RTOL)
    step = 2.0 ** -int(qstate["resnet6/fc/out"])
    assert np.abs(ev - ref["eval_logits"]).max() <= step
    assert (ev.argmax(-1) == ref["eval_logits"].argmax(-1)).all()


@pytest.mark.parametrize("filters", [8, 80])
@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_own_calibration_gives_reference_qstate(filters, policy):
    ref = reference("uci-har", filters, policy)
    model, params, _ = _port("uci-har", filters, ref)
    tpol = POLICIES[policy][1]
    qstate = ptq.calibrate(model.apply, params,
                           [torch.from_numpy(b) for b in _calib_batches(ref["x"])], tpol)
    assert sorted(qstate) == sorted(ref["qstate"])
    assert {k: int(v) for k, v in qstate.items()} == \
        {k: int(v) for k, v in ref["qstate"].items()}
    # and the integer forward on the port's own qstate is the reference's
    iparams = integerize.integerize(params, tpol, qstate)
    xq = integerize.quantize_input(torch.from_numpy(ref["x"]), qstate, SITE, tpol.act_bits)
    with torch.no_grad():
        logits = model.apply(iparams, xq, Context(policy=tpol.with_mode(QMode.INTEGER),
                                                  qstate=qstate))
    np.testing.assert_array_equal(logits.numpy(), ref["int_logits"])


def test_integer_engine_tracks_eval_and_shrinks_the_rom():
    """test_system.py's acceptance on the port: integer argmax agrees with
    the EVAL fake-quant argmax on > 0.9 of rows; int8 ROM is > 3.5x smaller
    than float32."""
    ref = reference("uci-har", 80, "int8")
    model, params, qstate = _port("uci-har", 80, ref)
    tpol = POLICIES["int8"][1]
    iparams = integerize.integerize(params, tpol, qstate)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        out = model.apply(iparams, integerize.quantize_input(x, qstate, SITE, 8),
                          Context(policy=tpol.with_mode(QMode.INTEGER), qstate=qstate))
        ev = model.apply(params, x, Context(policy=tpol, qstate=qstate))
    assert (out.argmax(-1) == ev.argmax(-1)).float().mean().item() > 0.9
    assert integerize.model_rom_bytes(params) / integerize.model_rom_bytes(iparams) > 3.5


@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_gtsrb_2d_integer_forward_matches_reference(policy):
    """The 2-D integer conv is plain tensor code (as the reference leaves it
    to XLA's int32 conv): bit-identical logits at filters 8."""
    ref = reference("gtsrb", 8, policy)
    model, params, qstate = _port("gtsrb", 8, ref)
    tpol = POLICIES[policy][1]
    iparams = integerize.integerize(params, tpol, qstate)
    xq = integerize.quantize_input(torch.from_numpy(ref["x"]), qstate, SITE, tpol.act_bits)
    with torch.no_grad():
        logits = model.apply(iparams, xq, Context(policy=tpol.with_mode(QMode.INTEGER),
                                                  qstate=qstate))
    assert logits.shape == (BATCH, 43)
    np.testing.assert_array_equal(logits.numpy(), ref["int_logits"])


def test_build_resnet_defaults_to_the_card():
    """The entry point runs on CUDA unless the caller asks for the CPU; with
    no card visible and no choice it raises."""
    model = build_resnet("smnist", filters=4, device="cpu")
    assert (model.in_channels, model.classes, model.ndim) == (13, 10, 1)
    params = model.init(torch.Generator().manual_seed(0))
    assert params["conv1"]["kernel"].shape == (3, 13, 4) and params["fc"]["kernel"].device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_resnet("uci-har")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "int16"])
def test_cuda_integer_forward_launches_the_kernels(policy):
    """On the card: 6 qconv1d and 1 qmm per integer forward, and logits
    equal to the plain versions' on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    model = build_resnet("uci-har", filters=16, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(256, 128, 9, device="cuda")
    tpol = POLICIES[policy][1]
    qstate = ptq.calibrate(model.apply, params, [x[i * 32:(i + 1) * 32] for i in range(4)], tpol)
    iparams = integerize.integerize(params, tpol, qstate)
    xq = integerize.quantize_input(x, qstate, SITE, tpol.act_bits)
    ctx = Context(policy=tpol.with_mode(QMode.INTEGER), qstate=qstate)
    ops.reset_launch_counts()
    out = model.apply(iparams, xq, ctx)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["qconv1d"] == 6 and counts["qmm"] == 1
    assert sum(counts.values()) == 7
    ops.FORCE = "plain"
    try:
        plain = model.apply(iparams, xq, ctx)
    finally:
        ops.FORCE = None
    assert torch.equal(out, plain)


# ---- the paper's MCU cost model, beside the engine ---------------------------------------

@pytest.mark.parametrize("filters", [16, 24, 32, 40, 48, 64, 80])
@pytest.mark.parametrize("board", ["nucleo-l452re-p", "sparkfun-edge"])
def test_cost_model_matches_reference_over_the_sweep(filters, board):
    """ResNetv1-6 op counts, cycles, time and energy per inference on the
    filter sweep of paper Tables A3/A4 (UCI-HAR shape), and the ROM model."""
    from repro.core import cost_model as jcm
    from repro_torch.core import cost_model as tcm

    want, got = jcm.resnet6_ops(filters, 128, 9), tcm.resnet6_ops(filters, 128, 9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.cycles == want.cycles
    t = tcm.inference_seconds(got, board)
    assert t == jcm.inference_seconds(want, board)
    assert tcm.inference_energy_uwh(t, board) == jcm.inference_energy_uwh(t, board)
    assert tcm.rom_bytes(1000 * filters, 8) == jcm.rom_bytes(1000 * filters, 8)


def test_pool_allocator_matches_reference_on_resnet6_graph():
    """The paper's RAM-pool allocator (Sec. 5.7) on ResNetv1-6's layer graph,
    residual branches included: same pools, same total."""
    from repro.core import cost_model as jcm
    from repro_torch.core import cost_model as tcm

    f, s = 80, 128
    graph = [{"name": "in", "inputs": [], "bytes": s * 9},
             {"name": "conv1", "inputs": ["in"], "bytes": f * s},
             {"name": "conv2", "inputs": ["conv1"], "bytes": f * s},
             {"name": "conv3", "inputs": ["conv2"], "bytes": f * s},
             {"name": "short1", "inputs": ["conv1"], "bytes": f * s},
             {"name": "add1", "inputs": ["conv3", "short1"], "bytes": f * s},
             {"name": "pool", "inputs": ["add1"], "bytes": f * s // 4},
             {"name": "conv4", "inputs": ["pool"], "bytes": f * s // 4},
             {"name": "conv5", "inputs": ["conv4"], "bytes": f * s // 4},
             {"name": "add2", "inputs": ["conv5", "pool"], "bytes": f * s // 4},
             {"name": "gpool", "inputs": ["add2"], "bytes": f},
             {"name": "fc", "inputs": ["gpool"], "bytes": 6}]
    jp, tp = jcm.PoolAllocator(), tcm.PoolAllocator()
    assert tp.allocate(graph) == jp.allocate(graph)
    assert tp.pools == jp.pools
