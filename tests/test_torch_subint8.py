"""Port parity for packed sub-int8 storage and the exp2 table: packing,
block exponents, ``PackedQTensor``, ``quantize_tensor_packed`` and
``integerize_weights_only`` against repro's, bit for bit.

The cases mirror ``tests/test_subint8_properties.py`` with parametrised
seeds in place of hypothesis draws.  ``exp2`` follows XLA-CPU
``jnp.exp2``, which misses 2^n at most |n| >= 13: the table is held to it
entry by entry, and int16 integerization (exponents 15-17 on the smoke
model) to repro's codes.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import integerize as j_integerize
from repro.core import qformat as jq
from repro.models.registry import get_config as j_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import qformat as tq
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.models.registry import get_config
from repro_torch.nn.module import tree_layer, tree_to

torch.set_num_threads(2)
WIDTHS = [2, 4]


def _codes(width, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(tq.qmin(width), tq.qmax(width) + 1, size=shape).astype(np.int8)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert (got.numpy().dtype, tuple(got.shape)) == (want.dtype, want.shape), (got, want)
    np.testing.assert_array_equal(got.numpy(), want)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# exp2: the reference's float32 powers of two
# --------------------------------------------------------------------------

def test_exp2_table_equals_jnp_exp2_at_every_entry():
    n = np.arange(tq.EXP2_MIN, tq.EXP2_MAX + 1, dtype=np.int32)
    want = _bits(jnp.exp2(jnp.asarray(n, jnp.float32)))
    np.testing.assert_array_equal(_bits(tq.EXP2_TABLE), want)
    np.testing.assert_array_equal(_bits(tq.exp2(torch.from_numpy(n)).numpy()), want)
    np.testing.assert_array_equal(_bits([tq.exp2(int(i)) for i in n]), want)
    # the reference's values, not exact powers of two, wherever they differ
    assert tq.exp2(15) == np.float32(32767.984) and tq.exp2(-20) == np.float32(9.5367426e-07)
    inexact = [int(i) for i in n if tq.exp2(int(i)) != math.ldexp(1.0, int(i))]
    assert len(inexact) == 96 and all(abs(i) >= 13 for i in inexact)


def test_exp2_takes_integer_exponents_only():
    with pytest.raises(TypeError, match="integer exponents"):
        tq.exp2(torch.tensor([1.0]))
    with pytest.raises(ValueError, match="outside"):
        tq.exp2(tq.EXP2_MAX + 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kv_exponent_is_where_the_kernels_exp2f_is_exact(paged):
    """The attention kernels compute exp2f(+-k_n) in the kernel rather than
    reading the table.  Every int8 cache the engine makes sits on the Q4.3
    grid (n = 3), and over |n| <= 12 the table holds exact powers of two,
    so the kernels and the reference scale K and V alike."""
    from repro_torch.serve import ServeEngine

    tm = get_config("smollm-135m-smoke").build()
    eng = ServeEngine(model=tm, params=tm.init(torch.Generator().manual_seed(0), "cpu"),
                      max_len=16, batch_slots=2, quantized_kv=True, device="cpu",
                      paged_kv=paged, page_size=8)
    exps = [v for cache in (eng.new_cache(), eng.new_cache(per_slot=True))
            for path, v in _leaves(cache) if path.endswith(("/k_n", "/v_n"))]
    assert exps and set(exps) == {3}
    for n in range(-12, 13):
        assert tq.exp2(n) == math.ldexp(1.0, n)


@pytest.mark.parametrize("n", [13, 15, 17, -13, -20])
def test_quantize_and_dequantize_match_reference_past_the_exact_range(n):
    """Codes on the reference's grid at |n| >= 13, where exact 2^n differs."""
    rng = np.random.default_rng(abs(n))
    x = rng.uniform(-0.99, 0.99, (4096,)).astype(np.float32) * np.float32(2.0 ** (15 - n))
    _same(tq.quantize(torch.from_numpy(x), n, 16), jq.quantize(x, jnp.int32(n), 16))
    q = rng.integers(-32768, 32768, (4096,)).astype(np.int16)
    np.testing.assert_array_equal(_bits(tq.dequantize(torch.from_numpy(q), n).numpy()),
                                  _bits(jq.dequantize(q, jnp.int32(n))))


# --------------------------------------------------------------------------
# pack -> unpack: bytes equal to the reference's, round trips exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 16, 17, 33])
def test_pack_unpack_match_reference(width, k):
    q = _codes(width, (k, 1 + k % 5), seed=width * 100 + k)
    packed = tq.pack_subint8(torch.from_numpy(q), width, axis=-2)
    assert packed.shape == (-(-k // tq.lanes_per_byte(width)), q.shape[1])
    _same(packed, jq.pack_subint8(jnp.asarray(q), width, axis=-2))
    _same(tq.unpack_subint8(packed, width, k, axis=-2), q)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("lead,k", [(1, 1), (2, 9), (3, 17)])
def test_pack_unpack_stacked_leading_dims(width, lead, k):
    q = _codes(width, (lead, k, 3), seed=lead * 10 + k)
    packed = tq.pack_subint8(torch.from_numpy(q), width, axis=-2)
    _same(packed, jq.pack_subint8(jnp.asarray(q), width, axis=-2))
    _same(tq.unpack_subint8(packed, width, k, axis=-2), q)
    for i in range(lead):
        torch.testing.assert_close(tq.pack_subint8(torch.from_numpy(q[i]), width), packed[i],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("width", WIDTHS)
def test_sign_preserved_in_every_lane_position(width):
    lanes = tq.lanes_per_byte(width)
    for pos in range(lanes):
        q = np.zeros((lanes, 1), np.int8)
        q[pos, 0] = tq.qmin(width)
        packed = tq.pack_subint8(torch.from_numpy(q), width)
        _same(packed, jq.pack_subint8(jnp.asarray(q), width))
        _same(tq.unpack_subint8(packed, width, lanes), q)


def test_lanes_per_byte_refuses_other_widths():
    assert (tq.lanes_per_byte(4), tq.lanes_per_byte(2)) == (2, 4)
    with pytest.raises(ValueError, match="widths 2 and 4"):
        tq.lanes_per_byte(8)


# --------------------------------------------------------------------------
# block exponents and packed quantization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("k,block_size", [(8, 4), (13, 4), (40, 16), (33, 8), (5, 16)])
def test_block_frac_bits_match_reference(width, k, block_size):
    x = np.random.default_rng(k).standard_normal((k, 3)).astype(np.float32)
    _same(tq.block_frac_bits(torch.from_numpy(x), width, block_size),
          jq.block_frac_bits(jnp.asarray(x), width, block_size))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("block_size", [None, 4, 8, 16])
@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 37.0), (3, 1e3)])
def test_quantize_tensor_packed_matches_reference(width, block_size, seed, scale):
    """Codes, exponents, packed bytes and dequantized values, over a K that
    no block divides; tiny and large ranges put n past |n| = 12."""
    x = (np.random.default_rng(seed).standard_normal((19, 3)) * scale).astype(np.float32)
    got = tq.quantize_tensor_packed(torch.from_numpy(x), width, block_size=block_size)
    want = jq.quantize_tensor_packed(jnp.asarray(x), width, block_size=block_size)
    _same(got.q, want.q)
    _same(got.n, want.n)
    assert (got.width, got.k, got.block_size, got.shape) == (want.width, want.k,
                                                            want.block_size, want.shape)
    assert (got.nbytes_packed, got.nbytes_model) == (want.nbytes_packed, want.nbytes_model)
    _same(got.unpack(), want.unpack())
    np.testing.assert_array_equal(_bits(got.scales().numpy()),
                                  _bits(np.broadcast_to(want.scales(), got.scales().shape)))
    np.testing.assert_array_equal(_bits(got.dequantize().numpy()), _bits(want.dequantize()))
    # the error stays under one grid step (test_subint8_properties.py:74-92)
    err = np.abs(got.dequantize().numpy() - x)
    assert (err < np.broadcast_to(got.scales().numpy(), err.shape) + 1e-12).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("per_channel", [True, False])
def test_per_channel_and_per_tensor_packed_match_reference(width, per_channel):
    x = np.random.default_rng(width).standard_normal((2, 11, 4)).astype(np.float32)
    got = tq.quantize_tensor_packed(torch.from_numpy(x), width, per_channel=per_channel)
    want = jq.quantize_tensor_packed(jnp.asarray(x), width, per_channel=per_channel)
    _same(got.q, want.q)
    _same(got.n, want.n)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    if per_channel:   # the same value grid as the unpacked QTensor route
        plain = tq.quantize_tensor(torch.from_numpy(x), width, channel_axis=(0, -1))
        torch.testing.assert_close(got.unpack(), plain.q, rtol=0, atol=0)


@pytest.mark.parametrize("width", WIDTHS)
def test_saturation_and_zero_blocks_match_reference(width):
    q = tq.quantize(torch.tensor([[1e6], [-1e6]]), 0, width)
    assert q.tolist() == [[tq.qmax(width)], [tq.qmin(width)]]
    _same(tq.unpack_subint8(tq.pack_subint8(q, width), width, 2), q.numpy())
    got = tq.quantize_tensor_packed(torch.zeros(8, 2), width, block_size=4)
    want = jq.quantize_tensor_packed(jnp.zeros((8, 2), jnp.float32), width, block_size=4)
    _same(got.n, want.n)
    assert int(got.n.max()) == tq.N_MAX and not got.q.any()
    assert not got.dequantize().any()


def test_partial_trailing_block_ignores_padding():
    """test_subint8_properties.py:147: the short last block is ranged over
    its real rows only."""
    x = np.concatenate([np.full((4, 1), 0.01, np.float32), np.full((2, 1), 5.0, np.float32)])
    got = tq.quantize_tensor_packed(torch.from_numpy(x), 4, block_size=4)
    want = jq.quantize_tensor_packed(jnp.asarray(x), 4, block_size=4)
    _same(got.n, want.n)
    _same(got.q, want.q)


@pytest.mark.parametrize("width,block_size", [(4, 3), (2, 2), (2, 6)])
def test_block_size_must_respect_lane_count(width, block_size):
    with pytest.raises(ValueError, match="block_size must be a positive multiple"):
        tq.quantize_tensor_packed(torch.ones(8, 2), width, block_size=block_size)
    with pytest.raises(ValueError, match="block_size must be a positive multiple"):
        jq.quantize_tensor_packed(jnp.ones((8, 2), jnp.float32), width, block_size=block_size)
    with pytest.raises(ValueError, match="ndim >= 2"):
        tq.quantize_tensor_packed(torch.ones(8), width)


# --------------------------------------------------------------------------
# PackedQTensor in parameter trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [None, 8])
def test_stacked_packed_leaf_slices_per_layer(block_size):
    x = np.random.default_rng(4).standard_normal((3, 20, 6)).astype(np.float32)
    want = jq.quantize_tensor_packed(jnp.asarray(x), 4, block_size=block_size)
    got = params_from_numpy({"w": {"kernel": want}}, "cpu")["w"]["kernel"]
    assert isinstance(got, tq.PackedQTensor) and got.block_size == block_size
    _same(got.q, want.q)
    for i in range(3):
        layer = tree_layer({"kernel": got}, i)["kernel"]
        assert layer.q.shape == (10, 6) and layer.shape == (20, 6)
        np.testing.assert_array_equal(layer.dequantize().numpy(),
                                      np.asarray(want.dequantize())[i])
        single = tq.quantize_tensor_packed(torch.from_numpy(x[i]), 4, block_size=block_size)
        torch.testing.assert_close(layer.q, single.q, rtol=0, atol=0)
        torch.testing.assert_close(layer.scale, single.scale, rtol=0, atol=0)
    moved = tree_to({"kernel": got}, "cpu")["kernel"]
    assert isinstance(moved, tq.PackedQTensor) and moved.k == 20


def test_convert_takes_packed_leaves_as_dicts():
    want = jq.quantize_tensor_packed(jnp.ones((5, 3), jnp.float32), 2, block_size=4)
    leaf = {"q": np.asarray(want.q), "n": np.asarray(want.n), "width": 2, "k": 5,
            "block_size": 4}
    got = params_from_numpy({"kernel": leaf}, "cpu")["kernel"]
    assert isinstance(got, tq.PackedQTensor) and (got.width, got.k, got.block_size) == (2, 5, 4)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    jqt = jq.quantize_tensor(jnp.ones((5, 3), jnp.float32), 8, channel_axis=1)
    assert isinstance(params_from_numpy(jqt, "cpu"), tq.QTensor)


# --------------------------------------------------------------------------
# integerize_weights_only on the smoke model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    to_np = jax.tree_util.tree_map(np.asarray, jp)
    get_config("smollm-135m-smoke")   # the port knows the config
    return jp, params_from_numpy(to_np, "cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("bits,block_size", [(16, None), (8, None), (4, None), (4, 32),
                                             (2, None), (2, 32)],
                         ids=["int16", "int8", "int4", "int4-block", "int2", "int2-block"])
def test_integerize_weights_only_matches_reference(smoke_params, bits, block_size):
    """Every leaf's kind, codes, exponents and layout equal repro's.  At 16
    bits the smoke model's exponents are 15-17: exact powers of two would
    move 371 of its codes."""
    jp, tp = smoke_params
    want = j_integerize.integerize_weights_only(jp, bits=bits, block_size=block_size)
    got = integerize_weights_only(tp, bits=bits, block_size=block_size)
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(gl) == sorted(wl)
    kinds = set()
    for path, w in wl.items():
        g = gl[path]
        if isinstance(w, jq.PackedQTensor):
            assert isinstance(g, tq.PackedQTensor), path
            assert (g.width, g.k, g.block_size) == (w.width, w.k, w.block_size), path
        elif isinstance(w, jq.QTensor):
            assert isinstance(g, tq.QTensor) and g.channel_axis == w.channel_axis, path
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        kinds.add((path.rsplit("/", 1)[-1], type(g).__name__))
        _same(g.q, w.q)
        _same(g.n, w.n)
    packed = bits in (2, 4)
    assert kinds == {("table", "QTensor"),
                     ("kernel", "PackedQTensor" if packed else "QTensor")}
