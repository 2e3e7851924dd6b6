"""Port parity: Qm.n math and weight integerization, bit-exact against repro."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qformat as jq
from repro.core.integerize import integerize_weights_only as j_integerize
from repro_torch.convert import params_from_numpy
from repro_torch.core import qformat as tq
from repro_torch.core.integerize import integerize_weights_only as t_integerize

torch.set_num_threads(2)


def _edge_values():
    """Powers of two across the exponent clamp and their float neighbours."""
    vals = [0.0]
    for k in range(-34, 34):
        p = np.float32(2.0) ** k
        v_lo = v_hi = p
        vals.append(p)
        for _ in range(3):
            v_lo = np.nextafter(v_lo, np.float32(0))
            v_hi = np.nextafter(v_hi, np.float32(np.inf))
            vals += [v_lo, v_hi]
    return np.asarray(vals, np.float32)


def test_integer_bits_and_frac_bits_match_at_powers_of_two():
    x = _edge_values()
    want_m = np.asarray(jq.integer_bits(jnp.asarray(x)))
    got_m = tq.integer_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got_m, want_m)
    for width in (8, 9, 16):
        np.testing.assert_array_equal(
            tq.frac_bits_for(torch.from_numpy(x), width).numpy(),
            np.asarray(jq.frac_bits_for(jnp.asarray(x), width)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frac_bits_match_on_random_ranges(seed):
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(-25, 25, 50_000)).astype(np.float32)
    np.testing.assert_array_equal(tq.frac_bits_for(torch.from_numpy(x), 8).numpy(),
                                  np.asarray(jq.frac_bits_for(jnp.asarray(x), 8)))


@pytest.mark.parametrize("width", [8, 9, 16])
def test_quantize_trunc_and_saturation_edges(width):
    qmax = 2 ** (width - 1) - 1
    edges = [0.0, 0.49, 0.5, 0.99, 1.0, 1.01, -0.5, -0.99, -1.0, -1.5, qmax - 0.5,
             qmax, qmax + 0.5, qmax + 1, -qmax - 1, -qmax - 1.5, -qmax - 2, 1e9, -1e9]
    x = np.concatenate([np.asarray(edges, np.float32),
                        np.random.default_rng(width).normal(0, 40, 4096).astype(np.float32)])
    for n in (-3, 0, 3, 7):
        x_n = (x * np.float32(2.0 ** -n)).astype(np.float32)
        want = np.asarray(jq.quantize(jnp.asarray(x_n), jnp.int32(n), width))
        got = tq.quantize(torch.from_numpy(x_n), torch.tensor(n, dtype=torch.int32), width)
        assert got.dtype == tq.storage_dtype(width)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tq.quantize(torch.from_numpy(x_n), n, width).numpy(), want)
        np.testing.assert_array_equal(
            tq.dequantize(got, n).numpy(),
            np.asarray(jq.dequantize(jnp.asarray(want), jnp.int32(n))))


@pytest.mark.parametrize("channel_axis", [None, 1, (0, 2)])
def test_quantize_tensor_granularities(channel_axis):
    x = np.random.default_rng(3).normal(0, 0.3, (3, 20, 12)).astype(np.float32)
    x[1] *= 8.0                                   # one layer with a wider range
    x = x if channel_axis != 1 else x[0]
    want = jq.quantize_tensor(jnp.asarray(x), 8, channel_axis=channel_axis)
    got = tq.quantize_tensor(torch.from_numpy(x), 8, channel_axis=channel_axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    assert got.channel_axis == want.channel_axis
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


def _tree(rng):
    """A serving param tree: stacked block leaves, a table, norms to skip."""
    return {
        "embed": {"table": rng.normal(0, 0.1, (40, 16)).astype(np.float32)},
        "stack": {"body": [{
            "norm1": {"scale": np.ones((3, 16), np.float32)},
            "mixer": {"wq": {"kernel": rng.normal(0, 0.25, (3, 16, 24)).astype(np.float32)}},
            "ffn": {"w_out": {"kernel": rng.normal(0, 2.0, (3, 32, 16)).astype(np.float32)}},
        }]},
        "final_norm": {"scale": rng.uniform(0.5, 2, (16,)).astype(np.float32)},
    }


@pytest.mark.parametrize("per_channel", [True, False])
def test_integerize_weights_only_bit_exact(per_channel):
    tree = _tree(np.random.default_rng(4))
    want = j_integerize(tree, per_channel=per_channel)
    got = t_integerize(params_from_numpy(tree, "cpu"), per_channel=per_channel)
    pairs = [(got["embed"]["table"], want["embed"]["table"]),
             (got["stack"]["body"][0]["mixer"]["wq"]["kernel"],
              want["stack"]["body"][0]["mixer"]["wq"]["kernel"]),
             (got["stack"]["body"][0]["ffn"]["w_out"]["kernel"],
              want["stack"]["body"][0]["ffn"]["w_out"]["kernel"])]
    for g, w in pairs:
        assert isinstance(g, tq.QTensor) and isinstance(w, jq.QTensor)
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.n.numpy(), np.asarray(w.n))
        assert g.channel_axis == w.channel_axis
    # norms stay float, untouched
    assert isinstance(got["stack"]["body"][0]["norm1"]["scale"], torch.Tensor)
    assert isinstance(got["final_norm"]["scale"], torch.Tensor)
    # a stacked leaf slices into per-layer views with per-layer exponents
    layer = got["stack"]["body"][0]["ffn"]["w_out"]["kernel"].layer(1)
    np.testing.assert_array_equal(layer.dequantize().numpy(),
                                  np.asarray(want["stack"]["body"][0]["ffn"]["w_out"]["kernel"]
                                             .dequantize())[1])


def test_integerize_refuses_sub_int8():
    """Packed widths take only block sizes that are whole multiples of the
    byte's lane count; both packages refuse the rest with the same error."""
    for bits, block_size in ((4, 3), (2, 2)):
        msg = f"block_size must be a positive multiple of {8 // bits}"
        with pytest.raises(ValueError, match=msg):
            t_integerize({"w": {"kernel": torch.zeros(4, 4)}}, bits=bits, block_size=block_size)
        with pytest.raises(ValueError, match=msg):
            j_integerize({"w": {"kernel": jnp.zeros((4, 4), jnp.float32)}}, bits=bits,
                         block_size=block_size)
