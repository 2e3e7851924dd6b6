"""Port parity: layers, attention over an int8 cache and the smoke LM's
logits and cache bytes, from the same numpy inputs and converted params."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.core.qformat import QTensor as JQ
from repro.models.registry import get_config as j_get_config
from repro.nn import attention as j_attn
from repro.nn.layers import Dense as JDense
from repro.nn.layers import Embedding as JEmbedding
from repro.nn.layers import RMSNorm as JRMSNorm
from repro.nn.module import Context as JContext
from repro_torch.convert import params_from_numpy
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.models.registry import get_config
from repro_torch.nn import attention as t_attn
from repro_torch.nn.layers import Dense, Embedding, RMSNorm
from repro_torch.nn.module import Context

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5


def to_numpy(tree):
    """The reference's tree as numpy leaves; QTensors become q/n/width dicts."""
    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_float_and_weight_only(quantized, bias):
    rng = np.random.default_rng(1)
    p = {"kernel": rng.normal(0, 0.2, (24, 13)).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(0, 0.1, (13,)).astype(np.float32)
    x = rng.normal(0, 1, (2, 5, 24)).astype(np.float32)
    jp = j_integerize(p) if quantized else p
    tp = params_from_numpy(to_numpy(jp), "cpu")
    want = JDense(24, 13, use_bias=bias).apply(jp, jnp.asarray(x), JContext())
    got = Dense(24, 13, use_bias=bias).apply(tp, torch.from_numpy(x), Context())
    close(got, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_embedding_gather_and_tied_logits(quantized):
    rng = np.random.default_rng(2)
    p = {"table": rng.normal(0, 0.3, (50, 16)).astype(np.float32)}
    jp = j_integerize(p) if quantized else p
    tp = params_from_numpy(to_numpy(jp), "cpu")
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    x = rng.normal(0, 1, (3, 2, 16)).astype(np.float32)
    je, te = JEmbedding(50, 16), Embedding(50, 16)
    np.testing.assert_array_equal(te.apply(tp, torch.from_numpy(ids), Context()).numpy(),
                                  np.asarray(je.apply(jp, jnp.asarray(ids), JContext())))
    close(te.attend(tp, torch.from_numpy(x), Context()),
          je.attend(jp, jnp.asarray(x), JContext()))


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 6, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (16,)).astype(np.float32)
    close(RMSNorm(16).apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), Context()),
          JRMSNorm(16).apply({"scale": jnp.asarray(scale)}, jnp.asarray(x), JContext()))
    h = rng.normal(0, 1, (2, 6, 3, 16)).astype(np.float32)
    for pos in (np.arange(6), np.arange(40, 46)):
        close(t_attn.apply_rope(torch.from_numpy(h), torch.from_numpy(pos)),
              j_attn.apply_rope(jnp.asarray(h), jnp.asarray(pos)))


def _attn_params(rng, d, hq, hkv, hd, quantized):
    p = {nm: {"kernel": rng.normal(0, 0.25, (d, o)).astype(np.float32)}
         for nm, o in (("wq", hq * hd), ("wk", hkv * hd), ("wv", hkv * hd))}
    p["wo"] = {"kernel": rng.normal(0, 0.25, (hq * hd, d)).astype(np.float32)}
    return j_integerize(p) if quantized else p


@pytest.mark.parametrize("quantized_kv", [False, True])
@pytest.mark.parametrize("weight_quant", [False, True])
def test_attention_prefill_then_decode_over_cache(quantized_kv, weight_quant):
    """Prefill-into-cache (causal from the pre-write length, over the
    dequantized cache) then two decode steps, against the reference."""
    d, hq, hkv, hd, b, s_max = 32, 4, 2, 8, 2, 16
    rng = np.random.default_rng(4)
    jp = _attn_params(rng, d, hq, hkv, hd, weight_quant)
    tp = params_from_numpy(to_numpy(jp), "cpu")
    ja = j_attn.Attention(d, hq, hkv, hd)
    ta = t_attn.Attention(d, hq, hkv, hd)
    jc = j_attn.init_kv_cache(b, s_max, hkv, hd, quantized=quantized_kv, dtype=jnp.float32)
    tc = t_attn.init_kv_cache(b, s_max, hkv, hd, quantized=quantized_kv, device="cpu")
    for s in (5, 1, 1):
        x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
        jy, jc = ja.apply(jp, jnp.asarray(x), JContext(), cache=jc, decode=True)
        ty, tc = ta.apply(tp, torch.from_numpy(x), Context(), cache=tc, decode=True)
        close(ty, jy)
        assert tc["len"] == int(jc["len"])
        if quantized_kv:
            diff = np.abs(tc["k"].numpy().astype(int) - np.asarray(jc["k"]).astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        else:
            close(tc["k"], jc["k"])


def test_decode_attention_int8_per_slot_lengths():
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (3, 1, 6, 8)).astype(np.float32)
    k, v = (np.clip(np.rint(rng.normal(0, 8, (3, 11, 2, 8))), -128, 127).astype(np.int8)
            for _ in range(2))
    lens = np.asarray([11, 1, 6], np.int32)
    want = j_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(lens), k_n=jnp.int32(3), v_n=jnp.int32(3))
    got = t_attn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(lens), k_n=3, v_n=3)
    close(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    """The smoke LM from the reference's init, converted for the port."""
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_config("smollm-135m-smoke").build()
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (3, 9), 0, 503,
                                         dtype=jnp.int32))
    return jm, jp, tm, params_from_numpy(to_numpy(jp), "cpu"), tokens


@pytest.mark.parametrize("weight_quant", [False, True])
def test_smoke_lm_logits_without_cache(smoke, weight_quant):
    jm, jp, tm, tp, tokens = smoke
    if weight_quant:
        jp, tp = j_integerize(jp), integerize_weights_only(tp)
    want, _ = jm.apply(jp, jnp.asarray(tokens), JContext())
    got, _ = tm.apply(tp, torch.from_numpy(tokens), Context())
    assert got.shape == (3, 9, 512)
    close(got, want)


@pytest.mark.parametrize("quantized_kv", [False, True])
@pytest.mark.parametrize("weight_quant", [False, True])
def test_smoke_lm_prefill_logits_and_cache(smoke, weight_quant, quantized_kv):
    jm, jp, tm, tp, tokens = smoke
    if weight_quant:
        jp, tp = j_integerize(jp), integerize_weights_only(tp)
    jc = jm.init_cache(3, 16, quantized_kv=quantized_kv, kv_dtype=jnp.float32)
    tc = tm.init_cache(3, 16, quantized_kv=quantized_kv, device="cpu")
    want, jc = jm.apply(jp, jnp.asarray(tokens), JContext(), cache=jc, decode=True)
    got, tc = tm.apply(tp, torch.from_numpy(tokens), Context(), cache=tc, decode=True)
    close(got, want)
    jk, tk = np.asarray(jc["body"][0]["kv"]["k"]), tc["body"][0]["kv"]["k"].numpy()
    assert tk.shape == jk.shape and tc["body"][0]["kv"]["len"] == 9
    if quantized_kv:
        for name in ("k", "v"):
            a = tc["body"][0]["kv"][name].numpy().astype(int)
            b = np.asarray(jc["body"][0]["kv"][name]).astype(int)
            assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999
    else:
        close(tk, jk)
    step = np.asarray([[7], [100], [502]], np.int32)
    want, _ = jm.apply(jp, jnp.asarray(step), JContext(), cache=jc, decode=True)
    got, _ = tm.apply(tp, torch.from_numpy(step), Context(), cache=tc, decode=True)
    close(got, want)


def test_model_init_is_seeded_and_shaped():
    tm = get_config("smollm-135m-smoke").build()
    a = tm.init(torch.Generator().manual_seed(3), "cpu")
    b = tm.init(torch.Generator().manual_seed(3), "cpu")
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jm.init(jax.random.PRNGKey(0)))
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    assert tshapes == jshapes
    torch.testing.assert_close(a["stack"]["body"][0]["ffn"]["w_in"]["kernel"],
                               b["stack"]["body"][0]["ffn"]["w_in"]["kernel"], rtol=0, atol=0)
    w = a["stack"]["body"][0]["mixer"]["wq"]["kernel"]
    assert w.abs().max() <= 2.0 / 64 ** 0.5 + 1e-6          # truncated at two std


def test_convert_takes_qtensor_objects_and_dicts():
    """A quantized leaf converts from the reference's QTensor itself or from
    a q/n/width dict, and both give the same port QTensor."""
    rng = np.random.default_rng(6)
    jp = j_integerize({"w": {"kernel": rng.normal(0, 1, (2, 6, 5)).astype(np.float32)},
                       "e": {"table": rng.normal(0, 1, (9, 4)).astype(np.float32)}})
    from_objects = params_from_numpy(jp, "cpu")
    from_dicts = params_from_numpy(to_numpy(jp), "cpu")
    for a, b, w in ((from_objects["w"]["kernel"], from_dicts["w"]["kernel"], jp["w"]["kernel"]),
                    (from_objects["e"]["table"], from_dicts["e"]["table"], jp["e"]["table"])):
        for got in (a, b):
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(got.n.numpy(), np.asarray(w.n))
            assert got.channel_axis == w.channel_axis and got.width == 8
            np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(w.dequantize()))
