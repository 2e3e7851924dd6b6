"""Port parity for chunked prefill: the plain ``qchunk_attn`` against repro's
oracle and Pallas kernel (interpret mode), the per-slot cache functions of
``nn/attention.py`` against repro's, and the attention layer's chunk path.

The CUDA kernel runs only on the card: ``test_cuda_kernel_qchunk_attn_*``
carries the ``cuda`` marker and skips without one (``chip_smoke.py`` holds
the kernel to its plain version there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.nn import attention as j_attn
from repro.nn.module import Context as JContext
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as t_attn
from repro_torch.nn.module import Context

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _inputs(c, g, hkv, d, s, b, seed):
    """Chunk q/k/v with some values past the Q-grid's range (saturation) and
    int8 cache codes with the spread of post-norm K/V."""
    rng = np.random.default_rng(seed)
    hq = g * hkv
    q = rng.normal(0, 1, (c, hq, d)).astype(np.float32)
    kc, vc = (rng.normal(0, 1.5, (c, hkv, d)).astype(np.float32) for _ in range(2))
    kc.reshape(-1)[::31] = 9.0
    vc.reshape(-1)[::37] = -9.0
    kcache, vcache = (np.clip(np.rint(rng.normal(0, 24, (b, s, hkv, d))), -128, 127)
                      .astype(np.int8) for _ in range(2))
    return q, kc, vc, kcache, vcache


# the four cases of tests/test_kernels.py::test_qchunk_attn_matches_ref, and
# a chunk that does not divide the cache length
CASES = [(8, 2, 2, 32, 128, 1, 32), (16, 1, 4, 32, 256, 0, 0), (5, 3, 2, 16, 96, 2, 50),
         (1, 2, 2, 64, 128, 1, 64), (6, 2, 2, 16, 70, 1, 30)]


@pytest.mark.parametrize("c,g,hkv,d,s,slot,start", CASES)
def test_plain_qchunk_attn_matches_oracle_and_pallas(c, g, hkv, d, s, slot, start,
                                                     monkeypatch):
    q, kc, vc, kcache, vcache = _inputs(c, g, hkv, d, s, 3, seed=c * s + start)
    tk, tv = torch.from_numpy(kcache.copy()), torch.from_numpy(vcache.copy())
    got = ref.qchunk_attn_ref(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                              tk, tv, 5, 6, slot, start).numpy()
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcache),
            jnp.asarray(vcache), jnp.int32(5), jnp.int32(6))
    wo, wk, wv = j_ref.qchunk_attn_ref(*args, slot, start)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    np.testing.assert_allclose(got, np.asarray(wo), rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(j_ops, "FORCE", "interpret")
    po, pk, pv = j_ops.qchunk_attn(*args, jnp.int32(slot), jnp.int32(start))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(pv))
    np.testing.assert_allclose(got, np.asarray(po), rtol=RTOL, atol=ATOL)
    # only rows [start, start+C) of the target slot changed
    keep = np.ones((3, s), bool)
    keep[slot, start:start + c] = False
    np.testing.assert_array_equal(tk.numpy()[keep], kcache[keep])


def test_plain_qchunk_single_query_is_a_decode_step():
    q, kc, vc, kcache, vcache = _inputs(1, 2, 2, 32, 50, 2, seed=8)
    tk, tv = torch.from_numpy(kcache), torch.from_numpy(vcache)
    out = ref.qchunk_attn_ref(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                              tk, tv, 5, 5, 1, 20)
    dec = ref.qdecode_attn_ref(torch.from_numpy(q).expand(2, 4, 32), tk, tv, 5, 5,
                               torch.tensor([0, 21], dtype=torch.int32))
    torch.testing.assert_close(out[0], dec[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slot,start,c", [(3, 0, 4), (-1, 0, 4), (0, -1, 4), (0, 8, 4),
                                          (1, 11, 1)])
def test_qchunk_attn_refuses_a_chunk_outside_the_cache(slot, start, c):
    q, kc, vc, kcache, vcache = _inputs(c, 2, 2, 16, 11, 3, seed=1)
    tk = torch.from_numpy(kcache.copy())
    with pytest.raises(ValueError, match="does not fit"):
        ops.qchunk_attn(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                        tk, torch.from_numpy(vcache), 3, 3, slot, start)
    np.testing.assert_array_equal(tk.numpy(), kcache)     # nothing was written


# --------------------------------------------------------------------------
# Per-slot cache functions
# --------------------------------------------------------------------------

def _caches(quantized, b, s, hkv, d, lens, seed):
    """The same per-slot cache for both packages, rows filled with codes."""
    rng = np.random.default_rng(seed)
    jc = j_attn.init_kv_cache(b, s, hkv, d, quantized=quantized, dtype=jnp.float32,
                              per_slot_len=True)
    tc = t_attn.init_kv_cache(b, s, hkv, d, quantized=quantized, device="cpu",
                              per_slot_len=True)
    for name in ("k", "v"):
        if quantized:
            x = rng.integers(-128, 128, (b, s, hkv, d)).astype(np.int8)
        else:
            x = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
        jc[name] = jnp.asarray(x)
        tc[name] = torch.from_numpy(x.copy())
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    return jc, tc


def _same(tc, jc):
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("s_new", [1, 2])
def test_per_slot_update_kv_cache_clamps_past_max_len(quantized, s_new):
    """Each slot writes at its own offset; slots at or past the end write
    their rows early enough to fit (the reference's dynamic_update_slice)."""
    b, s, hkv, d = 4, 9, 2, 8
    jc, tc = _caches(quantized, b, s, hkv, d, [0, 3, 8, 12], seed=s_new)
    rng = np.random.default_rng(10 + s_new)
    k, v = (rng.normal(0, 2, (b, s_new, hkv, d)).astype(np.float32) for _ in range(2))
    jc = j_attn.update_kv_cache(jc, jnp.asarray(k), jnp.asarray(v))
    tc = t_attn.update_kv_cache(tc, torch.from_numpy(k), torch.from_numpy(v))
    _same(tc, jc)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_reset_write_and_set_slot_len_match_reference(quantized):
    b, s, hkv, d = 3, 10, 2, 8
    jc, tc = _caches(quantized, b, s, hkv, d, [4, 7, 2], seed=5)
    jc, tc = j_attn.reset_kv_slot(jc, 1), t_attn.reset_kv_slot(tc, 1)
    _same(tc, jc)
    js, ts = _caches(quantized, 1, s, hkv, d, [0], seed=6)
    jc = j_attn.write_kv_slot(jc, js, jnp.int32(2), jnp.int32(6))
    tc = t_attn.write_kv_slot(tc, ts, 2, 6)
    _same(tc, jc)
    np.testing.assert_array_equal(
        t_attn.set_kv_slot_len(tc["len"], 0, 9).numpy(),
        np.asarray(j_attn.set_kv_slot_len(jc["len"], jnp.int32(0), jnp.int32(9))))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("start,length", [(0, 5), (4, 3), (7, 5)])
def test_append_kv_chunk_matches_reference(quantized, start, length):
    b, s, hkv, d, c = 3, 12, 2, 8, 5
    jc, tc = _caches(quantized, b, s, hkv, d, [3, 9, 4], seed=start)
    rng = np.random.default_rng(start + length)
    k, v = (rng.normal(0, 2, (1, c, hkv, d)).astype(np.float32) for _ in range(2))
    jc = j_attn.append_kv_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                j_attn.KVChunk(jnp.int32(2), jnp.int32(start),
                                               jnp.int32(length)))
    tc = t_attn.append_kv_chunk(tc, torch.from_numpy(k), torch.from_numpy(v),
                                t_attn.KVChunk(2, start, length))
    _same(tc, jc)


def test_append_kv_chunk_refuses_a_chunk_past_the_end():
    _, tc = _caches(False, 2, 8, 1, 4, [0, 0], seed=0)
    k = torch.zeros(1, 3, 1, 4)
    with pytest.raises(ValueError, match="does not fit"):
        t_attn.append_kv_chunk(tc, k, k, t_attn.KVChunk(1, 6, 3))


@pytest.mark.parametrize("start", [0, 3, 9])
def test_float_chunk_attention_matches_reference(start):
    b, s, hkv, g, d, c = 2, 14, 2, 3, 8, 5
    jc, tc = _caches(False, b, s, hkv, d, [start, 0], seed=start)
    q = np.random.default_rng(start).normal(0, 1, (1, c, g * hkv, d)).astype(np.float32)
    want = j_attn.chunk_attention(jnp.asarray(q), jc, jnp.int32(0), jnp.int32(start),
                                  block_kv=4)
    got = t_attn.chunk_attention(torch.from_numpy(q), tc, 0, start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_chunk_attention_sends_int8_caches_to_the_kernel():
    _, tc = _caches(True, 1, 6, 1, 4, [0], seed=0)
    with pytest.raises(ValueError, match="qchunk_attn"):
        t_attn.chunk_attention(torch.zeros(1, 2, 1, 4), tc, 0, 0)


# --------------------------------------------------------------------------
# The attention layer's chunk and per-slot decode paths
# --------------------------------------------------------------------------

def _attn_params(rng, d, hq, hkv, hd, quantized):
    p = {nm: {"kernel": rng.normal(0, 0.25, (d, n)).astype(np.float32)}
         for nm, n in (("wq", hq * hd), ("wk", hkv * hd), ("wv", hkv * hd))}
    p["wo"] = {"kernel": rng.normal(0, 0.25, (hq * hd, d)).astype(np.float32)}
    return j_integerize(p) if quantized else p


def _to_numpy(tree):
    from repro.core.qformat import QTensor as JQ

    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("weight_quant", [False, True], ids=["f32w", "int8w"])
def test_attention_chunks_then_per_slot_decode(quantized_kv, weight_quant):
    """Two chunks into slot 1 (the second one partial), then a per-slot
    decode step over all slots, against the reference layer."""
    d, hq, hkv, hd, b, s_max, c = 32, 4, 2, 8, 3, 24, 6
    rng = np.random.default_rng(7)
    jp = _attn_params(rng, d, hq, hkv, hd, weight_quant)
    tp = params_from_numpy(_to_numpy(jp), "cpu")
    ja, ta = j_attn.Attention(d, hq, hkv, hd), t_attn.Attention(d, hq, hkv, hd)
    jc = j_attn.init_kv_cache(b, s_max, hkv, hd, quantized=quantized_kv, dtype=jnp.float32,
                              per_slot_len=True)
    tc = t_attn.init_kv_cache(b, s_max, hkv, hd, quantized=quantized_kv, device="cpu",
                              per_slot_len=True)
    jc["len"] = jnp.asarray([5, 0, 2], jnp.int32)
    tc["len"] = torch.tensor([5, 0, 2], dtype=torch.int32)
    for start, length in ((0, c), (c, 4)):
        x = rng.normal(0, 1, (1, c, d)).astype(np.float32)
        jy, jc = ja.apply(jp, jnp.asarray(x), JContext(), cache=jc, decode=True,
                          chunk=j_attn.KVChunk(jnp.int32(1), jnp.int32(start),
                                               jnp.int32(length)))
        ty, tc = ta.apply(tp, torch.from_numpy(x), Context(), cache=tc, decode=True,
                          chunk=t_attn.KVChunk(1, start, length))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    x = rng.normal(0, 1, (b, 1, d)).astype(np.float32)
    jy, jc = ja.apply(jp, jnp.asarray(x), JContext(), cache=jc, decode=True)
    ty, tc = ta.apply(tp, torch.from_numpy(x), Context(), cache=tc, decode=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if quantized_kv:
        diff = np.abs(tc["k"].numpy().astype(int) - np.asarray(jc["k"]).astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    else:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5,
                                   atol=1e-5)


def test_attention_refuses_multi_token_prefill_into_a_per_slot_cache():
    ta = t_attn.Attention(16, 2, 1, 8)
    tp = params_from_numpy(_to_numpy(_attn_params(np.random.default_rng(0), 16, 2, 1, 8,
                                                  False)), "cpu")
    tc = t_attn.init_kv_cache(2, 8, 1, 8, quantized=False, device="cpu", per_slot_len=True)
    with pytest.raises(NotImplementedError, match="chunked path"):
        ta.apply(tp, torch.zeros(2, 3, 16), Context(), cache=tc, decode=True)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("c,start,s,g,d", [(32, 96, 192, 3, 64), (32, 1984, 2048, 3, 64),
                                           (16, 100, 192, 3, 64), (32, 0, 2048, 3, 64),
                                           (32, 1000, 2048, 3, 64), (1, 2000, 2048, 3, 64),
                                           (16, 1500, 2048, 3, 64), (32, 1000, 2048, 3, 16),
                                           (32, 1000, 2048, 3, 128), (32, 1000, 2048, 16, 64)])
def test_cuda_kernel_qchunk_attn_matches_plain(c, start, s, g, d):
    """The chunk core at the serving cache and at S=2048 (a cluster of 8
    ranks, which end early on the causal limit at start 0), C = 1, 16, 32,
    D = 16, 64, 128 and G = 3, 16."""
    _need_card()
    from repro_torch.kernels.qchunk_attn import qchunk_attn_cuda

    q, kc, vc, kcache, vcache = (torch.from_numpy(a).cuda()
                                 for a in _inputs(c, g, 3, d, s, 8, seed=s + start))
    kk, vk, kp, vp = kcache.clone(), vcache.clone(), kcache.clone(), vcache.clone()
    got = qchunk_attn_cuda(q, kc, vc, kk, vk, 3, 3, 5, start)
    want = ref.qchunk_attn_ref(q, kc, vc, kp, vp, 3, 3, 5, start)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
