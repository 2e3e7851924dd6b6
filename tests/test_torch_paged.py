"""Port parity for the paged KV cache: the plain ``qpaged_decode_attn`` and
``qpaged_chunk_attn`` against repro's oracles and Pallas kernels (interpret
mode) at the shapes of ``tests/test_paged.py``, the paged cache functions of
``nn/attention.py`` against repro's, and one paged decode step and one
paged mixed step of the smoke model against repro's (logits and pools).

Tolerances: pools, tables and lengths are integers and bit-identical;
attention outputs and logits are held at rtol 1e-5 / atol 1e-5, as
``tests/test_paged.py`` holds the Pallas kernels to their oracles (codes
up to +-100, outputs up to about 10) and ``test_torch_model.py`` the
logits.  After a model step the int8 pools hold codes of K/V that the two
frameworks computed in another order, so, as in ``test_torch_model.py``, a
code may sit one step off at a truncation edge.

Slots with ``kv_len == 0`` are left out of the kernel cases: there the
Pallas kernel averages pool page 0's rows and the oracle every gathered
row, so the reference has no one answer, and the scheduler masks those rows.

The CUDA kernels run only on the card: ``test_cuda_kernel_qpaged_*`` carry
the ``cuda`` marker and skip without one (``chip_smoke.py`` holds the
kernels to their plain versions there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.qpaged_attn import qpaged_chunk_attn_pallas, qpaged_decode_attn_pallas
from repro.models.registry import get_config as j_get_config
from repro.nn import attention as j_attn
from repro.nn.module import Context as JContext
from repro.serve import slot_state as j_slots
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import get_config
from repro_torch.nn import attention as t_attn
from repro_torch.nn.module import Context
from repro_torch.serve import slot_state as t_slots

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5


def _codes(rng, shape):
    return rng.integers(-100, 100, shape).astype(np.int8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# The plain kernels against the reference's oracles and Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ps,n_pool,mp", [(4, 10, 5), (8, 8, 3), (1, 20, 9), (5, 9, 3)])
def test_plain_qpaged_decode_matches_oracle_and_pallas(ps, n_pool, mp):
    """test_paged.py:89-112's fragmented, out-of-order table, plus a slot
    whose length ran past its table and an evicted slot (row all -1, len
    > 0) that reads pool page 0."""
    rng = np.random.default_rng(ps)
    b, hq, hkv, d = 5, 4, 2, 8
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    kp, vp = _codes(rng, (n_pool, ps, hkv, d)), _codes(rng, (n_pool, ps, hkv, d))
    perm = rng.permutation(n_pool)
    table = np.full((b, mp), -1, np.int32)
    table[0, :min(3, mp)] = perm[:min(3, mp)]
    table[1, :1] = perm[3:4]
    table[2, :mp] = perm[4:4 + mp]
    table[3, :mp] = perm[::-1][:mp]
    lens = np.asarray([min(2 * ps + 3, min(3, mp) * ps), 2, mp * ps, mp * ps + 7, 3], np.int32)
    got = ref.qpaged_decode_attn_ref(*_t(q, kp, vp), 3, 4, *_t(table, lens)).numpy()
    want = j_ref.qpaged_decode_attn_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), 3, 4,
                                        jnp.asarray(table), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    pallas = qpaged_decode_attn_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.int32(3), jnp.int32(4), jnp.asarray(table),
                                       jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ops.qpaged_decode_attn(*_t(q, kp, vp), 3, 4, *_t(table, lens)).numpy(), got)


def _chunk_inputs(c, hq, hkv, d, ps, n_pool, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (c, hq, d)).astype(np.float32)
    kc, vc = (rng.normal(0, 1.5, (c, hkv, d)).astype(np.float32) for _ in range(2))
    kc.reshape(-1)[::31] = 9.0
    vc.reshape(-1)[::37] = -9.0
    return q, kc, vc, _codes(rng, (n_pool, ps, hkv, d)), _codes(rng, (n_pool, ps, hkv, d))


def _chunk_both(q, kc, vc, kp, vp, row, start, pallas=True):
    """(port out, pools) and the reference's oracle and Pallas answers."""
    tk, tv = _t(kp.copy(), vp.copy())
    out = ops.qpaged_chunk_attn(*_t(q, kc, vc), tk, tv, 3, 2, torch.from_numpy(row), start)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kp), jnp.asarray(vp))
    want = [j_ref.qpaged_chunk_attn_ref(*jargs, 3, 2, jnp.asarray(row), start)]
    if pallas:
        want.append(qpaged_chunk_attn_pallas(*jargs, jnp.int32(3), jnp.int32(2),
                                             jnp.asarray(row), jnp.int32(start),
                                             interpret=True))
    return (out.numpy(), tk.numpy(), tv.numpy()), [tuple(np.asarray(x) for x in w) for w in want]


@pytest.mark.parametrize("c,start", [(4, 0), (4, 5), (6, 7), (3, 17)])
def test_plain_qpaged_chunk_matches_oracle_and_pallas(c, start):
    """test_paged.py:115-137: scattered pool pages; pools bit-identical and
    only the chunk's pool rows changed."""
    hq, hkv, d, ps, n_pool = 4, 2, 8, 4, 12
    q, kc, vc, kp, vp = _chunk_inputs(c, hq, hkv, d, ps, n_pool, seed=c * 10 + start)
    row = np.asarray([7, 2, 9, 0, 5, 11], np.int32)
    (out, tk, tv), wants = _chunk_both(q, kc, vc, kp, vp, row, start)
    for wo, wk, wv in wants:
        np.testing.assert_array_equal(tk, wk)
        np.testing.assert_array_equal(tv, wv)
        np.testing.assert_allclose(out, wo, rtol=RTOL, atol=ATOL)
    flat = row[(start + np.arange(c)) // ps] * ps + (start + np.arange(c)) % ps
    keep = np.ones(n_pool * ps, bool)
    keep[flat] = False
    np.testing.assert_array_equal(tk.reshape(-1, hkv, d)[keep], kp.reshape(-1, hkv, d)[keep])


def test_plain_qpaged_chunk_drops_rows_past_the_table():
    """test_paged.py:140-162: rows 8..9 fall off a 2-page table and are
    dropped, never clamped into another position's page."""
    q, kc, vc, kp, vp = _chunk_inputs(4, 4, 2, 8, 4, 8, seed=6)
    row = np.asarray([5, 6], np.int32)
    (out, tk, tv), wants = _chunk_both(q, kc, vc, kp, vp, row, 6)
    for wo, wk, wv in wants:
        np.testing.assert_array_equal(tk, wk)
        np.testing.assert_array_equal(tv, wv)
        np.testing.assert_allclose(out, wo, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tk[6, :2], kp[6, :2])
    keep = np.ones(8, bool)
    keep[[5, 6]] = False
    np.testing.assert_array_equal(tk[keep], kp[keep])


@pytest.mark.parametrize("row", [[3, 6, -1, -1], [3, -1, 6, -1]])
def test_plain_qpaged_chunk_passes_untouched_pages_through(row):
    """test_paged.py:165-182: pool pages the slot does not own survive the
    write bit for bit; rows on a -1 entry are dropped (oracle only: the
    Pallas kernel is not asked about writes through unmapped entries)."""
    q, kc, vc, kp, vp = _chunk_inputs(4, 4, 2, 8, 4, 8, seed=5)
    row = np.asarray(row, np.int32)
    (out, tk, tv), wants = _chunk_both(q, kc, vc, kp, vp, row, 2, pallas=-1 not in row[:2])
    for wo, wk, wv in wants:
        np.testing.assert_array_equal(tk, wk)
        np.testing.assert_array_equal(tv, wv)
        np.testing.assert_allclose(out, wo, rtol=RTOL, atol=ATOL)
    for p in set(range(8)) - {3, 6}:
        np.testing.assert_array_equal(tk[p], kp[p], err_msg=str(p))


# --------------------------------------------------------------------------
# The paged cache functions
# --------------------------------------------------------------------------

def _paged_pair(quantized, b, mp, ps, n_pool, hkv, d, lens, seed, rows=()):
    """The same paged cache for both packages: pools filled, rows mapped."""
    rng = np.random.default_rng(seed)
    jc = j_attn.init_paged_kv_cache(b, mp, ps, n_pool, hkv, d, quantized=quantized,
                                    dtype=jnp.float32)
    tc = t_attn.init_paged_kv_cache(b, mp, ps, n_pool, hkv, d, quantized=quantized,
                                    device="cpu")
    for name in ("k", "v"):
        x = _codes(rng, (n_pool, ps, hkv, d)) if quantized \
            else rng.normal(0, 1, (n_pool, ps, hkv, d)).astype(np.float32)
        jc[name] = jnp.asarray(x)
        tc[name].copy_(torch.from_numpy(x))
    for slot, r in rows:
        jc = j_attn.set_page_row(jc, slot, jnp.asarray(r, jnp.int32))
        tc = t_attn.set_page_row(tc, slot, r)
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    return jc, tc


def _same(tc, jc):
    for name in ("k", "v", "page_table", "len"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


def test_init_paged_cache_matches_reference_and_keeps_a_spare_row():
    jc = j_attn.init_paged_kv_cache(3, 4, 5, 7, 2, 8, quantized=True)
    tc = t_attn.init_paged_kv_cache(3, 4, 5, 7, 2, 8, quantized=True, device="cpu")
    _same(tc, jc)
    assert (tc["k_n"], tc["v_n"]) == (int(jc["k_n"]), int(jc["v_n"]))
    assert t_attn.is_paged_cache(tc) and not t_attn.is_paged_cache({"k": 0, "len": 0})
    assert tc["k"].untyped_storage().nbytes() == (7 * 5 + 1) * 2 * 8
    st = t_attn.init_paged_kv_cache(3, 4, 5, 7, 2, 8, quantized=False, device="cpu", layers=2)
    assert st["k"].shape == (2, 7, 5, 2, 8) and st["page_table"].shape == (3, 4)


@pytest.mark.parametrize("ps,mp", [(4, 3), (1, 5), (3, 4)])
def test_paged_flat_index_matches_reference(ps, mp):
    row = np.asarray([2, -1, 0, 5, 1][:mp], np.int32)
    pos = np.arange(-0, mp * ps + 5, dtype=np.int32)
    want = j_attn.paged_flat_index(jnp.asarray(row), jnp.asarray(pos), ps, 6)
    got = t_attn.paged_flat_index(torch.from_numpy(row), torch.from_numpy(pos), ps, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_update_matches_dense_and_reference(quantized):
    """test_paged.py:189-210: slot 1 at a page boundary; the paged write
    equals the dense one and repro's paged one."""
    b, ml, h, d, ps = 2, 16, 2, 4, 4
    jc, tc = _paged_pair(quantized, b, ml // ps, ps, b * ml // ps, h, d, [2, 4], seed=0,
                         rows=((0, [4, 5, 6, 7]), (1, [0, 1, 2, 3])))
    dense = t_attn.init_kv_cache(b, ml, h, d, quantized=quantized, device="cpu",
                                 per_slot_len=True)
    for slot in range(b):
        for name in ("k", "v"):
            dense[name][slot] = t_attn.gather_kv_pages(tc, slot)[name == "v"]
    dense["len"] = torch.tensor([2, 4], dtype=torch.int32)
    k = np.random.default_rng(0).normal(0, 1, (b, 1, h, d)).astype(np.float32)
    jc = j_attn.update_kv_cache(jc, jnp.asarray(k), jnp.asarray(k))
    tc = t_attn.update_kv_cache(tc, torch.from_numpy(k), torch.from_numpy(k))
    dense = t_attn.update_kv_cache(dense, torch.from_numpy(k), torch.from_numpy(k))
    _same(tc, jc)
    np.testing.assert_array_equal(tc["len"].numpy(), dense["len"].numpy())
    for slot in range(b):
        np.testing.assert_array_equal(t_attn.gather_kv_pages(tc, slot)[0].numpy(),
                                      dense["k"][slot].numpy())


def test_paged_evicted_slot_writes_are_dropped():
    """test_paged.py:213-228: slot 0 is unmapped but keeps ticking; its row
    lands on the spare row, never in slot 1's pages.  A length past the
    table is dropped too."""
    b, h, d, ps = 3, 2, 4, 4
    jc, tc = _paged_pair(False, b, 2, ps, 4, h, d, [3, 1, 8], seed=1,
                         rows=((1, [0, 1]), (2, [2, 3])))
    for name in ("k", "v"):
        tc[name].zero_()
        jc[name] = jnp.zeros_like(jc[name])
    k = np.ones((b, 1, h, d), np.float32)
    jc = j_attn.update_kv_cache(jc, jnp.asarray(k), jnp.asarray(k))
    tc = t_attn.update_kv_cache(tc, torch.from_numpy(k), torch.from_numpy(k))
    _same(tc, jc)
    pool = tc["k"].numpy()
    assert pool[0, 1].max() == 1.0 and pool.sum() == h * d
    assert tc["len"].tolist() == [4, 2, 9]


def test_reset_kv_slot_unmaps_the_row():
    jc, tc = _paged_pair(True, 3, 3, 4, 9, 2, 4, [5, 7, 2], seed=2,
                         rows=((0, [1, 2, -1]), (1, [3, 4, 5])))
    jc, tc = j_attn.reset_kv_slot(jc, 1), t_attn.reset_kv_slot(tc, 1)
    _same(tc, jc)
    assert tc["page_table"][1].tolist() == [-1, -1, -1]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("start,length,c", [(0, 5, 5), (3, 2, 5), (6, 5, 6), (9, 1, 4)])
def test_paged_append_kv_chunk_matches_reference(quantized, start, length, c):
    """Rows through the slot's table; rows on -1 entries or past the table
    (a padded last chunk) are dropped."""
    b, mp, ps, n_pool, hkv, d = 3, 3, 4, 8, 2, 8
    jc, tc = _paged_pair(quantized, b, mp, ps, n_pool, hkv, d, [3, 9, 4], seed=start,
                         rows=((0, [7, 0, 3]), (2, [5, 1, -1])))
    rng = np.random.default_rng(start + length)
    k, v = (rng.normal(0, 2, (1, c, hkv, d)).astype(np.float32) for _ in range(2))
    for slot in (2, 0):
        jc = j_attn.append_kv_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                    j_attn.KVChunk(jnp.int32(slot), jnp.int32(start),
                                                   jnp.int32(length)))
        tc = t_attn.append_kv_chunk(tc, torch.from_numpy(k), torch.from_numpy(v),
                                    t_attn.KVChunk(slot, start, length))
        _same(tc, jc)


@pytest.mark.parametrize("start", [0, 3, 9])
def test_paged_float_chunk_attention_matches_reference(start):
    b, hkv, g, d, c, ps = 2, 2, 3, 8, 5, 4
    jc, tc = _paged_pair(False, b, 4, ps, 9, hkv, d, [start, 0], seed=start,
                         rows=((0, [8, 2, 5, 0]),))
    q = np.random.default_rng(start).normal(0, 1, (1, c, g * hkv, d)).astype(np.float32)
    want = j_attn.chunk_attention(jnp.asarray(q), jc, jnp.int32(0), jnp.int32(start),
                                  block_kv=4)
    got = t_attn.chunk_attention(torch.from_numpy(q), tc, 0, start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_decode_attention_matches_reference(quantized):
    b, hkv, g, d, ps = 3, 2, 2, 8, 4
    jc, tc = _paged_pair(quantized, b, 3, ps, 7, hkv, d, [5, 12, 1], seed=4,
                         rows=((0, [6, 1, -1]), (1, [2, 0, 4]), (2, [3, -1, -1])))
    q = np.random.default_rng(4).normal(0, 1, (b, 1, g * hkv, d)).astype(np.float32)
    want = j_attn.paged_decode_attention(jnp.asarray(q), jc)
    got = t_attn.paged_decode_attention(torch.from_numpy(q), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layers", [None, 2], ids=["flat", "stacked"])
def test_page_events_match_reference(layers):
    """copy_kv_page, set_page_row, set_page_entry, and a gather /
    scatter_pool_pages round trip (with the swap path's duplicate padding)."""
    rng = np.random.default_rng(3)
    b, mp, ps, n_pool, hkv, d = 3, 4, 2, 6, 2, 4
    lead = (layers,) if layers else ()
    jc = j_attn.init_paged_kv_cache(b, mp, ps, n_pool, hkv, d, quantized=True)
    tc = t_attn.init_paged_kv_cache(b, mp, ps, n_pool, hkv, d, quantized=True, device="cpu",
                                    layers=layers)
    if layers:      # the reference stacks tables and lengths per layer
        jc = dict(jc, page_table=jnp.broadcast_to(jc["page_table"], lead + (b, mp)),
                  len=jnp.broadcast_to(jc["len"], lead + (b,)))
    x = {n: _codes(rng, lead + (n_pool, ps, hkv, d)) for n in ("k", "v")}
    for n in ("k", "v"):
        jc[n] = jnp.asarray(x[n])
        tc[n].copy_(torch.from_numpy(x[n]))
    la = layers is not None

    def same():
        for n in ("k", "v"):
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        jt = np.asarray(jc["page_table"])
        np.testing.assert_array_equal(tc["page_table"].numpy(), jt[0] if la else jt)

    jc = j_attn.copy_kv_page(jc, 4, 1, layer_axis=la)
    tc = t_attn.copy_kv_page(tc, 4, 1)
    same()
    jc = j_attn.set_page_row(jc, 2, jnp.asarray([5, 0, -1, -1], jnp.int32), layer_axis=la)
    tc = t_attn.set_page_row(tc, 2, np.asarray([5, 0, -1, -1], np.int32))
    jc = j_attn.set_page_entry(jc, 2, 2, 3, layer_axis=la)
    tc = t_attn.set_page_entry(tc, 2, 2, 3)
    same()
    pages = [3, 5, 0, 3]                 # padded to a power of two with page 3 again
    jd = j_attn.gather_pool_pages(jc, jnp.asarray(pages, jnp.int32), layer_axis=la)
    td = t_attn.gather_pool_pages(tc, pages)
    for n in ("k", "v"):
        np.testing.assert_array_equal(td[n].numpy(), np.asarray(jd[n]))
    host = {n: td[n].numpy() for n in ("k", "v")}
    dst = [2, 4, 1, 2]
    jc = j_attn.scatter_pool_pages(jc, jnp.asarray(dst, jnp.int32),
                                   {n: jnp.asarray(host[n]) for n in host}, layer_axis=la)
    tc = t_attn.scatter_pool_pages(tc, dst, host)
    same()
    ax = 1 if la else 0
    np.testing.assert_array_equal(np.take(tc["k"].numpy(), [2, 4, 1], axis=ax),
                                  np.take(x["k"], [3, 5, 0], axis=ax))


# --------------------------------------------------------------------------
# The smoke model's paged decode step and mixed step
# --------------------------------------------------------------------------

def _to_numpy(tree):
    from repro.core.qformat import QTensor as JQ

    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def smoke():
    jm = j_get_config("smollm-135m-smoke").build(dtype=jnp.float32, remat="off")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_config("smollm-135m-smoke").build()
    return jm, jp, tm, params_from_numpy(_to_numpy(jp), "cpu")


def _kv(cache):
    return cache["body"][0]["kv"]


def _same_pools(tc, jc, quantized):
    tkv, jkv = _kv(tc), _kv(jc)
    for n in ("k", "v"):
        a, b = tkv[n].numpy(), np.asarray(jkv[n])
        if quantized:
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, n
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for n in ("page_table", "len"):       # the reference keeps one per layer
        for row in np.asarray(jkv[n]):
            np.testing.assert_array_equal(tkv[n].numpy(), row, err_msg=n)


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
def test_smoke_lm_paged_decode_and_mixed_steps(smoke, quantized_kv):
    """Three slots over one fragmented pool (page size 4): slot 0 prefilled
    with 9 tokens in chunks of 4, slot 2 mapping slot 0's first page and
    prefilling from row 4, slot 1 evicted (row all -1) with a length that
    keeps ticking.  Then a decode step over all slots and a mixed step
    (decode + the padded last chunk of slot 2)."""
    jm, jp, tm, tp = smoke
    slots, max_len, ps, n_pool, c = 3, 24, 4, 14, 4
    kw = dict(quantized_kv=quantized_kv, per_slot_len=True, page_size=ps, num_pages=n_pool)
    jc = jm.init_cache(slots, max_len, kv_dtype=jnp.float32, **kw)
    tc = tm.init_cache(slots, max_len, device="cpu", **kw)
    rows = {0: [7, 2, 11, -1, -1, -1], 2: [7, 3, 9, -1, -1, -1]}
    for slot, row in rows.items():
        jc = j_slots.set_cache_page_row(jc, slot, jnp.asarray(row, jnp.int32))
        tc = t_slots.set_cache_page_row(tc, slot, np.asarray(row, np.int32))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 500, size=12).astype(np.int32)
    prompt2 = np.concatenate([prompt[:4], rng.integers(0, 500, size=7).astype(np.int32)])
    jc = j_slots.set_cache_slot_len(jc, 1, 5)
    tc = t_slots.set_cache_slot_len(tc, 1, 5)

    def chunk(jc, tc, slot, toks, start, length):
        ct = np.zeros((1, c), np.int32)
        ct[0, :length] = toks[start:start + length]
        jl, jc = jm.apply(jp, jnp.asarray(ct), JContext(), cache=jc, decode=True,
                          chunk=j_attn.KVChunk(jnp.int32(slot), jnp.int32(start),
                                               jnp.int32(length)),
                          logit_pos=jnp.int32(length - 1))
        tl, tc = tm.apply(tp, torch.from_numpy(ct), Context(), cache=tc, decode=True,
                          chunk=t_attn.KVChunk(slot, start, length), logit_pos=length - 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        return jc, tc

    for start, length in ((0, 4), (4, 4), (8, 1)):
        jc, tc = chunk(jc, tc, 0, prompt, start, length)
    jc = j_slots.set_cache_slot_len(jc, 2, 4)      # the shared page's rows are resident
    tc = t_slots.set_cache_slot_len(tc, 2, 4)
    jc, tc = chunk(jc, tc, 2, prompt2, 4, 4)
    _same_pools(tc, jc, quantized_kv)

    tok = np.asarray([[7], [100], [502]], np.int32)
    jl, jc = jm.apply(jp, jnp.asarray(tok), JContext(), cache=jc, decode=True)
    tl, tc = tm.apply(tp, torch.from_numpy(tok), Context(), cache=tc, decode=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    _same_pools(tc, jc, quantized_kv)
    assert _kv(tc)["len"].tolist() == [10, 6, 9]

    # the mixed step: decode half, then slot 2's last chunk (3 of 4 rows)
    jl, jc = jm.apply(jp, jnp.asarray(tok + 1), JContext(), cache=jc, decode=True)
    tl, tc = tm.apply(tp, torch.from_numpy(tok + 1), Context(), cache=tc, decode=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    jc, tc = chunk(jc, tc, 2, prompt2, 8, 3)
    _same_pools(tc, jc, quantized_kv)
    assert _kv(tc)["len"].tolist() == [11, 7, 11]


# --------------------------------------------------------------------------
# The CUDA kernels (on the card only)
# --------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 5, 16])
def test_cuda_kernel_qpaged_decode_attn_matches_plain(ps):
    _need_card()
    from repro_torch.kernels.qpaged_attn import qpaged_decode_attn_cuda

    rng = np.random.default_rng(ps)
    b, hq, hkv, d, mp = 8, 9, 3, 64, -(-192 // ps)
    n_pool = b * mp + 2
    q = torch.from_numpy(rng.normal(0, 1, (b, hq, d)).astype(np.float32)).cuda()
    kp, vp = (torch.from_numpy(_codes(rng, (n_pool, ps, hkv, d))).cuda() for _ in range(2))
    table = rng.permutation(n_pool)[:b * mp].reshape(b, mp).astype(np.int32)
    table[5] = -1
    lens = np.asarray([1, ps, 100, mp * ps, 191, 50, mp * ps + 9, 2 * ps + 1], np.int32)
    table, lens = torch.from_numpy(table).cuda(), torch.from_numpy(lens).cuda()
    got = qpaged_decode_attn_cuda(q, kp, vp, 3, 3, table, lens)
    want = ref.qpaged_decode_attn_ref(q, kp, vp, 3, 3, table, lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ps,start,s,variant", [(16, 96, 192, None), (5, 160, 192, None),
                                                (16, 176, 192, None), (16, 1984, 2048, None),
                                                (16, 0, 2048, None), (16, 96, 192, "device start"),
                                                (16, 96, 192, "page 0")])
def test_cuda_kernel_qpaged_chunk_attn_matches_plain(ps, start, s, variant):
    """The chunk core over a fragmented row: the serving cache, the tail
    past the table (start 176), S=2048 (a cluster of 8), start passed as
    an int32 on the card, and a chunk written into pool page 0 that an
    unmapped entry of the prefix reads."""
    _need_card()
    from repro_torch.kernels.qpaged_attn import qpaged_chunk_attn_cuda

    mp = -(-s // ps)
    q, kc, vc, kp, vp = (torch.from_numpy(a).cuda()
                         for a in _chunk_inputs(32, 9, 3, 64, ps, 2 * mp, seed=start))
    row = np.random.default_rng(ps).permutation(2 * mp)[:mp].astype(np.int32)
    if variant == "page 0":
        row[np.nonzero(row == 0)[0]] = row[start // ps]
        row[start // ps], row[2] = 0, -1
    row = torch.from_numpy(row).cuda()
    st = torch.full((), start, dtype=torch.int32, device="cuda") if variant == "device start" \
        else start
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got = qpaged_chunk_attn_cuda(q, kc, vc, kk, vk, 3, 3, row, st)
    want = ref.qpaged_chunk_attn_ref(q, kc, vc, kr, vr, 3, 3, row, start)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(kk, kr) and torch.equal(vk, vr)
