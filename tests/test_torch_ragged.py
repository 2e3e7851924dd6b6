"""Port parity for the ragged tick: the plain ``qragged_attn`` against
repro's oracle and Pallas kernel (interpret mode) on the cases of
``tests/test_ragged.py`` and on the edges the CUDA kernel must keep (a
dense slab under the identity table, page size 1, a slot with a decode row
and chunk rows in one tick, a position past the table, -1 entries, an
all-inert tick); the ragged cache functions of ``nn/attention.py`` against
repro's; one ragged step of the smoke model against repro's; and
``assemble_ragged_tick`` against repro's.

Tolerances: pools, tables and lengths are integers and bit-identical;
attention outputs and logits are held at rtol 1e-5 / atol 1e-5, as
``tests/test_ragged.py`` holds the Pallas kernel to its oracle.  Its cases
keep their pool codes (uniform in +-100); the port's own cases draw codes
with the spread of post-norm K/V on the Q4.3 grid, as
``test_torch_kernels.py`` does: uniform codes over longer walks give
weighted means of values up to +-12.5 whose f32 rounding in another
summation order reaches 2e-5.  Inert rows are exact zeros in both oracles.  After a model step
the int8 pools hold codes of K/V that the two frameworks computed in
another order, so, as in ``test_torch_paged.py``, a code may sit one step
off at a truncation edge.

The CUDA kernel runs only on the card: ``test_cuda_kernel_qragged_attn_*``
carries the ``cuda`` marker and skips without one (``chip_smoke.py`` holds
the kernel to its plain version there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.qragged_attn import qragged_attn_pallas
from repro.models.registry import get_config as j_get_config
from repro.nn import attention as j_attn
from repro.nn.module import Context as JContext
from repro.serve import lanes as j_lanes
from repro.serve.admission import PrefillLane as JLane
from repro.serve.engine import make_ragged_step as j_make_ragged_step
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import get_config
from repro_torch.nn import attention as t_attn
from repro_torch.nn.module import Context
from repro_torch.serve import lanes as t_lanes
from repro_torch.serve.admission import PrefillLane
from repro_torch.serve.engine import make_ragged_step

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5


def _codes(rng, shape):
    return rng.integers(-100, 100, shape).astype(np.int8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# The plain kernel against the reference's oracle and Pallas kernel
# --------------------------------------------------------------------------

# test_ragged.py:195-212: slot 0 owns pages 0,1; slot 1 pages 2,3; slot 2
# pages 4,5; decode rows for slots 0..2, a 4-token chunk for slot 1 (which
# also decodes at row 3), then inert rows
BASE_TABLE = [[0, 1, -1, -1], [2, 3, -1, -1], [4, 5, -1, -1]]
BASE_SLOTS = [0, 1, 2, 1, 1, 1, 1, 0, 0, 0]
BASE_POS = [5, 3, 6, 4, 5, 6, 7, -1, -1, -1]


def _post_norm_codes(rng, shape):
    """int8 codes with the spread of post-norm K/V on the Q4.3 grid (|x|
    mostly below 2); a few saturate."""
    x = np.clip(np.rint(rng.normal(0, 8, shape)), -128, 127).astype(np.int8)
    x.reshape(-1)[::97] = 127
    return x


def _case(seed, *, t=10, hq=4, hkv=2, d=8, n_pages=6, ps=4, codes=_codes):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (t, hq, d)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (t, hkv, d)).astype(np.float32) for _ in range(2))
    return q, kn, vn, codes(rng, (n_pages, ps, hkv, d)), codes(rng, (n_pages, ps, hkv, d))


def _both(q, kn, vn, kp, vp, table, slots, pos, pallas=True):
    """(port out, pools) and the reference's oracle (and Pallas) answers."""
    table, slots, pos = (np.asarray(x, np.int32) for x in (table, slots, pos))
    tk, tv = _t(kp.copy(), vp.copy())
    out = ops.qragged_attn(*_t(q, kn, vn), tk, tv, 3, 3, *_t(table, slots, pos))
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp), jnp.asarray(vp),
             jnp.int32(3), jnp.int32(3), jnp.asarray(table), jnp.asarray(slots),
             jnp.asarray(pos))
    want = [j_ref.qragged_attn_ref(*jargs)]
    if pallas:
        want.append(qragged_attn_pallas(*jargs, interpret=True))
    return (out.numpy(), tk.numpy(), tv.numpy()), [tuple(np.asarray(x) for x in w) for w in want]


def _check(got, wants, pos):
    out, tk, tv = got
    valid = np.asarray(pos) >= 0
    for wo, wk, wv in wants:
        np.testing.assert_array_equal(tk, wk)
        np.testing.assert_array_equal(tv, wv)
        np.testing.assert_allclose(out[valid], wo[valid], rtol=RTOL, atol=ATOL)
    assert not out[~valid].any()                      # inert rows: exact zeros
    assert not wants[0][0][~valid].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_qragged_matches_oracle_and_pallas(seed):
    """test_ragged.py:215-236: pools bit-identical, valid rows at 1e-5; a
    chunk row attends the rows of its own chunk written in the same call."""
    args = _case(seed)
    got, wants = _both(*args, BASE_TABLE, BASE_SLOTS, BASE_POS)
    _check(got, wants, BASE_POS)
    # the dispatcher took the plain version: it equals a direct call
    tk, tv = _t(args[3].copy(), args[4].copy())
    direct = ref.qragged_attn_ref(*_t(*args[:3]), tk, tv, 3, 3,
                                  *_t(*(np.asarray(x, np.int32)
                                        for x in (BASE_TABLE, BASE_SLOTS, BASE_POS))))
    np.testing.assert_array_equal(direct.numpy(), got[0])


def test_plain_qragged_inert_rows_write_nothing():
    """test_ragged.py:239-250, and the port's all-inert tick: pools unchanged
    and every output row exactly zero."""
    q, kn, vn, kp, vp = _case(2)
    pos = [-1] * 10
    (out, tk, tv), wants = _both(q, kn, vn, kp, vp, BASE_TABLE, BASE_SLOTS, pos)
    np.testing.assert_array_equal(tk, kp)
    np.testing.assert_array_equal(tv, vp)
    assert not out.any()
    for wo, wk, wv in wants:
        np.testing.assert_array_equal(wk, kp)


def test_plain_qragged_dense_identity_table():
    """A dense (B, S, Hkv, D) slab as a pool of B pages of S rows under the
    table arange(B)[:, None], as ``Attention.apply`` passes it: a slot with
    a decode row and a chunk, a chunk at row 0, a row past the slab
    (dropped, attends every row)."""
    b, s = 3, 12
    q, kn, vn, kp, vp = _case(3, t=11, n_pages=b, ps=s, codes=_post_norm_codes)
    table = np.arange(b, dtype=np.int32)[:, None]
    slots = [0, 1, 2, 1, 1, 1, 2, 2, 0, 0, 0]
    pos = [11, 2, 14, 3, 4, 5, 0, 1, -1, -1, -1]
    got, wants = _both(q, kn, vn, kp, vp, table, slots, pos)
    _check(got, wants, pos)


@pytest.mark.parametrize("ps", [1, 5])
def test_plain_qragged_small_and_odd_pages(ps):
    """Fragmented, out-of-order tables at page size 1 and 5; slot 2 maps
    slot 0's first page, which no row of the tick writes; a position past
    the table; -1 entries beyond a token's last page."""
    mp = 12 // ps + 1
    n_pages = 3 * mp + 2
    rng = np.random.default_rng(ps)
    perm = rng.permutation(n_pages).astype(np.int32)
    table = perm[:3 * mp].reshape(3, mp).copy()
    table[2, 0] = table[0, 0]
    table[1, 12 // ps:] = -1                          # slot 1 ends at row 12 // ps * ps
    slots = [0, 0, 0, 1, 2, 2, 2, 1, 0, 0]
    start = max(ps, 3)
    pos = [start, start + 1, start + 2, 12 // ps * ps - 1, mp * ps + 3, start + 4, start + 5,
           -1, -1, -1]
    q, kn, vn, kp, vp = _case(10 + ps, t=10, n_pages=n_pages, ps=ps, codes=_post_norm_codes)
    got, wants = _both(q, kn, vn, kp, vp, table, slots, pos)
    _check(got, wants, pos)


# --------------------------------------------------------------------------
# The ragged cache functions
# --------------------------------------------------------------------------

def _pair(quantized, paged, seed):
    """The same per-slot cache for both packages (3 slots of 16 rows, or a
    fragmented pool of 4-row pages), filled, with lengths."""
    rng = np.random.default_rng(seed)
    b, s, hkv, d, ps, n_pool = 3, 16, 2, 8, 4, 14
    lens = [6, 3, 9]
    if paged:
        jc = j_attn.init_paged_kv_cache(b, s // ps, ps, n_pool, hkv, d, quantized=quantized,
                                        dtype=jnp.float32)
        tc = t_attn.init_paged_kv_cache(b, s // ps, ps, n_pool, hkv, d, quantized=quantized,
                                        device="cpu")
        shape = (n_pool, ps, hkv, d)
    else:
        jc = j_attn.init_kv_cache(b, s, hkv, d, quantized=quantized, dtype=jnp.float32,
                                  per_slot_len=True)
        tc = t_attn.init_kv_cache(b, s, hkv, d, quantized=quantized, device="cpu",
                                  per_slot_len=True)
        shape = (b, s, hkv, d)
    for name in ("k", "v"):
        x = _codes(rng, shape) if quantized else rng.normal(0, 1, shape).astype(np.float32)
        jc[name] = jnp.asarray(x)
        tc[name].copy_(torch.from_numpy(x))
    if paged:
        for slot, row in ((0, [7, 2, 11, -1]), (1, [3, 9, 0, 12]), (2, [5, 1, -1, -1])):
            jc = j_attn.set_page_row(jc, slot, jnp.asarray(row, jnp.int32))
            tc = t_attn.set_page_row(tc, slot, row)
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    return jc, tc


def _same_cache(tc, jc):
    for name in [n for n in ("k", "v", "page_table", "len") if n in tc]:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


# slot 0 decodes at row 6 and takes a chunk at rows 7..9; slot 1 decodes at 3;
# slot 2 a row past 16 (dropped); a pad row
R_SLOTS = [0, 1, 2, 0, 0, 0, 0]
R_POS = [6, 3, 17, 7, 8, 9, -1]


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_append_kv_ragged_and_ragged_attention_match_reference(quantized, paged):
    jc, tc = _pair(quantized, paged, seed=int(quantized) + 2 * int(paged))
    rng = np.random.default_rng(5)
    t, hq, hkv, d = len(R_POS), 4, 2, 8
    q = rng.normal(0, 1, (1, t, hq, d)).astype(np.float32)
    kn, vn = (rng.normal(0, 1.5, (1, t, hkv, d)).astype(np.float32) for _ in range(2))
    slots, pos = np.asarray(R_SLOTS, np.int32), np.asarray(R_POS, np.int32)
    jrb = j_attn.RaggedBatch(slots=jnp.asarray(slots), positions=jnp.asarray(pos))
    trb = t_attn.RaggedBatch(slots=torch.from_numpy(slots), positions=torch.from_numpy(pos))
    jc = j_attn.append_kv_ragged(jc, jnp.asarray(kn), jnp.asarray(vn), jrb)
    tc = t_attn.append_kv_ragged(tc, *_t(kn, vn), trb)
    _same_cache(tc, jc)
    assert tc["len"].tolist() == [10, 4, 18]
    want = j_attn.ragged_attention(jnp.asarray(q), jc, jrb)
    got = t_attn.ragged_attention(torch.from_numpy(q), tc, trb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[0, -1].any()


# --------------------------------------------------------------------------
# One ragged step of the smoke model
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


def _same_pools(tkv, jkv, quantized):
    for n in ("k", "v"):
        a, b = tkv[n].numpy(), np.asarray(jkv[n])
        if quantized:
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, n
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for n in [n for n in ("page_table", "len") if n in tkv]:   # the reference: one per layer
        for row in np.asarray(jkv[n]):
            np.testing.assert_array_equal(tkv[n].numpy(), row, err_msg=n)


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_smoke_lm_ragged_step_matches_reference(smoke, quantized_kv, paged):
    """Three slots and two lanes of 4 over two ticks: lanes prefill slots 0
    and 1 (slot 1's 3-token prompt ends in a padded chunk), then slot 1
    decodes while lane 0 finishes slot 0 with one row and lane 1 starts
    slot 2.  Lane slots' decode rows and lane tails are inert.  Logits at
    the sampled rows, next tokens and the caches (pools, table, the one
    ``len``) against repro's."""
    jm, jp, tm, tp = smoke
    nslots, lanes, c, max_len = 3, 2, 4, 24
    kw = dict(quantized_kv=quantized_kv, per_slot_len=True)
    if paged:
        kw.update(page_size=4, num_pages=14)
    jc = jm.init_cache(nslots, max_len, kv_dtype=jnp.float32, **kw)
    tc = tm.init_cache(nslots, max_len, device="cpu", **kw)
    if paged:
        from repro.serve import slot_state as j_slots
        from repro_torch.serve import slot_state as t_slots

        for slot, row in ((0, [7, 2, 11, -1, -1, -1]), (1, [3, 9, 0, -1, -1, -1]),
                          (2, [5, 1, 12, 13, -1, -1])):
            jc = j_slots.set_cache_page_row(jc, slot, jnp.asarray(row, jnp.int32))
            tc = t_slots.set_cache_page_row(tc, slot, np.asarray(row, np.int32))
    rng = np.random.default_rng(7)

    def tick(jc, tc, tok, ctok, sids, poss, lrows):
        arrays = [np.asarray(x, np.int32) for x in (tok, ctok, sids, poss, lrows)]
        jl, jc2 = jm.apply(jp, jnp.asarray(np.concatenate([arrays[0][:, 0],
                                                           arrays[1].reshape(-1)])[None]),
                           JContext(), cache=jc, decode=True,
                           ragged=j_attn.RaggedBatch(jnp.asarray(arrays[2]),
                                                    jnp.asarray(arrays[3])),
                           logit_rows=jnp.asarray(arrays[4]))
        tl, _ = tm.apply(tp, torch.from_numpy(np.concatenate([arrays[0][:, 0],
                                                             arrays[1].reshape(-1)])[None]),
                         Context(), cache=_clone(tc), decode=True,
                         ragged=t_attn.RaggedBatch(*_t(arrays[2], arrays[3])),
                         logit_rows=torch.from_numpy(arrays[4]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        jtok, jctok, *jmeta = (jnp.asarray(x) for x in arrays)
        jn, jc = j_make_ragged_step(jm)(jp, jtok, jc, jax.random.PRNGKey(0), jctok, *jmeta)
        ttok, tctok, *tmeta = _t(*arrays)
        tn, tc = make_ragged_step(tm)(tp, ttok, tc, None, tctok, *tmeta)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _same_pools(tc["body"][0]["kv"], jc["body"][0]["kv"], quantized_kv)
        return jc, tc

    # tick 1: lane 0 prefills slot 0's rows 0..3, lane 1 slot 1's rows 0..2
    prompt0, prompt1 = rng.integers(0, 500, 5), rng.integers(0, 500, 3)
    tok = np.zeros((nslots, 1), np.int32)
    ctok = np.zeros((lanes, c), np.int32)
    ctok[0], ctok[1, :3] = prompt0[:4], prompt1
    sids = [0, 0, 0] + [0] * 4 + [1] * 3 + [0]
    poss = [-1, -1, -1] + [0, 1, 2, 3] + [0, 1, 2] + [-1]
    jc, tc = tick(jc, tc, tok, ctok, sids, poss, [0, 1, 2, 6, 9])
    # tick 2: slot 1 decodes at row 3, lane 0 finishes slot 0 at row 4, lane 1
    # starts slot 2's 6-token prompt
    prompt2 = rng.integers(0, 500, 6)
    tok = np.asarray([[0], [int(rng.integers(0, 500))], [0]], np.int32)
    ctok = np.zeros((lanes, c), np.int32)
    ctok[0, 0], ctok[1] = prompt0[4], prompt2[:4]
    sids = [0, 1, 0] + [0] * 4 + [2] * 4
    poss = [-1, 3, -1] + [4, -1, -1, -1] + [0, 1, 2, 3]
    jc, tc = tick(jc, tc, tok, ctok, sids, poss, [0, 1, 2, 3, 10])
    assert tc["body"][0]["kv"]["len"].tolist() == [5, 4, 4]


def _clone(cache):
    """A cache with the same contents in new storage (paged pools keep their
    spare row), for a forward whose in-place writes must not count."""
    out = {"body": []}
    for node in cache["body"]:
        kv = dict(node["kv"])
        for name in ("k", "v"):
            x = kv[name]
            if "page_table" in kv:
                n = x.shape[-4] * x.shape[-3]
                lead = x.shape[:-4]
                st = torch.zeros(lead + (n + 1,) + x.shape[-2:], dtype=x.dtype)
                st.narrow(len(lead), 0, n).copy_(x.reshape(lead + (n,) + x.shape[-2:]))
                kv[name] = st.narrow(len(lead), 0, n).unflatten(len(lead), x.shape[-4:-2])
            else:
                kv[name] = x.clone()
        kv["len"] = kv["len"].clone()
        out["body"].append({"kv": kv})
    return out


# --------------------------------------------------------------------------
# assemble_ragged_tick
# --------------------------------------------------------------------------

class _Live:
    def __init__(self, plen, emitted):
        self.plen, self.emitted = plen, emitted


@pytest.mark.parametrize("seed", range(6))
def test_assemble_ragged_tick_matches_reference(seed):
    """Random live slots and lanes (prompts part-way through, some whose
    remaining rows are fewer than a chunk), with and without a token budget
    and the shared-write callback: equal arrays, lanes run and stalls."""
    rng = np.random.default_rng(seed)
    nslots, n_lanes, chunk = int(rng.integers(2, 6)), int(rng.integers(1, 4)), \
        int(rng.integers(2, 7))
    slots = [None if rng.random() < 0.4 else _Live(int(rng.integers(1, 20)),
                                                   int(rng.integers(1, 9)))
             for _ in range(nslots)]
    free = [j for j, s in enumerate(slots) if s is None]
    t_lanes_, j_lanes_ = [], []
    for j in free[:n_lanes]:
        prompt = rng.integers(0, 100, int(rng.integers(1, 3 * chunk))).astype(np.int32)
        start = int(rng.integers(0, prompt.shape[0]))
        t_lanes_.append(PrefillLane(req=None, slot=j, prompt=prompt, next_start=start))
        j_lanes_.append(JLane(req=None, slot=j, prompt=prompt, next_start=start))
    n_active = sum(s is not None for s in slots)
    for budget in (None, n_active + chunk, n_active + n_lanes * chunk - 1):
        calls = {"t": [], "j": []}
        got = t_lanes.assemble_ragged_tick(
            slots, t_lanes_, nslots=nslots, n_lanes=n_lanes, chunk=chunk, pad_id=7,
            token_budget=budget, n_active=n_active,
            assert_private=lambda *a: calls["t"].append(a))
        want = j_lanes.assemble_ragged_tick(
            slots, j_lanes_, nslots=nslots, n_lanes=n_lanes, chunk=chunk, pad_id=7,
            token_budget=budget, n_active=n_active,
            assert_private=lambda *a: calls["j"].append(a))
        for name in ("sids", "poss", "ctok", "lrows"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert (got.ran, got.stalled) == (want.ran, want.stalled)
        assert calls["t"] == calls["j"]


# --------------------------------------------------------------------------
# The CUDA kernel (on the card only)
# --------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 5, 16, 192])
def test_cuda_kernel_qragged_attn_matches_plain(ps):
    """B=8, Hq=9, Hkv=3, D=64, S=192: 8 decode rows, two 32-row chunks at
    start 96 (one into a slot that also decodes), inert rows; ps 192 is the
    dense identity layout."""
    _need_card()
    from repro_torch.kernels.qragged_attn import qragged_attn_cuda

    rng = np.random.default_rng(ps)
    b, hq, hkv, d, s = 8, 9, 3, 64, 192
    mp = -(-s // ps)
    n_pool = b * mp + 2
    table = rng.permutation(n_pool)[:b * mp].reshape(b, mp).astype(np.int32)
    if ps == s:
        n_pool, table = b, np.arange(b, dtype=np.int32)[:, None]
    slots = list(range(b)) + [2] * 32 + [6] * 32 + [0] * 8
    pos = [150 + j for j in range(b)] + list(range(96, 128)) + list(range(96, 128)) + [-1] * 8
    pos[2] = 128
    t = len(pos)
    q = torch.from_numpy(rng.normal(0, 1, (t, hq, d)).astype(np.float32)).cuda()
    kn, vn = (torch.from_numpy(rng.normal(0, 1.5, (t, hkv, d)).astype(np.float32)).cuda()
              for _ in range(2))
    kp, vp = (torch.from_numpy(np.clip(np.rint(rng.normal(0, 8, (n_pool, ps, hkv, d))),
                                       -128, 127).astype(np.int8)).cuda() for _ in range(2))
    table, sl, po = (torch.tensor(x, dtype=torch.int32).cuda() for x in (table, slots, pos))
    kk, vk, kr, vr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got = qragged_attn_cuda(q, kn, vn, kk, vk, 3, 3, table, sl, po)
    want = ref.qragged_attn_ref(q, kn, vn, kr, vr, 3, 3, table, sl, po)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(kk, kr) and torch.equal(vk, vr)
    assert not got[-8:].any()
