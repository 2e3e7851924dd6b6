"""The split walk of ``csrc/attn_split.cuh`` (``qpaged_decode_attn`` and
``qragged_attn`` on the card), emulated in torch and held to the plain
versions and to repro's Pallas kernels in interpret mode; and the split
rule of ``kernels/attn_split.py``.

The emulation below is the kernel's exact partition and combine, written
out for the CPU (it is used by nothing else): the walk [0, s_end) in tiles,
rank r of R taking tiles [r n / R, (r + 1) n / R); in a rank, 8 warps of
D / 8 lane groups, each an online softmax of its own, (m, l, acc) starting
at (-1e30, 0, 0), over positions lo + j BS + w P + k GP + gi; a masked
position (decode, kv_len <= 0) scoring -1e30 and an unseen one (past the
walk, or an unmapped entry in the ragged tick) -inf; then the folds of
groups, warps and ranks by exp(m_i - max m), and acc / max(l, 1e-30).
The ragged tick's rows take the codes the tick writes (quantized from the
f32 inputs) and every other position the pool's.  The rule's tests hold
R in {1, 2, 4, 8}, shapes as its only inputs, and no empty rank on a
walk to the table's end.

Inputs are drawn with numpy from seeds, K/V codes with the spread of
post-norm K/V on the Q4.3 grid.  Outputs are held at rtol 1e-5 / atol 1e-5,
as ``test_torch_paged.py`` holds the plain versions to repro's.  At
kv_len <= 0 on a mapped row the Pallas kernel (and the CUDA kernel) give the
mean of V over the row's first page, where the dense oracle averages the
whole row: those rows are held to Pallas and to that mean; an evicted row
(all -1) reads pool page 0 everywhere, so there all three agree.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.qpaged_attn import qpaged_decode_attn_pallas
from repro.kernels.qragged_attn import qragged_attn_pallas
from repro_torch.core import qformat
from repro_torch.kernels import attn_split, ops, ref

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
K_N, V_N = 3, 4
WARPS = 8


def _post_norm_codes(rng, shape):
    x = np.clip(np.rint(rng.normal(0, 8, shape)), -128, 127).astype(np.int8)
    x.reshape(-1)[::97] = 127
    return x


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# The emulation
# --------------------------------------------------------------------------

def _geometry(d):
    """(lane groups per warp, positions per warp step, per group, tile)."""
    groups = 32 // (d // 8)
    step = 4 if d == 128 else max(groups, 8)
    return groups, step, step // groups, WARPS * step


def _ranges(s_end, d, ranks):
    bs = _geometry(d)[3]
    n = -(-s_end // bs)
    return [(r * n // ranks * bs, min((r + 1) * n // ranks * bs, s_end)) for r in range(ranks)]


def _stream_positions(lo, hi, d):
    """(warps x groups, steps, positions per group) of one rank; -1: none."""
    groups, step, per, bs = _geometry(d)
    steps = -(-(hi - lo) // bs) if hi > lo else 0
    w = torch.arange(WARPS)[:, None, None, None]
    gi = torch.arange(groups)[None, :, None, None]
    j = torch.arange(steps)[None, None, :, None]
    k = torch.arange(per)[None, None, None, :]
    pos = lo + j * bs + w * step + k * groups + gi
    return torch.where(pos < hi, pos, -1).reshape(WARPS * groups, steps, per)


def _walk(sc, v, pos):
    """Each stream's (m, l, acc): sc (G, S) scores with the mask values,
    v (S, D) values, pos (N, steps, per) from ``_stream_positions``."""
    g, n = sc.shape[0], pos.shape[0]
    m = torch.full((g, n), -1e30)
    l = torch.zeros(g, n)
    acc = torch.zeros(g, n, v.shape[1])
    for j in range(pos.shape[1]):
        idx = pos[:, j]
        s = torch.where(idx >= 0, sc[:, idx.clamp(min=0)], -math.inf)      # (G, N, per)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("gnk,nkd->gnd", p, v[idx.clamp(min=0)])
        m = m_new
    return m, l, acc


def _fold(m, l, acc, dim):
    mx = m.amax(dim)
    f = torch.exp(m - mx.unsqueeze(dim))
    return mx, (l * f).sum(dim), (acc * f[..., None]).sum(dim)


def _split_attention(sc, v, s_end, d, ranks):
    """out (G, D) of one walk as the kernel computes it."""
    groups = _geometry(d)[0]
    folds = []
    for lo, hi in _ranges(s_end, d, ranks):
        m, l, acc = _walk(sc, v, _stream_positions(lo, hi, d))
        g = sc.shape[0]
        m, l, acc = (x.reshape(g, WARPS, groups, *x.shape[2:]) for x in (m, l, acc))
        m, l, acc = _fold(m, l, acc, 2)                  # the lane groups of each warp
        folds.append(_fold(m, l, acc, 1))                # the warps of the block
    m, l, acc = (torch.stack(x, 1) for x in zip(*folds))
    _, l, acc = _fold(m, l, acc, 1)                      # the ranks of the cluster
    return acc / torch.clamp(l, min=1e-30)[:, None]


def emulate_paged_decode(q, kp, vp, table, lens, ranks):
    b, hq, d = q.shape
    _, ps, hkv, _ = kp.shape
    g, mp = hq // hkv, table.shape[1]
    out = torch.empty(b, hq, d)
    for i in range(b):
        n = int(lens[i])
        last = min(max((n - 1) // ps, 0), mp - 1)
        s_end = min(n, (last + 1) * ps) if n > 0 else (last + 1) * ps
        pages = table[i].clamp(min=0).long()
        kf = qformat.dequantize(kp[pages].reshape(mp * ps, hkv, d)[:s_end], K_N)
        vf = qformat.dequantize(vp[pages].reshape(mp * ps, hkv, d)[:s_end], V_N)
        live = torch.arange(s_end) < n
        for h in range(hkv):
            sc = q[i, h * g:(h + 1) * g] @ kf[:, h].T / math.sqrt(d)
            sc = torch.where(live, sc, torch.full_like(sc, -1e30))
            out[i, h * g:(h + 1) * g] = _split_attention(sc, vf[:, h], s_end, d, ranks)
    return out


def emulate_ragged(q, kn, vn, kp, vp, table, slots, pos, ranks):
    t, hq, d = q.shape
    _, ps, hkv, _ = kp.shape
    g, mp = hq // hkv, table.shape[1]
    kq, vq = qformat.quantize(kn, K_N, 8), qformat.quantize(vn, V_N, 8)
    out = torch.zeros(t, hq, d)
    for i in range(t):
        p, sl = int(pos[i]), int(slots[i])
        if p < 0:
            continue
        s_end = min(p + 1, mp * ps)
        row = table[sl]
        kc = kp[row.clamp(min=0).long()].reshape(mp * ps, hkv, d)[:s_end].clone()
        vc = vp[row.clamp(min=0).long()].reshape(mp * ps, hkv, d)[:s_end].clone()
        for u in range(t):           # the rows this tick writes replace the pool's
            pu = int(pos[u])
            if int(slots[u]) == sl and 0 <= pu < s_end:
                kc[pu], vc[pu] = kq[u], vq[u]
        mapped = (row >= 0).repeat_interleave(ps)[:s_end]
        kf, vf = qformat.dequantize(kc, K_N), qformat.dequantize(vc, V_N)
        for h in range(hkv):
            sc = q[i, h * g:(h + 1) * g] @ kf[:, h].T / math.sqrt(d)
            sc = torch.where(mapped, sc, torch.full_like(sc, -math.inf))
            out[i, h * g:(h + 1) * g] = _split_attention(sc, vf[:, h], s_end, d, ranks)
    return out


# --------------------------------------------------------------------------
# Paged decode
# --------------------------------------------------------------------------

def _decode_case(d, seed):
    """Fragmented, out-of-order table (slot 1 maps slot 0's first pages);
    kv_len 0, negative, 1, a page boundary, the table's end, past it, and
    two evicted rows (all -1) at lengths 5 and 0."""
    rng = np.random.default_rng(seed)
    b, hkv, g, ps, mp = 8, 2, 2, 16, 19
    n_pool = b * mp + 3
    q = rng.normal(0, 1, (b, g * hkv, d)).astype(np.float32)
    kp, vp = (_post_norm_codes(rng, (n_pool, ps, hkv, d)) for _ in range(2))
    table = rng.permutation(n_pool)[:b * mp].reshape(b, mp).astype(np.int32)
    table[1, :2] = table[0, :2]
    table[6] = table[7] = -1
    lens = np.asarray([0, -3, 1, 2 * ps, mp * ps, mp * ps + 7, 5, 0], np.int32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64])
def test_emulated_split_decode_matches_plain_and_pallas(d, ranks):
    q, kp, vp, table, lens = _decode_case(d, seed=d + ranks)
    got = emulate_paged_decode(*_t(q, kp, vp, table, lens), ranks).numpy()
    plain = ref.qpaged_decode_attn_ref(*_t(q, kp, vp), K_N, V_N, *_t(table, lens)).numpy()
    pallas = np.asarray(qpaged_decode_attn_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(K_N), jnp.int32(V_N),
        jnp.asarray(table), jnp.asarray(lens), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    dense = (lens > 0) | (table < 0).all(axis=1)      # rows where the dense oracle agrees
    np.testing.assert_allclose(got[dense], plain[dense], rtol=RTOL, atol=ATOL)
    # kv_len <= 0 on a mapped row: the mean of V over the row's first page
    g = q.shape[1] // kp.shape[2]
    first = np.repeat(vp[table[:2, 0]].astype(np.float64) * 2.0 ** -V_N, g, axis=2).mean(axis=1)
    np.testing.assert_allclose(got[:2], first, rtol=RTOL, atol=ATOL)


def test_emulated_split_decode_keeps_empty_ranks_out_of_the_fold():
    """A rank with no position keeps (-1e30, 0, 0) and folds to nothing,
    also against a rank whose positions are all masked (kv_len <= 0)."""
    d = 32
    sc = torch.full((2, 16), -1e30)
    v = torch.arange(16 * d, dtype=torch.float32).reshape(16, d)
    m, l, acc = _walk(sc, v, _stream_positions(20, 20, d))
    assert bool((m == -1e30).all()) and not bool(l.any()) and not bool(acc.any())
    for ranks in (1, 2, 4, 8):
        out = _split_attention(sc, v, 16, d, ranks)
        torch.testing.assert_close(out, v.mean(0).expand(2, d), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# The ragged tick
# --------------------------------------------------------------------------

def _ragged_case(d, seed, unmapped):
    """Slot 0 decodes at 40 and carries a chunk at 41..72 in the same tick;
    slot 1 (which maps slot 0's first two pages) decodes at the table's last
    row; slot 3 writes past the table; then inert rows.  ``unmapped``:
    slot 2's row is all -1 (its token at 3 sees no mapped position) and
    slot 4's entries past its page 3 are -1 (its token at 70 sits on one)."""
    rng = np.random.default_rng(seed)
    hkv, g, ps, mp = 2, 2, 16, 19
    n_pool = 5 * mp + 2
    table = rng.permutation(n_pool)[:5 * mp].reshape(5, mp).astype(np.int32)
    table[1, :2] = table[0, :2]
    if unmapped:
        table[2] = -1
        table[4, 4:] = -1
    slots = [0, 1, 2, 3, 4] + [0] * 32 + [0, 0, 0]
    pos = [40, mp * ps - 1, 3, mp * ps + 5, 70] + list(range(41, 73)) + [-1, -1, -1]
    t = len(pos)
    q = rng.normal(0, 1, (t, g * hkv, d)).astype(np.float32)
    kn, vn = (rng.normal(0, 1.5, (t, hkv, d)).astype(np.float32) for _ in range(2))
    kp, vp = (_post_norm_codes(rng, (n_pool, ps, hkv, d)) for _ in range(2))
    return q, kn, vn, kp, vp, table, np.asarray(slots, np.int32), np.asarray(pos, np.int32)


def _ragged_both(ranks, q, kn, vn, kp, vp, table, slots, pos):
    """(emulated out, plain out and pools) of one tick."""
    got = emulate_ragged(*_t(q, kn, vn, kp, vp, table, slots, pos), ranks).numpy()
    tk, tv = _t(kp.copy(), vp.copy())
    plain = ops.qragged_attn(*_t(q, kn, vn), tk, tv, K_N, V_N, *_t(table, slots, pos))
    return got, (plain.numpy(), tk.numpy(), tv.numpy())


def _jargs(q, kn, vn, kp, vp, table, slots, pos):
    return ([jnp.asarray(x) for x in (q, kn, vn, kp, vp)] + [jnp.int32(K_N), jnp.int32(V_N)]
            + [jnp.asarray(x) for x in (table, slots, pos)])


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64])
def test_emulated_split_ragged_matches_plain_and_pallas(d, ranks):
    case = _ragged_case(d, seed=d + 10 * ranks, unmapped=False)
    got, plain = _ragged_both(ranks, *case)
    pallas = [np.asarray(x) for x in qragged_attn_pallas(*_jargs(*case), interpret=True)]
    pos = case[-1]
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(plain[1], pallas[1])
    np.testing.assert_array_equal(plain[2], pallas[2])
    assert not got[pos < 0].any()                     # inert rows: exact zeros


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64])
def test_emulated_split_ragged_unmapped_entries_match_plain_and_oracle(d, ranks):
    """Unmapped entries inside a token's walk are unseen (-inf) in the
    plain version, repro's oracle and the kernel; repro's Pallas kernel
    takes such an entry for pool page 0 (it only expects one under inert
    rows), so it is left out here.  The token that sees no mapped position
    outputs exact zeros."""
    case = _ragged_case(d, seed=d + 10 * ranks + 1, unmapped=True)
    got, plain = _ragged_both(ranks, *case)
    oracle = [np.asarray(x) for x in j_ref.qragged_attn_ref(*_jargs(*case))]
    pos = case[-1]
    for want in (plain, oracle):
        np.testing.assert_allclose(got, want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(plain[1], oracle[1])
    np.testing.assert_array_equal(plain[2], oracle[2])
    assert not got[pos < 0].any() and not got[2].any() and not plain[0][2].any()


# --------------------------------------------------------------------------
# The split rule
# --------------------------------------------------------------------------

SHAPES = [(walk, walks, hkv, d) for walk in (1, 16, 63, 64, 192, 256, 1000, 2048, 32768)
          for walks in (1, 8, 72, 160) for hkv in (1, 3, 8) for d in (16, 32, 64, 128)]


def test_split_rule_is_a_power_of_two_up_to_eight_and_leaves_no_rank_empty():
    """At kv_len = max_pages * ps (a walk to the table's end) every rank has
    at least one tile, for every shape."""
    for walk, walks, hkv, d in SHAPES:
        r = attn_split.split_ranks(walk, walks, hkv, d)
        assert r in (1, 2, 4, 8)
        ranges = _ranges(walk, d, r)
        assert all(lo < hi for lo, hi in ranges), (walk, walks, hkv, d, r, ranges)


def test_split_rule_depends_on_shapes_alone():
    """Its inputs are the launch's shapes (ints); never kv_len or positions."""
    assert list(inspect.signature(attn_split.split_ranks).parameters) == \
        ["walk", "walks", "hkv", "d"]
    for shape in SHAPES[::7]:
        assert attn_split.split_ranks(*shape) == attn_split.split_ranks(*shape)
    with pytest.raises(ValueError):
        attn_split.split_ranks(0, 8, 3, 64)


@pytest.mark.parametrize("walk,walks,want", [(192, 8, 2), (2048, 8, 8), (192, 72, 1),
                                             (195, 72, 1), (2048, 72, 2)])
def test_split_rule_at_the_smoke_run_shapes(walk, walks, want):
    """The shapes whose A/B figures chose the rule (D=64, Hkv=3; 195 is the
    ragged tick at page size 5): a cluster at S=2048 for both kernels and
    for the decode of 8 slots at S=192, one block a walk for the ragged
    tick at S=192."""
    assert attn_split.split_ranks(walk, walks, 3, 64) == want


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_rank_ranges_cover_the_walk_in_order(d):
    rng = np.random.default_rng(d)
    for s_end in list(rng.integers(1, 5000, 20)) + [1, attn_split.tile(d)]:
        for ranks in (1, 2, 4, 8):
            ranges = _ranges(int(s_end), d, ranks)
            assert ranges[0][0] == 0 and ranges[-1][1] == s_end
            assert all(a[1] == b[0] or b[0] >= b[1] for a, b in zip(ranges, ranges[1:]))
            assert all(lo % attn_split.tile(d) == 0 for lo, hi in ranges if lo < hi)
    assert attn_split.tile(d) == _geometry(d)[3]
