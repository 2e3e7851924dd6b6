"""The arithmetic and the planners of the weight-only tensor-core GEMM
(``src/repro_torch/kernels/csrc/wq_gemm.cuh``, launched by ``wq_matmul``
and ``wq4_matmul`` at every M), on the CPU:

- the bf16x3 split of f32 activations is exact;
- a float32 emulation of the kernel's three passes, with block scales
  folded per block (masked passes where a 16-row step spans blocks), gives
  the plain versions and repro's interpret-mode Pallas kernels within the
  tolerance the card is held to, at exponents n >= 13 too, where the
  reference's 2^-n table is not exact powers of two;
- each planner covers K with whole steps, one cluster rank each, fills the
  card and fits a block's shared memory at the serving shapes;
- the build hash covers the shared header.

The kernels themselves run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``test_torch_kernels.py`` and
``test_torch_wq4.py``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.wq_matmul import wq4_matmul_pallas, wq_matmul_pallas
from repro_torch.core import qformat
from repro_torch.kernels import _build, ref, wq4_matmul, wq_gemm, wq_matmul

torch.set_num_threads(2)
WQ_RTOL = 2e-5   # |kernel - plain| <= WQ_RTOL * max|plain|, as chip_smoke.py holds the card
SERVE_SHAPES = {"wq/wo": (576, 576), "wk/wv": (576, 192), "gate/in": (576, 1536),
                "out": (1536, 576)}          # smollm-135m's projections, (K, N)


def split3(x: torch.Tensor):
    """The kernel's split of f32 ``x`` into three bf16 parts (as f32):
    x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), each rounded
    to nearest even (``cvt.rn.bf16x2.f32``)."""
    x0 = x.to(torch.bfloat16).float()
    r1 = x - x0
    x1 = r1.to(torch.bfloat16).float()
    return x0, x1, (r1 - x1).to(torch.bfloat16).float()


# ---- the split ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16x3_split_is_exact(seed):
    """Normal f32 values with exponents in [-60, 60], both signs, and
    zeros: the three parts add up to x exactly, in float64 and in the f32
    order the kernel's sums can take; each part is a bf16 value."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, 100_000)
    exps = rng.integers(-60, 61, 100_000)
    x = (mant * np.exp2(exps) * rng.choice([-1.0, 1.0], 100_000)).astype(np.float32)
    x[:: 997] = 0.0
    x[1:: 997] = -0.0
    xt = torch.from_numpy(x)
    parts = split3(xt)
    for p in parts:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    total = parts[0].double() + parts[1].double() + parts[2].double()
    assert torch.equal(total, xt.double())
    assert torch.equal((parts[0] + parts[1]) + parts[2], xt)
    # the parts shrink by bf16's 8 bits each step: x1 is at most half an ulp of x0
    nz = parts[0] != 0
    assert (parts[1][nz].abs() <= parts[0][nz].abs() * 2.0 ** -8).all()


def test_bf16x3_split_subnormals():
    """Exact for every |x| >= 2^-110.  Below that the third part falls under
    bf16's subnormal step 2^-133 and rounds: the split misses x by at most
    2^-134 (half that step), an absolute error no product of this GEMM can
    see at the tolerance (|x| itself is below 2^-110).  f32 subnormals
    (|x| < 2^-126) lose their low bits the same way."""
    rng = np.random.default_rng(5)
    mant = rng.uniform(1.0, 2.0, 50_000)
    exps = rng.integers(-149, -100, 50_000)
    x = torch.from_numpy((mant * np.exp2(exps.astype(np.float64))).astype(np.float32))
    x = torch.cat([x, -x, torch.tensor([2.0 ** -149, 2.0 ** -126, 3 * 2.0 ** -140])])
    total = sum(p.double() for p in split3(x))
    err = (total - x.double()).abs()
    big = x.abs() >= 2.0 ** -110
    assert big.any() and (~big).any()
    assert torch.equal(total[big], x.double()[big])
    assert err.max().item() <= 2.0 ** -134
    assert (err > 0).any()   # below 2^-110 some bits are really lost
    sub = x.abs() < 2.0 ** -126
    assert sub.sum() > 1000


@pytest.mark.parametrize("m,k,n", [(72, 576, 576), (8, 1536, 576)])
def test_fewer_passes_are_not_exact(m, k, n):
    """Why three bf16 passes: one TF32 pass (10 bits of x, rounded to
    nearest) misses the 2e-5 tolerance more than five times over against
    the exact product, and two bf16 parts leave a residual; three are exact,
    so the kernel's product differs from the plain one in the order of the
    sums only."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.float32) * 2.0 ** -7)
    exact = x.double() @ w.double()
    bits = x.view(torch.int32)
    tf32 = ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    tf32_err = ((tf32.double() @ w.double() - exact).abs().max() / exact.abs().max()).item()
    assert tf32_err > 5 * WQ_RTOL
    x0, x1, x2 = split3(x)
    assert not torch.equal(x0 + x1, x) and torch.equal((x0 + x1) + x2, x)
    three = sum(p.double() @ w.double() for p in (x0, x1, x2))
    assert torch.allclose(three, exact, rtol=0, atol=1e-9 * exact.abs().max().item())


# ---- the three passes and the block fold --------------------------------------------

def emulate(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, block_size: int,
            prescale: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in float32, step by 16-row K step.

    x (M, K) f32, codes (K, N) integer codes as f32, scale (N,) per channel
    (``block_size`` 0; applied after the sums) or (ceil(K/bs), N) per
    block.  Per channel: the x0 pass into one f32 sum, the x1 and x2 passes
    into another, added at the end.  Per block: each block's three passes
    into a partial sum folded in as scale * partial when the block changes;
    a step that spans blocks runs once per block with the other rows'
    codes zeroed.  ``prescale`` instead multiplies the codes by their block
    scale and rounds them to bf16 before the products (what the kernel must
    not do).
    """
    m, k = x.shape
    n = codes.shape[1]
    parts = split3(x)
    acc = torch.zeros(m, n)
    part = torch.zeros(m, n)
    if prescale:
        rows = qformat.repeat_blocks(scale, block_size, k)
        w = (codes * rows).to(torch.bfloat16).float()
        for k16 in range(0, k, 16):
            sl = slice(k16, min(k16 + 16, k))
            for p in parts:
                acc += p[:, sl] @ w[sl]
        return acc
    cur = -1
    for k16 in range(0, k, 16):
        end = min(k16 + 16, k)
        sl = slice(k16, end)
        if block_size == 0:
            acc += parts[0][:, sl] @ codes[sl]
            part += parts[1][:, sl] @ codes[sl]
            part += parts[2][:, sl] @ codes[sl]
            continue
        for kb in range(k16 // block_size, (end - 1) // block_size + 1):
            if kb != cur:
                if cur >= 0:
                    acc += scale[cur] * part
                    part.zero_()
                cur = kb
            rows = torch.arange(k16, end)
            keep = (rows // block_size == kb).float()[:, None]
            for p in parts:
                part += p[:, sl] @ (codes[sl] * keep)
    if block_size == 0:
        return (acc + part) * scale.reshape(1, -1)
    return acc + scale[cur] * part


def _int8_case(m, k, n, n_lo, n_hi, per_channel, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    exps = torch.from_numpy(rng.integers(n_lo, n_hi + 1, (n,) if per_channel else ())
                            .astype(np.int32))
    scale = qformat.exp2(-exps).reshape(-1)
    return x, wq, scale.numpy().astype(np.float32)


def _int4_case(m, k, n, block_size, n_lo, n_hi, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    packed = rng.integers(-128, 128, (-(-k // 2), n)).astype(np.int8)
    if k % 2:   # the pad nibble of the last byte row is zero, as packing leaves it
        packed[-1] &= 0x0F
    rows = -(-k // block_size) if block_size else 1
    exps = torch.from_numpy(rng.integers(n_lo, n_hi + 1, (rows, n)).astype(np.int32))
    return x, packed, qformat.exp2(-exps).numpy().astype(np.float32)


def _close(got, want):
    want = torch.as_tensor(np.array(want))
    err = (got - want).abs().max().item()
    assert err <= WQ_RTOL * want.abs().max().item(), (err, want.abs().max().item())


EXPONENTS = [(3, 9), (13, 20)]


@pytest.mark.parametrize("n_lo,n_hi", EXPONENTS, ids=["n3-9", "n13-20"])
@pytest.mark.parametrize("per_channel", [True, False], ids=["per-channel", "scalar"])
@pytest.mark.parametrize("m,k,n", [(9, 100, 40), (72, 576, 192)])
def test_emulated_int8_passes_match_plain_and_pallas(m, k, n, per_channel, n_lo, n_hi):
    x, wq, scale = _int8_case(m, k, n, n_lo, n_hi, per_channel, seed=m + k + n)
    xt, wt, st = (torch.from_numpy(a) for a in (x, wq, scale))
    got = emulate(xt, wt.float(), st.expand(n) if st.numel() == 1 else st, 0)
    _close(got, ref.wq_matmul_ref(xt, wt, st.reshape(()) if st.numel() == 1 else st))
    _close(got, wq_matmul_pallas(jnp.asarray(x), jnp.asarray(wq),
                                 jnp.asarray(scale.reshape(()) if scale.size == 1 else scale),
                                 bm=128, bk=128, bn=128, interpret=True))


@pytest.mark.parametrize("n_lo,n_hi", EXPONENTS, ids=["n3-9", "n13-20"])
@pytest.mark.parametrize("block_size", [0, 4, 10, 16, 32])
@pytest.mark.parametrize("m,k,n", [(8, 101, 24), (33, 576, 64)])
def test_emulated_int4_passes_and_block_fold_match_plain_and_pallas(m, k, n, block_size,
                                                                    n_lo, n_hi):
    x, packed, scale = _int4_case(m, k, n, block_size, n_lo, n_hi, seed=m * k + block_size)
    xt, pt, st = (torch.from_numpy(a) for a in (x, packed, scale))
    codes = qformat.unpack_subint8(pt, 4, k).float()
    got = emulate(xt, codes, st.reshape(-1) if not block_size else st, block_size)
    _close(got, ref.wq4_matmul_ref(xt, pt, st, k=k, block_size=block_size))
    _close(got, wq4_matmul_pallas(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), k=k,
                                  block_size=block_size, interpret=True))


@pytest.mark.parametrize("block_size", [4, 16, 32])
def test_bf16_prescaled_block_weights_are_inexact_at_large_exponents(block_size):
    """Folding a block scale into the bf16 weight is exact while the scale
    is a power of two; the reference's table at n >= 13 is not, and
    bf16(nibble * scale) then misses nibble * scale: by about 5e-7 of the
    weight (one f32 ulp of the table's error, kept by no bf16).  That
    departure is coherent across a block, so it reaches the result as a
    relative error of the same size: small against the 2e-5 tolerance,
    which would not catch it, but a different weight.  The kernel's fold
    keeps every product exact; only the order of the sums differs."""
    k, n = 96, 16
    x, packed, scale = _int4_case(12, k, n, block_size, 13, 20, seed=block_size)
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    codes = qformat.unpack_subint8(torch.from_numpy(packed), 4, k).float()
    exact = codes.double() * qformat.repeat_blocks(st, block_size, k).double()
    prescaled = exact.float().to(torch.bfloat16).double()
    assert not torch.equal(prescaled, exact)
    rel = ((prescaled - exact).abs() / exact.abs().clamp_min(1e-30))[exact != 0]
    assert 1e-7 < rel.max().item() < 1e-6
    want = xt.double() @ exact
    naive = emulate(xt, codes, st, block_size, prescale=True)
    folded = emulate(xt, codes, st, block_size)
    naive_err = ((naive.double() - want).abs() / want.abs().max()).max().item()
    assert naive_err > 0
    _close(folded, want.float())


# ---- the planners -------------------------------------------------------------------

PLANNERS = {"wq_matmul": (wq_matmul.plan, False), "wq4_matmul": (wq4_matmul.plan, True)}


@pytest.mark.parametrize("shape", list(SERVE_SHAPES))
@pytest.mark.parametrize("m", [8, 32, 72, 144, 1024])
@pytest.mark.parametrize("kernel", list(PLANNERS))
def test_planner_covers_k_fills_the_card_and_fits_shared_memory(kernel, m, shape):
    """Every K row in exactly one cluster rank (whole steps, none empty),
    at most 8 ranks, at least 132 blocks where the cluster size and K
    allow it, and under 227 KB of shared memory per block."""
    planner, packed = PLANNERS[kernel]
    k, n = SERVE_SHAPES[shape]
    p = planner(m, k, n)
    assert p.bm in wq_gemm.TILES_M
    assert math.ceil(m / p.bm) <= wq_gemm.MAX_M_TILES or p.bm == wq_gemm.TILES_M[-1]
    assert 1 <= p.ranks <= wq_gemm.MAX_RANKS
    assert p.k_per_rank % wq_gemm.BK == 0
    ranges = [range(r * p.k_per_rank, min(k, (r + 1) * p.k_per_rank)) for r in range(p.ranks)]
    assert all(len(rg) > 0 for rg in ranges)
    assert sorted(i for rg in ranges for i in rg) == list(range(k))
    steps = math.ceil(k / wq_gemm.BK)
    most = math.ceil(steps / math.ceil(steps / min(wq_gemm.MAX_RANKS, steps)))
    assert wq_gemm.blocks(p, m, n) >= wq_gemm.SMS or p.ranks == most
    assert wq_gemm.smem_bytes(p.bm, packed) < wq_gemm.SMEM_MAX


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 31, 5), (17, 33, 65), (1000, 7, 3),
                                   (9, 100_000, 8)])
def test_tile_plan_edges(m, k, n):
    """Tiny and lopsided calls: K still splits into whole steps, one rank
    each; a deep K takes the full cluster."""
    p = wq_gemm.tile_plan(m, k, n)
    assert (p.ranks - 1) * p.k_per_rank < k <= p.ranks * p.k_per_rank
    assert p.k_per_rank % wq_gemm.BK == 0 and 1 <= p.ranks <= wq_gemm.MAX_RANKS
    if k >= wq_gemm.MAX_RANKS * wq_gemm.BK and wq_gemm.blocks(p, m, n) < wq_gemm.SMS:
        assert p.ranks == wq_gemm.MAX_RANKS


def test_tile_plan_refuses_empty_calls():
    with pytest.raises(ValueError, match="no tiling"):
        wq_gemm.tile_plan(0, 4, 4)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both GEMMs include ``wq_gemm.cuh``, and the chunk pair through
    ``chunk_split.cuh``: an edit there must rebuild them, and leave the
    kernels that do not include it alone."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    (tmp_path / "wq_gemm.cuh").write_text((tmp_path / "wq_gemm.cuh").read_text() + "\n// edit\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    changed = {name for name in _build.KERNELS if before[name] != after[name]}
    assert changed == {"wq_matmul", "wq4_matmul", "qchunk_attn", "qpaged_attn"}


@pytest.mark.parametrize("m", [8, 72, 1024])
@pytest.mark.parametrize("shape", list(SERVE_SHAPES))
def test_tile_plan_takes_the_smallest_tile_and_cluster_that_fill_the_card(m, shape):
    """The M tile is the smallest that needs at most ``MAX_M_TILES`` rows
    of blocks (else the tallest), and K is split no further than reaching
    ``TARGET_BLOCKS`` needs: one rank fewer would fall short of it.  Every
    rank but the last sums ``k_per_rank`` rows, the last at least one step."""
    k, n = SERVE_SHAPES[shape]
    p = wq_gemm.tile_plan(m, k, n)
    fits = [t for t in wq_gemm.TILES_M if math.ceil(m / t) <= wq_gemm.MAX_M_TILES]
    assert p.bm == (fits[0] if fits else wq_gemm.TILES_M[-1])
    tiles = math.ceil(m / p.bm) * math.ceil(n / wq_gemm.BN)
    assert p.ranks == 1 or tiles * (p.ranks - 1) < wq_gemm.TARGET_BLOCKS
    last = k - (p.ranks - 1) * p.k_per_rank
    assert 0 < last <= p.k_per_rank
