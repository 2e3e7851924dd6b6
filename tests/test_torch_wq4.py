"""Port parity for the packed int4 GEMM: the plain ``wq4_matmul_ref``
against repro's interpret-mode ``wq4_matmul_pallas`` and its oracle on the
cases of ``tests/test_kernels.py:160-227``, ``ops.wq4_matmul``'s routing,
``Dense`` on packed kernels, and the kernel's tiling (K split across a
thread-block cluster).

The CUDA kernel runs only on the card: ``test_cuda_kernel_wq4_matmul_*``
carry the ``cuda`` marker and skip without one (``chip_smoke.py`` holds the
kernel to the plain version there).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qformat as jq
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.wq_matmul import wq4_matmul_pallas
from repro.nn.layers import Dense as JDense
from repro.nn.module import Context as JContext
from repro_torch.convert import params_from_numpy
from repro_torch.core import qformat as tq
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wq_gemm
from repro_torch.kernels.wq4_matmul import plan, wq4_matmul_cuda
from repro_torch.nn.layers import Dense
from repro_torch.nn.module import Context

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5

# tests/test_kernels.py:160-168
CASES = [(4, 16, 8, 0), (33, 100, 77, 0), (8, 31, 16, 0), (64, 128, 256, 32),
         (33, 100, 77, 4), (1, 700, 257, 16), (7, 24, 5, 10)]


def _inputs(m, k, n, block_size, seed, width=4):
    """x, the reference's packed weight and its 2^-n scale rows (the
    ``wq4_matmul_pallas`` layout: (1, N) per channel, (ceil(K/bs), N) per
    block)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    t = jq.quantize_tensor_packed(jnp.asarray(w), width, block_size=block_size or None)
    scale = np.array(jnp.exp2(-t.n.astype(jnp.float32))).reshape(-1, n)
    return x, t, scale


@pytest.mark.parametrize("m,k,n,block_size", CASES)
def test_plain_wq4_matmul_matches_pallas_and_oracle(m, k, n, block_size):
    x, t, scale = _inputs(m, k, n, block_size, seed=m * k + n)
    got = ref.wq4_matmul_ref(torch.from_numpy(x), torch.from_numpy(np.array(t.q)),
                             torch.from_numpy(scale), k=k, block_size=block_size).numpy()
    oracle = j_ref.wq4_matmul_ref(x, t.q, scale, k=k, block_size=block_size)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    pallas = wq4_matmul_pallas(jnp.asarray(x), t.q, jnp.asarray(scale), k=k,
                               block_size=block_size, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)


def test_plain_wq4_matmul_single_k_tile_bit_exact():
    """test_kernels.py:180-198: one K step, so the plain version and the
    interpret-mode kernel take the same dot and agree bit for bit."""
    for bs in (0, 8):
        x, t, scale = _inputs(16, 32, 24, bs, seed=8)
        got = ref.wq4_matmul_ref(torch.from_numpy(x), torch.from_numpy(np.array(t.q)),
                                 torch.from_numpy(scale), k=32, block_size=bs)
        want = wq4_matmul_pallas(jnp.asarray(x), t.q, jnp.asarray(scale), k=32, block_size=bs,
                                 bm=16, bk=32, bn=24, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block_size", [None, 4])
def test_plain_wq4_matmul_equals_dense_dequant(block_size):
    """test_kernels.py:201-215: the plain version is x @ dequantize()."""
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (5, 19)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(10).normal(0, 1, (19, 7)).astype(np.float32))
    t = tq.quantize_tensor_packed(w, 4, block_size=block_size)
    got = ref.wq4_matmul_ref(x, t.q, t.scale, k=19, block_size=block_size or 0)
    torch.testing.assert_close(got, x @ t.dequantize(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width,block_size,stacked",
                         [(4, None, False), (4, 8, False), (2, None, False), (2, 8, False),
                          (4, 8, True), (2, None, True)],
                         ids=["int4", "int4-block", "int2", "int2-block", "int4-stacked",
                              "int2-stacked"])
def test_ops_wq4_matmul_routes_like_reference_without_counting(width, block_size, stacked,
                                                                monkeypatch):
    """Every format gives repro's ``ops.wq4_matmul`` (int4 through the
    interpret-mode kernel, int2 and stacked layouts through the dequantize
    fallback); on the CPU no kernel launch is counted."""
    rng = np.random.default_rng(width * 10 + (block_size or 0))
    shape = (2, 21, 6) if stacked else (21, 6)
    w = jq.quantize_tensor_packed(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
                                  width, block_size=block_size)
    x = rng.normal(0, 1, (2, 3, 21)).astype(np.float32)
    monkeypatch.setattr(j_ops, "FORCE", "interpret")
    want = np.asarray(j_ops.wq4_matmul(jnp.asarray(x), w))
    tw = params_from_numpy(w, "cpu")
    ops.reset_launch_counts()
    got = ops.wq4_matmul(torch.from_numpy(x), tw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert set(ops.launch_counts().values()) == {0}


def test_ops_wq4_matmul_per_tensor_scale():
    w = tq.quantize_tensor_packed(torch.randn(9, 4, generator=torch.Generator().manual_seed(1)),
                                  4, per_channel=False)
    assert w.scale.ndim == 0
    x = torch.randn(3, 9, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(ops.wq4_matmul(x, w), x @ w.dequantize(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width,block_size", [(4, None), (4, 32), (2, 32)])
@pytest.mark.parametrize("use_bias", [False, True])
def test_dense_packed_apply_matches_reference(width, block_size, use_bias):
    """``Dense`` sends a PackedQTensor kernel down the packed path (``ops.wq4_matmul``)."""
    rng = np.random.default_rng(width + (block_size or 0))
    w = rng.normal(0, 0.1, (48, 20)).astype(np.float32)
    b = rng.normal(0, 0.1, (20,)).astype(np.float32)
    jp = {"kernel": jq.quantize_tensor_packed(jnp.asarray(w), width, block_size=block_size)}
    if use_bias:
        jp["bias"] = jnp.asarray(b)
    x = rng.normal(0, 1, (2, 5, 48)).astype(np.float32)
    want = JDense(48, 20, use_bias=use_bias).apply(jp, jnp.asarray(x), JContext())
    got = Dense(48, 20, use_bias=use_bias).apply(params_from_numpy(jp, "cpu"),
                                                 torch.from_numpy(x), Context())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", [8, 32, 72, 144, 1024])
@pytest.mark.parametrize("k,n", [(576, 576), (576, 192), (576, 1536), (1536, 576), (31, 16)])
def test_split_k_covers_k_in_whole_steps(m, k, n):
    """The planner's K split across a cluster: every K row in exactly one
    rank, no rank empty, at most 8 ranks (the portable cluster), and at the
    serving shapes at least one wave of 132 blocks where the cluster size
    and K allow it."""
    p = plan(m, k, n)
    ranks, per = p.ranks, p.k_per_rank
    assert per % wq_gemm.BK == 0 and (ranks - 1) * per < k <= ranks * per
    assert 1 <= ranks <= wq_gemm.MAX_RANKS
    steps = math.ceil(k / wq_gemm.BK)
    most = math.ceil(steps / math.ceil(steps / min(wq_gemm.MAX_RANKS, steps)))
    assert wq_gemm.blocks(p, m, n) >= 132 or ranks == most


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_arguments():
    x, wq, s = torch.zeros(2, 6), torch.zeros(3, 4, dtype=torch.int8), torch.ones(1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        wq4_matmul_cuda(x, wq, s, k=6)
    with pytest.raises(ValueError, match="block_size must be even"):
        wq4_matmul_cuda(x, wq, torch.ones(1, 4), k=6, block_size=5)
    with pytest.raises(ValueError, match="packed wq"):
        wq4_matmul_cuda(x, wq, s, k=7)
    with pytest.raises(ValueError, match=r"scale \(1, 4\) != \(2, 4\)"):
        wq4_matmul_cuda(x, wq, s, k=6, block_size=4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block_size", CASES + [
    (72, 576, 1536, 32), (8, 1536, 576, 0), (32, 576, 192, 16), (144, 576, 576, 10),
    (1024, 1536, 576, 4), (8, 576, 192, 4)])
def test_cuda_kernel_wq4_matmul_matches_plain(m, k, n, block_size):
    _need_card()
    x, t, scale = _inputs(m, k, n, block_size, seed=11)
    args = [torch.from_numpy(np.array(a)).cuda() for a in (x, t.q, scale)]
    got = wq4_matmul_cuda(*args, k=k, block_size=block_size)
    want = ref.wq4_matmul_ref(*args, k=k, block_size=block_size)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [0, 4, 10, 16, 32])
@pytest.mark.parametrize("m", [8, 32, 72, 144, 1024])
def test_cuda_kernel_wq4_matmul_at_inexact_exponents(m, block_size):
    """Scales 2^-n with n in 13-20, where the reference's table is not
    exact powers of two (the kernel folds them per block, never into the
    bf16 weights)."""
    _need_card()
    rng = np.random.default_rng(m + block_size)
    k, n = 576, 192
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).cuda()
    wq = torch.from_numpy(rng.integers(-128, 128, (k // 2, n)).astype(np.int8)).cuda()
    rows = -(-k // block_size) if block_size else 1
    exps = torch.from_numpy(rng.integers(13, 21, (rows, n)).astype(np.int32)).cuda()
    scale = tq.exp2(-exps)
    got = wq4_matmul_cuda(x, wq, scale, k=k, block_size=block_size)
    want = ref.wq4_matmul_ref(x, wq, scale, k=k, block_size=block_size)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * want.abs().max().item())
