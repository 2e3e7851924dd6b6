"""Port parity: the plain versions of the ported kernels against repro's
Pallas kernels (interpret mode) and jnp oracles; dispatch and launch counts.

The CUDA kernels themselves run only on the card: ``test_cuda_kernel_*``
carry the ``cuda`` marker and skip without one (``chip_smoke.py`` holds the
kernels to their plain versions there).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.qformat import QTensor
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"
RTOL, ATOL_MM, ATOL_ATTN = 1e-5, 1e-5, 1e-6


def _wq_inputs(m, k, n, per_channel, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    n_exp = rng.integers(4, 9, (n,) if per_channel else ()).astype(np.int32)
    scale = np.asarray(np.exp2(-n_exp.astype(np.float32)), np.float32)
    return x, wq, n_exp, scale


@pytest.mark.parametrize("m,k,n", [(1, 7, 5), (3, 33, 17), (9, 65, 31), (16, 64, 48)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_plain_wq_matmul_matches_pallas_and_oracle(m, k, n, per_channel, monkeypatch):
    x, wq, _, scale = _wq_inputs(m, k, n, per_channel, seed=m * k + n)
    got = ref.wq_matmul_ref(torch.from_numpy(x), torch.from_numpy(wq),
                            torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ref.wq_matmul_ref(x, wq, scale)),
                               rtol=RTOL, atol=ATOL_MM)
    monkeypatch.setattr(j_ops, "FORCE", "interpret")
    from repro.core.qformat import QTensor as JQ

    jw = JQ(jnp.asarray(wq), jnp.asarray(-np.log2(scale).astype(np.int32)), 8,
            1 if per_channel else None)
    np.testing.assert_allclose(got, np.asarray(j_ops.wq_matmul(jnp.asarray(x), jw)),
                               rtol=RTOL, atol=ATOL_MM)


def _qd_inputs(b, hq, hkv, d, s, seed):
    """q and int8 K/V codes with the spread of post-norm K/V on the Q4.3
    grid (|x| mostly below 2); a few codes saturate."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k, v = (np.clip(np.rint(rng.normal(0, 8, (b, s, hkv, d))), -128, 127).astype(np.int8)
            for _ in range(2))
    k.reshape(-1)[:: 97] = 127
    v.reshape(-1)[:: 89] = -128
    return q, k, v


@pytest.mark.parametrize("b,hq,hkv,d,s", [(2, 4, 2, 16, 37), (3, 9, 3, 8, 100),
                                          (1, 2, 1, 32, 64), (2, 6, 3, 16, 7)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_plain_qdecode_attn_matches_pallas_and_oracle(b, hq, hkv, d, s, per_slot, monkeypatch):
    q, k, v = _qd_inputs(b, hq, hkv, d, s, seed=b * s + d)
    if per_slot:
        lens = np.random.default_rng(s).integers(1, s + 1, (b,)).astype(np.int32)
        t_len, j_len = torch.from_numpy(lens), jnp.asarray(lens)
    else:
        t_len, j_len = s // 2 + 1, jnp.int32(s // 2 + 1)
    got = ref.qdecode_attn_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               3, 4, t_len).numpy()
    want = j_ref.qdecode_attn_ref(q, k, v, jnp.int32(3), jnp.int32(4), j_len)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL_ATTN)
    monkeypatch.setattr(j_ops, "FORCE", "interpret")
    pallas = j_ops.qdecode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(3), jnp.int32(4), j_len)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL_ATTN)


def test_plain_qdecode_attn_takes_device_exponents_and_scalar_len():
    q, k, v = _qd_inputs(2, 4, 2, 16, 20, seed=9)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    a = ref.qdecode_attn_ref(*args, 3, 3, 11)
    b = ref.qdecode_attn_ref(*args, torch.tensor(3, dtype=torch.int32),
                             torch.tensor(3, dtype=torch.int32),
                             torch.tensor(11, dtype=torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ops_dispatch_cpu_tensors_to_plain_without_counting():
    ops.reset_launch_counts()
    x, wq, n_exp, scale = _wq_inputs(4, 24, 12, True, seed=1)
    w = QTensor(torch.from_numpy(wq), torch.from_numpy(n_exp), 8, 1)
    got = ops.wq_matmul(torch.from_numpy(x).reshape(2, 2, 24), w)
    assert got.shape == (2, 2, 12)
    torch.testing.assert_close(
        got.reshape(4, 12),
        ref.wq_matmul_ref(torch.from_numpy(x), w.q, torch.from_numpy(scale)),
        rtol=0, atol=0)
    q, k, v = _qd_inputs(2, 4, 2, 16, 9, seed=2)
    ops.qdecode_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 3, 3, 5)
    ops.qchunk_attn(torch.from_numpy(q[0, None]), torch.from_numpy(k[0, :1]),
                    torch.from_numpy(v[0, :1]), torch.from_numpy(k), torch.from_numpy(v),
                    3, 3, 1, 4)
    pool = torch.from_numpy(k).reshape(6, 3, 2, 16)      # 6 pages of 3 rows
    table = torch.tensor([[4, 0, -1], [2, 5, 1]], dtype=torch.int32)
    ops.qpaged_decode_attn(torch.from_numpy(q), pool, pool, 3, 3, table,
                           torch.tensor([5, 8], dtype=torch.int32))
    ops.qpaged_chunk_attn(torch.from_numpy(q[0, None]), torch.from_numpy(k[0, :1]),
                          torch.from_numpy(v[0, :1]), pool, pool, 3, 3, table[1], 4)
    kv_new = torch.from_numpy(k[:, 0] / 8.0).to(torch.float32)
    ops.qragged_attn(torch.from_numpy(q), kv_new, kv_new, pool, pool, 3, 3, table,
                     torch.tensor([1, 0], dtype=torch.int32),
                     torch.tensor([4, -1], dtype=torch.int32))
    from repro_torch.core.qformat import quantize_tensor_packed

    ops.wq4_matmul(torch.from_numpy(x), quantize_tensor_packed(torch.from_numpy(x.T.copy()), 4,
                                                               block_size=8))
    assert ops.launch_counts() == {"wq_matmul": 0, "wq4_matmul": 0, "qdecode_attn": 0,
                                   "qchunk_attn": 0, "qpaged_decode_attn": 0,
                                   "qpaged_chunk_attn": 0, "qragged_attn": 0, "qmm": 0,
                                   "qmm_requant": 0, "qconv1d": 0, "fake_quant": 0}


def test_ops_transpose_path_is_dequantize_then_matmul():
    rng = np.random.default_rng(5)
    table = rng.integers(-128, 128, (30, 8)).astype(np.int8)
    n_exp = rng.integers(3, 7, (8,)).astype(np.int32)
    w = QTensor(torch.from_numpy(table), torch.from_numpy(n_exp), 8, 1)
    x = torch.from_numpy(rng.normal(0, 1, (3, 8)).astype(np.float32))
    torch.testing.assert_close(ops.wq_matmul(x, w, transpose=True), x @ w.dequantize().T,
                               rtol=0, atol=0)


def test_ops_wq_matmul_refuses_multi_axis_exponent_grid():
    """Only per-tensor and per-output-channel exponents reach the kernel; a
    (2, N) grid raises rather than taking a dequantize path."""
    rng = np.random.default_rng(6)
    wq = torch.from_numpy(rng.integers(-128, 128, (6, 5)).astype(np.int8))
    n_exp = torch.from_numpy(rng.integers(3, 7, (2, 5)).astype(np.int32))
    x = torch.from_numpy(rng.normal(0, 1, (3, 6)).astype(np.float32))
    with pytest.raises(ValueError, match="scale has 10 entries for N=5"):
        ops.wq_matmul(x, QTensor(wq, n_exp, 8, None))


def test_force_kernel_refuses_cpu_tensors(monkeypatch):
    """``FORCE`` is None or "plain": "kernel" (dropped, it had no caller) is
    refused with the same ValueError as any other setting, e.g. "pallas"."""
    q, k, v = _qd_inputs(1, 2, 1, 8, 4, seed=3)
    for setting in ("kernel", "pallas"):
        monkeypatch.setattr(ops, "FORCE", setting)
        with pytest.raises(ValueError, match="expected None or 'plain'"):
            ops.qdecode_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             3, 3, 2)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.qchunk_attn import qchunk_attn_cuda
    from repro_torch.kernels.qdecode_attn import qdecode_attn_cuda
    from repro_torch.kernels.wq_matmul import wq_matmul_cuda

    with pytest.raises(ValueError, match="CUDA"):
        wq_matmul_cuda(torch.zeros(2, 4), torch.zeros(4, 3, dtype=torch.int8), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        qdecode_attn_cuda(torch.zeros(1, 2, 16), torch.zeros(1, 4, 1, 16, dtype=torch.int8),
                          torch.zeros(1, 4, 1, 16, dtype=torch.int8), 3, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        qchunk_attn_cuda(torch.zeros(2, 2, 16), torch.zeros(2, 1, 16), torch.zeros(2, 1, 16),
                         torch.zeros(1, 4, 1, 16, dtype=torch.int8),
                         torch.zeros(1, 4, 1, 16, dtype=torch.int8), 3, 3, 0, 1)


def test_importing_kernels_builds_nothing():
    """The kernel modules load no library and start no compiler at import."""
    code = (f"import sys; sys.path.insert(0, {str(SRC)!r}); "
            "import repro_torch.kernels.ops, repro_torch.kernels._build as b; "
            "assert not b._loaded; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 576, 192), (1024, 576, 1536), (3, 37, 53), (32, 576, 576),
                                   (72, 576, 1536), (144, 1536, 576), (33, 1001, 77)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_cuda_kernel_wq_matmul_matches_plain(m, k, n, per_channel):
    _need_card()
    x, wq, _, scale = _wq_inputs(m, k, n, per_channel, seed=7)
    args = [torch.from_numpy(np.array(a)).cuda() for a in (x, wq, scale)]
    from repro_torch.kernels.wq_matmul import wq_matmul_cuda

    got = wq_matmul_cuda(*args)
    want = ref.wq_matmul_ref(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 256, 2048])
def test_cuda_kernel_qdecode_attn_matches_plain(s):
    _need_card()
    q, k, v = _qd_inputs(8, 9, 3, 64, s, seed=s)
    args = [torch.from_numpy(a).cuda() for a in (q, k, v)]
    lens = torch.randint(1, s + 1, (8,), dtype=torch.int32).cuda()
    from repro_torch.kernels.qdecode_attn import qdecode_attn_cuda

    torch.testing.assert_close(qdecode_attn_cuda(*args, 3, 3, lens),
                               ref.qdecode_attn_ref(*args, 3, 3, lens), rtol=1e-5, atol=1e-4)
