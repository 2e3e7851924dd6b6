"""Weight-only int8 matmul on Hopper: wrapper of ``csrc/wq_matmul.cu``.

Replaces ``repro/kernels/wq_matmul.py::wq_matmul_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.wq_matmul_ref`.  The kernel is
the bf16 tensor-core GEMM of ``csrc/wq_gemm.cuh`` at every M: one launch
per call, K split across a thread-block cluster
(:mod:`repro_torch.kernels.wq_gemm` plans it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, wq_gemm

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None
plan = wq_gemm.tile_plan   # the launch of an (M, K) @ (K, N) call


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("wq_matmul").wq_matmul_f32_s8
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grants() -> int:
    """The ``cudaFuncSetAttribute`` calls the loaded library has made: one
    per tile kernel it has launched, so at most 3 (``csrc/wq_gemm.cuh``
    keeps each library's record of its grants apart)."""
    fn = _build.load("wq_matmul").wq_matmul_grants
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def wq_matmul_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 @ wq (K, N) int8, times ``scale`` (() or (N,) f32).

    All operands contiguous on one CUDA device; returns (M, N) f32.
    """
    global launches
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"wq_matmul: shapes {tuple(x.shape)} @ {tuple(wq.shape)}")
    m, k = x.shape
    n = wq.shape[1]
    if scale.numel() not in (1, n):
        raise ValueError(f"wq_matmul: scale has {scale.numel()} entries for N={n}")
    for t, dt, nm in ((x, torch.float32, "x"), (wq, torch.int8, "wq"),
                      (scale, torch.float32, "scale")):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"wq_matmul: {nm} must be on {x.device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"wq_matmul: {nm} must be contiguous {dt}, got {t.dtype}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    p = plan(m, k, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    1 if scale.numel() == n and n > 1 else 0, out.data_ptr(),
                    m, k, n, p.bm, p.ranks, p.k_per_rank, stream)
    if err != 0:
        raise RuntimeError(f"wq_matmul kernel launch failed for M={m}, K={k}, N={n}, {p}: "
                           f"CUDA error {err}")
    launches += 1
    return out
