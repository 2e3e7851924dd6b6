"""Packed int4 weight-only matmul on Hopper: wrapper of ``csrc/wq4_matmul.cu``.

Replaces ``repro/kernels/wq_matmul.py::wq4_matmul_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.wq4_matmul_ref`.  The kernel is
the bf16 tensor-core GEMM of ``csrc/wq_gemm.cuh`` at every M: one launch
per call, K split across a thread-block cluster whose ranks add their
partial tiles in a fixed order, so a result never depends on the run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, wq_gemm

launches = 0   # wrapper calls that launched the kernel since the last reset (kernels/ops.py)
_fn = None
plan = wq_gemm.tile_plan   # the launch of an (M, K) @ packed (K, N) call


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("wq4_matmul").wq4_matmul_f32_s4
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grants() -> int:
    """The ``cudaFuncSetAttribute`` calls the loaded library has made: one
    per tile kernel it has launched, so at most 3 (``csrc/wq_gemm.cuh``
    keeps each library's record of its grants apart)."""
    fn = _build.load("wq4_matmul").wq4_matmul_grants
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def wq4_matmul_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *, k: int,
                    block_size: int = 0) -> torch.Tensor:
    """x (M, K) f32 @ packed int4 wq (ceil(K/2), N) int8 with ``scale`` f32:
    (1, N) per output channel (``block_size=0``) or (ceil(K/bs), N) per
    block of ``block_size`` K rows (any even size).  All on one CUDA
    device; returns (M, N) f32."""
    global launches
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != k or wq.shape[0] != -(-k // 2):
        raise ValueError(f"wq4_matmul: x {tuple(x.shape)}, packed wq {tuple(wq.shape)} "
                         f"for K={k}")
    if block_size % 2 or block_size < 0:
        raise ValueError(f"block_size must be even, got {block_size}")
    m, n = x.shape[0], wq.shape[1]
    rows = -(-k // block_size) if block_size else 1
    if tuple(scale.shape) != (rows, n):
        raise ValueError(f"wq4_matmul: scale {tuple(scale.shape)} != {(rows, n)}")
    for t, dt, nm in ((x, torch.float32, "x"), (wq, torch.int8, "wq"),
                      (scale, torch.float32, "scale")):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"wq4_matmul: {nm} must be on {x.device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"wq4_matmul: {nm} must be contiguous {dt}, got {t.dtype}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    p = plan(m, k, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), block_size, out.data_ptr(),
                    m, k, n, p.bm, p.ranks, p.k_per_rank, stream)
    if err != 0:
        raise RuntimeError(f"wq4_matmul kernel launch failed for M={m}, K={k}, N={n}, "
                           f"block {block_size}, {p}: CUDA error {err}")
    launches += 1
    return out
