"""Integer 1-D convolution on Hopper: wrapper of ``csrc/qconv1d.cu``.

Replaces ``repro/kernels/qconv1d.py::qconv1d_pallas``.  The plain version
is :func:`repro_torch.kernels.ref.qconv1d_ref`.  The kernel is an implicit
GEMM on the integer tensor cores (``csrc/int_mma.cuh``; int16 as four 8-bit
products on a hi/lo byte split): a block stages the input rows of its
output positions (halo included, padding masked) and a filter tile's
weights in shared memory, a chunk of channels (and taps) at a time where
one would not fit, so any C, K and stride run in one launch
(:func:`repro_torch.kernels.int_mma.conv_plan`); sums wrap modulo 2^32 as
XLA's int32 conv does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, int_mma
from repro_torch.kernels.ref import conv_pads

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None
_BYTES = {torch.int8: 1, torch.int16: 2}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qconv1d").qconv1d_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def qconv1d_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """x (B, W, C) * w (K, C, F), both int8 or both int16 on one CUDA
    device, SAME (XLA's split) or VALID, any stride >= 1; returns
    (B, W', F) int32 (wrapping)."""
    global launches
    if x.ndim != 3 or w.ndim != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"qconv1d: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _BYTES or w.dtype != x.dtype:
        raise ValueError(f"qconv1d: operands must be both int8 or both int16, got "
                         f"{x.dtype} and {w.dtype}")
    if stride < 1:
        raise ValueError(f"qconv1d: stride {stride} < 1")
    b, width, c = x.shape
    k, _, f = w.shape
    lo, _, wout = conv_pads(width, k, stride, padding)
    if wout < 1:
        raise ValueError(f"qconv1d: no output position for W={width}, K={k} ({padding})")
    for t, nm in ((x, "x"), (w, "w")):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"qconv1d: {nm} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"qconv1d: {nm} must be contiguous")
    out = torch.empty((b, wout, f), dtype=torch.int32, device=x.device)
    p = (int_mma.conv_plan(b, c, k, f, wout, stride, _BYTES[x.dtype]) if b and f
         else int_mma.ConvPlan(4, 1, 1, 1, 16))
    err = _kernel()(x.data_ptr(), w.data_ptr(), _BYTES[x.dtype], out.data_ptr(), b, width, c, k,
                    f, wout, stride, lo, *p, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv1d kernel launch failed for C={c}, K={k}, stride {stride} "
                           f"{x.dtype}, {p}: CUDA error {err}")
    launches += 1
    return out
