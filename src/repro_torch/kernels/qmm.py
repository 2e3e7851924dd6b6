"""Integer matmul on Hopper: wrapper of ``csrc/qmm.cu``.

Replaces ``repro/kernels/qmm.py::qmm_pallas`` and ``::qmm_requant_pallas``
(one source, one kernel with an optional epilogue).  The plain versions are
:func:`repro_torch.kernels.ref.qmm_ref` and :func:`~repro_torch.kernels.ref.
qmm_requant_ref`.  The products run on the integer tensor cores
(``csrc/int_mma.cuh``: int8 as ``mma`` s8, int16 as four 8-bit products on
a hi/lo byte split); sums wrap modulo 2^32 as XLA's int32 dot does.  One
launch per call, K split across a thread-block cluster where the output
tiles would not fill the card (:func:`repro_torch.kernels.int_mma.qmm_plan`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import qformat
from repro_torch.kernels import _build, int_mma

launches = 0           # qmm kernel launches since the last reset (kernels/ops.py)
requant_launches = 0   # qmm_requant kernel launches
_fn = None
_BYTES = {torch.int8: 1, torch.int16: 2}
plan = int_mma.qmm_plan   # the launch of an (M, K) @ (K, N) call


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qmm").qmm_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in _BYTES or w.dtype != x.dtype:
        raise ValueError(f"{what}: operands must be both int8 or both int16, got "
                         f"{x.dtype} and {w.dtype}")
    for t, nm in ((x, "x"), (w, "w")):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {nm} must be on {x.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {nm} must be contiguous")


def _launch(what, x, w, shift, out, lo, hi):
    m, k = x.shape
    n = w.shape[1]
    p = plan(m, k, n, _BYTES[x.dtype]) if m and n else int_mma.QmmPlan(16, 1, 64)
    err = _kernel()(x.data_ptr(), w.data_ptr(), _BYTES[x.dtype],
                    None if shift is None else shift.data_ptr(), out.data_ptr(),
                    out.element_size(), lo, hi, m, k, n, p.bm, p.ranks, p.k_per_rank,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed for M={m}, K={k}, N={n} {x.dtype}, "
                           f"{p}: CUDA error {err}")


def qmm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N), both int8 or both int16 on one CUDA device;
    returns (M, N) int32 (wrapping)."""
    global launches
    _check("qmm", x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32, device=x.device)
    _launch("qmm", x, w, None, out, 0, 0)
    launches += 1
    return out


def qmm_requant_cuda(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, *,
                     width: int = 8) -> torch.Tensor:
    """(x @ w) >> shift (or the wrapping << -shift), saturated to ``width``
    bits: int8 out for width <= 8, int16 for 9-16.  ``shift`` is one int32
    on the device, read by the kernel (nothing comes back to the host)."""
    global requant_launches
    _check("qmm_requant", x, w)
    if shift.numel() != 1 or shift.dtype != torch.int32 or shift.device != x.device:
        raise ValueError(f"qmm_requant: shift must be one int32 on {x.device}")
    if not 1 < width <= 16:
        raise ValueError(f"qmm_requant: width {width} outside 2..16")
    out = torch.empty((x.shape[0], w.shape[1]), dtype=qformat.storage_dtype(width),
                      device=x.device)
    _launch("qmm_requant", x, w, shift.contiguous(), out, qformat.qmin(width),
            qformat.qmax(width))
    requant_launches += 1
    return out
