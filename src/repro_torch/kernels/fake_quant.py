"""Fused fake-quantization on Hopper: wrapper of ``csrc/fake_quant.cu``.

Replaces ``repro/kernels/fake_quant.py::fake_quant_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.fake_quant_ref`.  The factors
2^n and 2^-n come from the port's ``exp2`` table on the device, so the
kernel multiplies by the reference's own float32 values and nothing is
read back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import qformat
from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("fake_quant").fake_quant_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def factors(n: qformat.Exponent, device) -> torch.Tensor:
    """(2^n, 2^-n) as two float32 on ``device``, gathered from the ``exp2``
    table there: nothing is read back or copied from the host."""
    if isinstance(n, torch.Tensor) and (n.numel() != 1 or n.device != device):
        raise ValueError(f"fake_quant: n must be one integer on {device}")
    nd = qformat.on_device(n, device).reshape(())
    return torch.stack([qformat.exp2(nd), qformat.exp2(-nd)])


def fake_quant_cuda(x: torch.Tensor, n: qformat.Exponent, *, width: int = 8) -> torch.Tensor:
    """clip(trunc(x * 2^n), qmin, qmax) * 2^-n for a float32 CUDA tensor of
    any shape; ``n`` an int or one integer on the same device."""
    global launches
    if x.dtype != torch.float32:
        raise ValueError(f"fake_quant: x must be float32, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"fake_quant: x must be on a CUDA device, got {x.device}")
    if not 1 < width <= 32:
        raise ValueError(f"fake_quant: width {width} outside 2..32")
    xc = x.contiguous()
    fac = factors(n, x.device)
    out = torch.empty_like(xc)
    err = _kernel()(xc.data_ptr(), out.data_ptr(), fac.data_ptr(), qformat.qmin(width),
                    qformat.qmax(width), xc.numel(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error {err}")
    launches += 1
    return out
