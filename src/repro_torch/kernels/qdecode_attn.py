"""Decode attention over a dense int8 KV cache on Hopper: wrapper of
``csrc/qdecode_attn.cu``.

Replaces ``repro/kernels/qdecode_attn.py::qdecode_attn_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.qdecode_attn_ref`.  The kernel is
bound by the int8 K/V bytes of the live cache rows.
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qdecode_attn").qdecode_attn_f32_s8
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, p, i, i, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def qdecode_attn_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                      kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B, Hq, D) f32; caches (B, S, Hkv, D) int8; k_n/v_n scalar exponents;
    ``kv_len`` an int, a scalar or a (B,) int32 tensor.  Returns (B, Hq, D)."""
    global launches
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"qdecode_attn: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"qdecode_attn: q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    g = hq // hkv
    if d not in (16, 32, 64, 128) or g > 16:
        raise ValueError(f"qdecode_attn: kernel takes D in (16, 32, 64, 128) and "
                         f"G <= 16 (got D={d}, G={g})")
    for t, dt, nm in ((q, torch.float32, "q"), (k_cache, torch.int8, "k_cache"),
                      (v_cache, torch.int8, "v_cache")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"qdecode_attn: {nm} must be on {q.device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"qdecode_attn: {nm} must be contiguous, aligned {dt}")
    k_ptr, k_val = _build.int_arg(k_n, q.device, "qdecode_attn: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, "qdecode_attn: v_n")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32 or kv_len.device != q.device \
                or kv_len.numel() not in (1, b) or not kv_len.is_contiguous():
            raise ValueError("qdecode_attn: kv_len must be an int, or int32 of "
                             f"shape () or ({b},) on {q.device}")
        len_ptr, len_stride, len_val = kv_len.data_ptr(), int(kv_len.ndim == 1 and b > 1), 0
    else:
        len_ptr, len_stride, len_val = None, 0, int(kv_len)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_ptr, k_val,
                    v_ptr, v_val, len_ptr, len_stride, len_val, out.data_ptr(),
                    b, s, hkv, g, d, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"qdecode_attn kernel launch failed: CUDA error {err}")
    launches += 1
    return out
