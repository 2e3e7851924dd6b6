"""Ragged token-batch attention into an int8 KV pool on Hopper: wrapper of
``csrc/qragged_attn.cu``.

Replaces ``repro/kernels/qragged_attn.py::qragged_attn_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.qragged_attn_ref`.  The kernel
writes every token's quantized K/V row into the pool in place and is bound
by the int8 bytes of the slots' prefixes.  It splits each token's walk
across a thread-block cluster of
:func:`~repro_torch.kernels.attn_split.split_ranks` blocks, one launch per
call (``csrc/attn_split.cuh``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from repro_torch.kernels import _build, attn_split
from repro_torch.kernels.qpaged_attn import (_check_pool_alignment, _check_pools,
                                             _check_tensors, _head_geometry)

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qragged_attn").qragged_attn_f32_s8
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, i, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def qragged_attn_cuda(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                      table: torch.Tensor, slot_ids: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """q (T, Hq, D), k/v new (T, Hkv, D) f32; pools (P, ps, Hkv, D) int8,
    16-byte aligned, written in place through ``table`` (slots, max_pages)
    int32 at each token's (``slot_ids``, ``positions``) row, (T,) int32 each
    (position -1: inert); k_n/v_n scalar exponents.  Slot ids must index the
    table's rows.  Returns out (T, Hq, D).  One launch: each (KV head,
    token) walk is split across a cluster of
    ``attn_split.split_ranks`` blocks (from shapes alone)."""
    global launches
    what = "qragged_attn"
    if q.ndim != 3 or k_new.ndim != 3 or k_new.shape != v_new.shape or table.ndim != 2:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k/v new {tuple(k_new.shape)}/"
                         f"{tuple(v_new.shape)}, table {tuple(table.shape)}")
    t, hq, d = q.shape
    hkv = k_new.shape[1]
    if k_new.shape != (t, hkv, d) or _check_pools(what, k_pool, v_pool, d) != hkv:
        raise ValueError(f"{what}: k/v new {tuple(k_new.shape)} do not fit q {tuple(q.shape)} "
                         f"and pools {tuple(k_pool.shape)}")
    g = _head_geometry(what, hq, hkv, d)
    if slot_ids.shape != (t,) or positions.shape != (t,):
        raise ValueError(f"{what}: slot_ids {tuple(slot_ids.shape)} and positions "
                         f"{tuple(positions.shape)} must be ({t},)")
    if table.shape[0] < 1 or table.shape[1] < 1 or k_pool.shape[1] < 1 or t > 65535:
        raise ValueError(f"{what}: table {tuple(table.shape)}, pool {tuple(k_pool.shape)} or "
                         f"T={t} out of the kernel's range")
    _check_tensors(what, q.device, ((q, torch.float32, "q"), (k_new, torch.float32, "k_new"),
                                    (v_new, torch.float32, "v_new"),
                                    (k_pool, torch.int8, "k_pool"),
                                    (v_pool, torch.int8, "v_pool"),
                                    (table, torch.int32, "table"),
                                    (slot_ids, torch.int32, "slot_ids"),
                                    (positions, torch.int32, "positions")))
    _check_pool_alignment(what, k_pool, v_pool)
    k_ptr, k_val = _build.int_arg(k_n, q.device, f"{what}: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, f"{what}: v_n")
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
                    v_pool.data_ptr(), k_ptr, k_val, v_ptr, v_val, table.data_ptr(),
                    slot_ids.data_ptr(), positions.data_ptr(), out.data_ptr(), t,
                    k_pool.shape[1], table.shape[1], hkv, g, d, 1.0 / math.sqrt(d),
                    attn_split.split_ranks(table.shape[1] * k_pool.shape[1], t, hkv, d),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
