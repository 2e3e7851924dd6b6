"""Attention over a paged int8 KV cache on Hopper: wrappers of
``csrc/qpaged_attn.cu``.

Replaces ``repro/kernels/qpaged_attn.py::qpaged_decode_attn_pallas`` and
``::qpaged_chunk_attn_pallas``.  The plain versions are
:func:`repro_torch.kernels.ref.qpaged_decode_attn_ref` and
:func:`~repro_torch.kernels.ref.qpaged_chunk_attn_ref`.  Both kernels are
bound by the int8 K/V bytes they read through the page table.  Decode
splits each slot's walk across a thread-block cluster of
:func:`~repro_torch.kernels.attn_split.split_ranks` blocks (one launch per
call, ``csrc/attn_split.cuh``); the chunk kernel runs the chunk core of
``csrc/chunk_split.cuh`` (shared with ``qchunk_attn``): each query tile on
the bf16x3 tensor cores, the prefix split across a cluster of
:func:`~repro_torch.kernels.attn_split.chunk_ranks` blocks, one launch per
call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from repro_torch.kernels import _build, attn_split

decode_launches = 0   # kernel launches since the last reset (kernels/ops.py)
chunk_launches = 0
_fns = {}


def _kernel(name: str, argtypes):
    if name not in _fns:
        fn = getattr(_build.load("qpaged_attn"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_pools(what: str, k_pool: torch.Tensor, v_pool: torch.Tensor, d: int) -> int:
    """Hkv of (P, ps, Hkv, D) pools."""
    if k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} are not "
                         f"(P, ps, Hkv, D={d})")
    return k_pool.shape[2]


def _check_tensors(what: str, device, items) -> None:
    for t, dt, nm in items:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{what}: {nm} must be on {device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{what}: {nm} must be contiguous, aligned {dt}")


def _check_pool_alignment(what: str, k_pool: torch.Tensor, v_pool: torch.Tensor) -> None:
    """The split walk stages pool rows with 16-byte copies."""
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: pools must start on 16-byte boundaries")


def _head_geometry(what: str, hq: int, hkv: int, d: int) -> int:
    if hq % hkv:
        raise ValueError(f"{what}: Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if d not in (16, 32, 64, 128) or g > 16:
        raise ValueError(f"{what}: kernel takes D in (16, 32, 64, 128) and G <= 16 "
                         f"(got D={d}, G={g})")
    return g


def qpaged_decode_attn_cuda(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                            k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                            page_table: torch.Tensor,
                            kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B, Hq, D) f32; pools (P, ps, Hkv, D) int8, 16-byte aligned; k_n/v_n
    scalar exponents; page_table (B, max_pages) int32 (-1 unmapped);
    ``kv_len`` an int or a (B,) int32 tensor.  Returns (B, Hq, D).  One
    launch: each (KV head, slot) walk is split across a cluster of
    ``attn_split.split_ranks`` blocks (from shapes alone)."""
    global decode_launches
    what = "qpaged_decode_attn"
    if q.ndim != 3 or page_table.ndim != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, table {tuple(page_table.shape)}")
    b, hq, d = q.shape
    hkv, ps = _check_pools(what, k_pool, v_pool, d), k_pool.shape[1]
    g = _head_geometry(what, hq, hkv, d)
    if page_table.shape[1] < 1 or ps < 1 or b > 65535:
        raise ValueError(f"{what}: table {tuple(page_table.shape)} or page size {ps} is empty, "
                         f"or B={b} is out of the kernel's range")
    _check_tensors(what, q.device, ((q, torch.float32, "q"), (k_pool, torch.int8, "k_pool"),
                                    (v_pool, torch.int8, "v_pool"),
                                    (page_table, torch.int32, "page_table")))
    _check_pool_alignment(what, k_pool, v_pool)
    k_ptr, k_val = _build.int_arg(k_n, q.device, f"{what}: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, f"{what}: v_n")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32 or kv_len.device != q.device \
                or kv_len.numel() not in (1, b) or not kv_len.is_contiguous():
            raise ValueError(f"{what}: kv_len must be an int, or int32 of shape () or "
                             f"({b},) on {q.device}")
        len_ptr, len_stride, len_val = kv_len.data_ptr(), int(kv_len.numel() == b > 1), 0
    else:
        len_ptr, len_stride, len_val = None, 0, int(kv_len)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _kernel("qpaged_decode_attn_f32_s8",
                 [p, p, p, p, i, p, i, p, p, i, i, p, i, i, i, i, i, i, ctypes.c_float, i, p])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_ptr, k_val, v_ptr, v_val,
             page_table.data_ptr(), len_ptr, len_stride, len_val, out.data_ptr(), b, ps,
             page_table.shape[1], hkv, g, d, 1.0 / math.sqrt(d),
             attn_split.split_ranks(page_table.shape[1] * ps, b, hkv, d),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    decode_launches += 1
    return out


def qpaged_chunk_attn_cuda(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                           page_row: torch.Tensor,
                           start: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (C, Hq, D), k/v chunk (C, Hkv, D) f32; pools (P, ps, Hkv, D) int8,
    16-byte aligned, written in place at the pool rows of logical rows
    [start, start+C) that ``page_row`` (max_pages,) int32 maps (rows on -1
    entries or past the table are dropped); ``start`` an int >= 0 or one
    int32 on the card.  Returns out (C, Hq, D).  One launch: each (query
    tile, KV head) prefix is split across a cluster of
    ``attn_split.chunk_ranks`` blocks (from shapes alone, never ``start``)."""
    global chunk_launches
    what = "qpaged_chunk_attn"
    if q.ndim != 3 or k_chunk.ndim != 3 or k_chunk.shape != v_chunk.shape \
            or page_row.ndim != 1:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, chunk {tuple(k_chunk.shape)}/"
                         f"{tuple(v_chunk.shape)}, page row {tuple(page_row.shape)}")
    c, hq, d = q.shape
    hkv = k_chunk.shape[1]
    if k_chunk.shape != (c, hkv, d) or _check_pools(what, k_pool, v_pool, d) != hkv:
        raise ValueError(f"{what}: chunk {tuple(k_chunk.shape)} does not fit q "
                         f"{tuple(q.shape)} and pools {tuple(k_pool.shape)}")
    g = _head_geometry(what, hq, hkv, d)
    if page_row.shape[0] < 1 or k_pool.shape[1] < 1:
        raise ValueError(f"{what}: page row {tuple(page_row.shape)} or pool "
                         f"{tuple(k_pool.shape)} is empty")
    if not isinstance(start, torch.Tensor) and int(start) < 0:
        raise ValueError(f"{what}: start {start} < 0")
    _check_tensors(what, q.device, ((q, torch.float32, "q"),
                                    (k_chunk, torch.float32, "k_chunk"),
                                    (v_chunk, torch.float32, "v_chunk"),
                                    (k_pool, torch.int8, "k_pool"),
                                    (v_pool, torch.int8, "v_pool"),
                                    (page_row, torch.int32, "page_row")))
    _check_pool_alignment(what, k_pool, v_pool)
    k_ptr, k_val = _build.int_arg(k_n, q.device, f"{what}: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, f"{what}: v_n")
    s_ptr, s_val = _build.int_arg(start, q.device, f"{what}: start")
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _kernel("qpaged_chunk_attn_f32_s8",
                 [p, p, p, p, p, p, i, p, i, p, p, i, p, i, i, i, i, i, i, ctypes.c_float, i, p])
    ps, mp = k_pool.shape[1], page_row.shape[0]
    err = fn(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), k_ptr, k_val, v_ptr, v_val, page_row.data_ptr(), s_ptr, s_val,
             out.data_ptr(), c, ps, mp, hkv, g, d, 1.0 / math.sqrt(d),
             attn_split.chunk_ranks(mp * ps, attn_split.chunk_tiles(c, g)[0], hkv, d),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    chunk_launches += 1
    return out
