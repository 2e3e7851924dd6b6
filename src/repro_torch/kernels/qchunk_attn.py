"""Chunked-prefill attention into one slot of a dense int8 cache on Hopper:
wrapper of ``csrc/qchunk_attn.cu``.

Replaces ``repro/kernels/qchunk_attn.py::qchunk_attn_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.qchunk_attn_ref`.  The kernel
quantizes the chunk's K/V into the cache in place; it runs the chunk core
of ``csrc/chunk_split.cuh`` (shared with ``qpaged_chunk_attn``: the cache
is a pool of page size S): each query tile on the bf16x3 tensor cores, the
slot's prefix split across a cluster of
:func:`~repro_torch.kernels.attn_split.chunk_ranks` blocks, one launch per
call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from repro_torch.kernels import _build, attn_split
from repro_torch.kernels.ref import check_chunk_target

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qchunk_attn").qchunk_attn_f32_s8
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, i, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def qchunk_attn_cuda(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                     slot: int, start: int) -> torch.Tensor:
    """q (C, Hq, D), k/v chunk (C, Hkv, D) f32; caches (B, S, Hkv, D) int8,
    16-byte aligned, written in place at rows [start, start+C) of ``slot``;
    k_n/v_n scalar exponents.  Returns out (C, Hq, D).  One launch: each
    (query tile, KV head) prefix is split across a cluster of
    ``attn_split.chunk_ranks`` blocks (from shapes alone)."""
    global launches
    if q.ndim != 3 or k_chunk.ndim != 3 or k_chunk.shape != v_chunk.shape \
            or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"qchunk_attn: shapes q {tuple(q.shape)}, chunk "
                         f"{tuple(k_chunk.shape)}/{tuple(v_chunk.shape)}, cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    c, hq, d = q.shape
    b, s, hkv, dk = k_cache.shape
    if k_chunk.shape != (c, hkv, d) or dk != d or hq % hkv:
        raise ValueError(f"qchunk_attn: q {tuple(q.shape)} and chunk "
                         f"{tuple(k_chunk.shape)} do not fit cache {tuple(k_cache.shape)}")
    g = hq // hkv
    if d not in (16, 32, 64, 128) or g > 16:
        raise ValueError(f"qchunk_attn: kernel takes D in (16, 32, 64, 128) and "
                         f"G <= 16 (got D={d}, G={g})")
    check_chunk_target(c, b, s, slot, start)
    for t, dt, nm in ((q, torch.float32, "q"), (k_chunk, torch.float32, "k_chunk"),
                      (v_chunk, torch.float32, "v_chunk"), (k_cache, torch.int8, "k_cache"),
                      (v_cache, torch.int8, "v_cache")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"qchunk_attn: {nm} must be on {q.device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"qchunk_attn: {nm} must be contiguous, aligned {dt}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("qchunk_attn: caches must start on 16-byte boundaries")
    k_ptr, k_val = _build.int_arg(k_n, q.device, "qchunk_attn: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, "qchunk_attn: v_n")
    out = torch.empty_like(q)
    ranks = attn_split.chunk_ranks(s, attn_split.chunk_tiles(c, g)[0], hkv, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), k_cache.data_ptr(),
                    v_cache.data_ptr(), k_ptr, k_val, v_ptr, v_val, out.data_ptr(),
                    b, c, s, hkv, g, d, int(slot), int(start), 1.0 / math.sqrt(d), ranks,
                    stream)
    if err != 0:
        raise RuntimeError(f"qchunk_attn kernel launch failed: CUDA error {err}")
    launches += 1
    return out
