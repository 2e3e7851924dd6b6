"""Decode attention over a dense int8 KV cache on Hopper: wrapper of
``csrc/qdecode_attn.cu``.

Replaces ``repro/kernels/qdecode_attn.py::qdecode_attn_pallas``.  The plain
version is :func:`repro_torch.kernels.ref.qdecode_attn_ref`.  The kernel is
bound by the int8 K/V bytes of the live cache rows.  It runs the split walk
of ``csrc/attn_split.cuh``, the body of ``qpaged_decode_attn``: the dense
cache is a pool of B pages of page size S under the table ``arange(B)[:,
None]``, and each (KV head, slot) walk is split across a thread-block
cluster of :func:`~repro_torch.kernels.attn_split.split_ranks` blocks (from
shapes alone), one launch per call.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import _build, attn_split

launches = 0   # kernel launches since the last reset (kernels/ops.py)
_fn = None


class Plan(NamedTuple):
    """The split walk's layout of a dense cache (``csrc/qdecode_attn.cu``
    builds the same from S)."""
    ps: int          # page size: S, the whole cache row of a slot
    max_pages: int   # 1: slot b reads pool page b (the table row {b})
    ranks: int       # blocks of the cluster that splits each (KV head, slot) walk


def plan(b: int, s: int, hkv: int, d: int) -> Plan:
    """The launch for B slots of S positions at Hkv KV heads of dimension D:
    from shapes alone, never ``kv_len``, so a call reads nothing back and is
    safe under CUDA-graph capture.  The page size is S, never smaller: a row
    with kv_len <= 0 averages V over the page it visits, which must be the
    whole row, as in the Pallas kernel and the plain version."""
    return Plan(s, 1, attn_split.split_ranks(s, b, hkv, d))


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("qdecode_attn").qdecode_attn_f32_s8
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, p, i, i, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def qdecode_attn_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_n: Union[int, torch.Tensor], v_n: Union[int, torch.Tensor],
                      kv_len: Union[int, torch.Tensor], *,
                      ranks: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, D) f32; caches (B, S, Hkv, D) int8, 16-byte aligned; k_n/v_n
    scalar exponents; ``kv_len`` an int, a 0-d or a (B,) int32 tensor.
    Returns (B, Hq, D).  One launch: each (KV head, slot) walk is split
    across a cluster of ``ranks`` blocks (1 to 8; by default
    :func:`plan`'s, from shapes alone)."""
    global launches
    what = "qdecode_attn"
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    g = hq // hkv
    if d not in (16, 32, 64, 128) or g > 16 or s < 1 or b > 65535:
        raise ValueError(f"{what}: kernel takes D in (16, 32, 64, 128), G <= 16, S >= 1 "
                         f"and B <= 65535 (got D={d}, G={g}, S={s}, B={b})")
    for t, dt, nm in ((q, torch.float32, "q"), (k_cache, torch.int8, "k_cache"),
                      (v_cache, torch.int8, "v_cache")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {nm} must be on {q.device} (CUDA)")
        if t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{what}: {nm} must be contiguous, aligned {dt}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{what}: caches must start on 16-byte boundaries (the split walk "
                         f"stages rows with 16-byte copies)")
    if ranks is None:
        ranks = plan(b, s, hkv, d).ranks
    elif not 1 <= ranks <= attn_split.MAX_RANKS:
        raise ValueError(f"{what}: ranks {ranks} outside 1..{attn_split.MAX_RANKS}")
    k_ptr, k_val = _build.int_arg(k_n, q.device, f"{what}: k_n")
    v_ptr, v_val = _build.int_arg(v_n, q.device, f"{what}: v_n")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32 or kv_len.device != q.device \
                or kv_len.numel() not in (1, b) or not kv_len.is_contiguous():
            raise ValueError(f"{what}: kv_len must be an int, or int32 of "
                             f"shape () or ({b},) on {q.device}")
        len_ptr, len_stride, len_val = kv_len.data_ptr(), int(kv_len.numel() == b > 1), 0
    else:
        len_ptr, len_stride, len_val = None, 0, int(kv_len)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_ptr, k_val,
                    v_ptr, v_val, len_ptr, len_stride, len_val, out.data_ptr(),
                    b, s, hkv, g, d, 1.0 / math.sqrt(d), ranks, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
