"""Public kernel entry points, dispatched by the device of their tensors
(``repro/kernels/ops.py``).

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, and a kernel that fails to build or launch
raises — nothing falls back.  ``FORCE = "plain"`` runs the plain version
on any device, in-process (how ``chip_smoke.py`` and the tests compare on
the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core import qformat
from repro_torch.core.qformat import Exponent, PackedQTensor, QTensor
from repro_torch.kernels import fake_quant as _fake_quant
from repro_torch.kernels import qchunk_attn as _qchunk_attn
from repro_torch.kernels import qconv1d as _qconv1d
from repro_torch.kernels import qdecode_attn as _qdecode_attn
from repro_torch.kernels import qmm as _qmm
from repro_torch.kernels import qpaged_attn as _qpaged_attn
from repro_torch.kernels import qragged_attn as _qragged_attn
from repro_torch.kernels import ref
from repro_torch.kernels import wq4_matmul as _wq4_matmul
from repro_torch.kernels import wq_matmul as _wq_matmul

# None | "plain"
FORCE: Optional[str] = None

# kernel name -> (wrapper module, its launch counter)
_COUNTERS = {"wq_matmul": (_wq_matmul, "launches"),
             "wq4_matmul": (_wq4_matmul, "launches"),
             "qdecode_attn": (_qdecode_attn, "launches"),
             "qchunk_attn": (_qchunk_attn, "launches"),
             "qpaged_decode_attn": (_qpaged_attn, "decode_launches"),
             "qpaged_chunk_attn": (_qpaged_attn, "chunk_launches"),
             "qragged_attn": (_qragged_attn, "launches"),
             "qmm": (_qmm, "launches"),
             "qmm_requant": (_qmm, "requant_launches"),
             "qconv1d": (_qconv1d, "launches"),
             "fake_quant": (_fake_quant, "launches")}


def _use_kernel(t: torch.Tensor) -> bool:
    if FORCE not in (None, "plain"):
        raise ValueError(f"ops.FORCE={FORCE!r}: expected None or 'plain'")
    return FORCE is None and t.is_cuda


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def _2d(x: torch.Tensor):
    """Leading dims collapsed to rows for the GEMM wrappers."""
    return x.reshape(-1, x.shape[-1]).contiguous(), x.shape[:-1]


def qmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer matmul with an int32 accumulator that wraps: x (..., K),
    w (K, N), both int8 or both int16 on the card.  Returns (..., N) int32."""
    x2, lead = _2d(x)
    if _use_kernel(x2):
        out = _qmm.qmm_cuda(x2, w.contiguous())
    else:
        out = ref.qmm_ref(x2, w)
    return out.reshape(*lead, w.shape[-1])


def qmm_requant(x: torch.Tensor, w: torch.Tensor, shift: Union[int, torch.Tensor], *,
                width: int = 8) -> torch.Tensor:
    """Integer matmul + shift-only requantization to ``width``-bit storage:
    ``shift`` >= 0 right-shifts the int32 accumulator (the paper's pow2
    rescale), < 0 left-shifts it (wrapping).  Returns (..., N) saturated to
    the Qm.n storage dtype.  On the card an int ``shift`` is filled in as
    one int32 there; a tensor is used where it lies."""
    x2, lead = _2d(x)
    if _use_kernel(x2):
        out = _qmm.qmm_requant_cuda(x2, w.contiguous(), qformat.on_device(shift, x2.device),
                                    width=width)
    else:
        out = ref.qmm_requant_ref(x2, w, shift, width=width)
    return out.reshape(*lead, w.shape[-1])


def fake_quant_fused(x: torch.Tensor, n: Exponent, *, width: int = 8) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the pow2 grid 2^-n in one pass (float32,
    any shape; ``n`` an int or one integer on ``x``'s device)."""
    if _use_kernel(x):
        return _fake_quant.fake_quant_cuda(x, n, width=width)
    return ref.fake_quant_ref(x, n, width=width)


def qconv1d(x: torch.Tensor, w: torch.Tensor, *, strides: int = 1,
            padding: str = "SAME") -> torch.Tensor:
    """Integer 1-D convolution with an int32 accumulator that wraps: x
    (B, W, C_in), w (K, C_in, C_out), both int8 or both int16 on the card.
    Returns (B, W', C_out) int32."""
    if _use_kernel(x):
        return _qconv1d.qconv1d_cuda(x.contiguous(), w.contiguous(), stride=strides,
                                     padding=padding)
    return ref.qconv1d_ref(x, w, stride=strides, padding=padding)


def wq_matmul(x: torch.Tensor, w: QTensor, *, transpose: bool = False) -> torch.Tensor:
    """x (..., K) float @ dequant(w): the weight-only int8 path.

    ``transpose=True`` gives tied-embedding logits x @ table.T; per-column
    exponents of the (V, D) table would scale K, not N, so that path stays
    dequantize + ``torch.matmul``, as in the reference.
    """
    if transpose:
        return torch.matmul(x, w.dequantize().T.to(x.dtype))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n_out = w.q.shape[-1]
    scale = w.scale.squeeze()
    if _use_kernel(x2):
        y = _wq_matmul.wq_matmul_cuda(x2, w.q, scale.contiguous())
    else:
        y = ref.wq_matmul_ref(x2, w.q, scale)
    return y.reshape(*lead, n_out).to(x.dtype)


def wq4_matmul(x: torch.Tensor, w: PackedQTensor) -> torch.Tensor:
    """x (..., K) float @ dequant(w): the packed sub-int8 weight-only path.

    Routed by the weight's format, as in the reference: a 2-D int4 weight
    goes to the kernel (the plain version on the CPU); int2 weights take the
    plain unpack-and-matmul on every device, and a stacked container is
    dequantized whole and multiplied.
    """
    if w.q.ndim != 2:
        return torch.matmul(x, w.dequantize().to(x.dtype))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n_out = w.q.shape[-1]
    bs = w.block_size or 0
    if w.width == 4 and _use_kernel(x2):
        # the kernel takes (1, N) or (ceil(K/bs), N) scale rows
        scale = w.scale if w.scale.ndim == 2 else w.scale.reshape(1, 1).expand(1, n_out)
        y = _wq4_matmul.wq4_matmul_cuda(x2, w.q, scale.contiguous(), k=w.k, block_size=bs)
    else:
        y = ref.wq4_matmul_ref(x2, w.q, w.scale, k=w.k, width=w.width, block_size=bs)
    return y.reshape(*lead, n_out).to(x.dtype)


def qdecode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_n: Exponent, v_n: Exponent,
                 kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Decode attention over a dense int8 KV cache.

    q (B, Hq, D) f32; caches (B, S, Hkv, D) int8; k_n/v_n scalar pow2
    exponents; kv_len scalar or (B,) live lengths.  Returns (B, Hq, D).
    """
    if _use_kernel(q):
        return _qdecode_attn.qdecode_attn_cuda(q.contiguous(), k_cache, v_cache,
                                               k_n, v_n, kv_len)
    return ref.qdecode_attn_ref(q, k_cache, v_cache, k_n, v_n, kv_len)


def qchunk_attn(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, k_n: Exponent, v_n: Exponent,
                slot: int, start: int) -> torch.Tensor:
    """Chunked prefill into one slot of a dense int8 KV cache.

    q (C, Hq, D), k/v chunk (C, Hkv, D) f32; caches (B, S, Hkv, D) int8, whose
    rows [start, start+C) of ``slot`` receive the quantized chunk in place;
    query c attends positions <= start + c.  ``slot``/``start`` are Python
    ints and must keep the chunk inside the cache.  Returns (C, Hq, D).
    """
    if _use_kernel(q):
        return _qchunk_attn.qchunk_attn_cuda(q.contiguous(), k_chunk.contiguous(),
                                             v_chunk.contiguous(), k_cache, v_cache,
                                             k_n, v_n, slot, start)
    return ref.qchunk_attn_ref(q, k_chunk, v_chunk, k_cache, v_cache, k_n, v_n, slot, start)


def qpaged_decode_attn(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_n: Exponent, v_n: Exponent, page_table: torch.Tensor,
                       kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Decode attention through a page table over int8 pools.

    q (B, Hq, D) f32; pools (P, ps, Hkv, D) int8; k_n/v_n scalar pow2
    exponents; page_table (B, max_pages) int32, -1 unmapped; kv_len (B,)
    live lengths.  Returns (B, Hq, D).
    """
    if _use_kernel(q):
        return _qpaged_attn.qpaged_decode_attn_cuda(q.contiguous(), k_pool, v_pool, k_n, v_n,
                                                    page_table, kv_len)
    return ref.qpaged_decode_attn_ref(q, k_pool, v_pool, k_n, v_n, page_table, kv_len)


def qpaged_chunk_attn(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor, k_n: Exponent,
                      v_n: Exponent, page_row: torch.Tensor, start: int) -> torch.Tensor:
    """Chunked prefill into a slot of a paged int8 cache.

    q (C, Hq, D), k/v chunk (C, Hkv, D) f32; pools (P, ps, Hkv, D) int8,
    whose pool rows under logical rows [start, start+C) of the slot's
    ``page_row`` (max_pages,) receive the quantized chunk in place; rows on
    unmapped entries or past the table are dropped.  Query c attends
    positions <= start + c.  Returns (C, Hq, D).
    """
    if _use_kernel(q):
        return _qpaged_attn.qpaged_chunk_attn_cuda(q.contiguous(), k_chunk.contiguous(),
                                                   v_chunk.contiguous(), k_pool, v_pool,
                                                   k_n, v_n, page_row, start)
    return ref.qpaged_chunk_attn_ref(q, k_chunk, v_chunk, k_pool, v_pool, k_n, v_n, page_row,
                                     start)


def qragged_attn(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor, k_n: Exponent, v_n: Exponent,
                 table: torch.Tensor, slot_ids: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Ragged token-batch attention into an int8 pool: one launch per layer
    of a ragged tick.

    q (T, Hq, D), k/v new (T, Hkv, D) f32; pools (P, ps, Hkv, D) int8, into
    which token t's quantized K/V row is written in place at logical row
    ``positions[t]`` of slot ``slot_ids[t]`` through ``table`` (slots,
    max_pages) int32 (rows at position -1, past the table or on -1 entries
    are dropped); token t attends that slot's mapped positions <=
    ``positions[t]``, and inert rows give zeros.  A dense (B, S, Hkv, D)
    cache passes itself as the pool under the identity table (B, 1).
    Returns out (T, Hq, D).
    """
    if _use_kernel(q):
        return _qragged_attn.qragged_attn_cuda(q.contiguous(), k_new.contiguous(),
                                               v_new.contiguous(), k_pool, v_pool, k_n, v_n,
                                               table, slot_ids, positions)
    return ref.qragged_attn_ref(q, k_new, v_new, k_pool, v_pool, k_n, v_n, table, slot_ids,
                                positions)
