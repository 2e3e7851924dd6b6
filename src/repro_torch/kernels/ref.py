"""Plain PyTorch versions of the ported kernels (``repro/kernels/ref.py``).

Each is the straightforward tensor expression of what its CUDA kernel
computes.  The wrappers run them for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels to them on the card.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.core import qformat

NEG_INF = -1e30
_EXACT_INT = (torch.int8, torch.int16)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Integers (int64, or float64 holding integers) modulo 2^32 as int32:
    what XLA's wrapping int32 arithmetic gives."""
    v = v.to(torch.int64)
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _exact_operands(what: str, *ts: torch.Tensor) -> None:
    """The plain integer products run in float64: every product of int16
    codes is below 2^30 and every partial sum of fewer than 2^23 of them
    below 2^53, so the sums are exact in any order."""
    for t in ts:
        if t.dtype not in _EXACT_INT:
            raise TypeError(f"{what}: integer operands must be int8 or int16, got {t.dtype}")


def qmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int (M, K) @ (K, N) into int32; the sum wraps modulo 2^32."""
    _exact_operands("qmm", x, w)
    if x.shape[-1] >= 1 << 23:
        raise ValueError(f"qmm: K={x.shape[-1]} past the exact float64 range")
    return wrap_int32(torch.matmul(x.to(torch.float64), w.to(torch.float64)))


def qmm_requant_ref(x: torch.Tensor, w: torch.Tensor, shift, *, width: int = 8) -> torch.Tensor:
    """Integer matmul, then ``acc >> shift`` (shift >= 0) or the wrapping
    ``acc << -shift``, with XLA's semantics for shifts of 32 or more (sign
    fill, 0), saturated to ``width`` bits in its storage dtype: the
    unguarded shift of ``repro``'s ``qmm_requant_ref``, not
    ``qformat.requantize``."""
    acc = qmm_ref(x, w)
    s = qformat.on_device(shift, acc.device)
    shifted = torch.where(s >= 0, qformat.shift_right(acc, torch.clamp(s, min=0)),
                          qformat.shift_left(acc, torch.clamp(-s.to(torch.int64), min=0)))
    return torch.clamp(shifted, qformat.qmin(width), qformat.qmax(width)).to(
        qformat.storage_dtype(width))


def conv_pads(size: int, k: int, stride: int, padding: str) -> Tuple[int, int, int]:
    """(low pad, high pad, output size) of one spatial axis, as XLA pads:
    SAME puts ``pad_total // 2`` low and the rest high."""
    if padding == "SAME":
        out = -(-size // stride)
        total = max(0, (out - 1) * stride + k - size)
        return total // 2, total - total // 2, out
    if padding == "VALID":
        return 0, 0, (size - k) // stride + 1
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def int_conv_ref(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                 padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """Integer convolution, channels last: x (B, *S, C) int8/int16, w
    (*K, C/groups, F) -> (B, *S', F) int32 that wraps modulo 2^32, as one
    exact float64 GEMM per kernel offset."""
    _exact_operands("integer conv", x, w)
    nd = x.ndim - 2
    ks = w.shape[:nd]
    pads = [conv_pads(x.shape[1 + i], ks[i], strides[i], padding) for i in range(nd)]
    spec = []
    for lo, hi, _ in reversed(pads):
        spec += [lo, hi]
    xp = torch.nn.functional.pad(x.to(torch.float64), [0, 0] + spec)
    wf = w.to(torch.float64)
    cg, f = w.shape[-2], w.shape[-1]
    fg = f // groups
    acc = None
    for off in itertools.product(*(range(k) for k in ks)):
        idx = (slice(None),) + tuple(
            slice(o, o + (out - 1) * st + 1, st) for o, st, (_, _, out) in zip(off, strides, pads))
        xs = xp[idx]
        parts = [torch.matmul(xs[..., g * cg:(g + 1) * cg], wf[off][:, g * fg:(g + 1) * fg])
                 for g in range(groups)]
        term = parts[0] if groups == 1 else torch.cat(parts, dim=-1)
        acc = term if acc is None else acc + term
    return wrap_int32(acc)


def qconv1d_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
    """x (B, W, C) int, w (K, C, F) int -> (B, W', F) int32 (wrapping)."""
    return int_conv_ref(x, w, (stride,), padding)


def fake_quant_ref(x: torch.Tensor, n: qformat.Exponent, *, width: int = 8) -> torch.Tensor:
    """Quantize-dequantize on the pow2 grid 2^-n: clip(trunc(x * 2^n)) * 2^-n
    in float32, with the factors of ``qformat.exp2``."""
    return qformat.quantize_dequantize(x, n, width).to(x.dtype)


def wq_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale) -> torch.Tensor:
    """float32 x (M, K) @ (int8 wq (K, N) * scale), scale () or (N,)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=wq.device)
    if s.numel() not in (1, wq.shape[1]):
        raise ValueError(f"wq_matmul: scale has {s.numel()} entries for N={wq.shape[1]}")
    w = wq.to(torch.float32) * s.reshape(-1).expand(wq.shape[1])
    return torch.matmul(x.to(torch.float32), w)


def wq4_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale, *, k: int, width: int = 4,
                   block_size: int = 0) -> torch.Tensor:
    """float32 x (M, K) @ the packed sub-int8 weight, dequantized.

    ``wq`` (ceil(K/lanes), N) int8 holds ``width``-bit lanes along K
    (:func:`repro_torch.core.qformat.pack_subint8`); ``scale`` is 2^-n per
    output channel (``block_size=0``; (), (N,) or (1, N)) or per block of
    ``block_size`` K rows ((ceil(K/block_size), N)).  The codes widen to
    float32 before any product.
    """
    n_out = wq.shape[-1]
    w = qformat.unpack_subint8(wq, width, k, axis=-2).to(torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=wq.device)
    if block_size:
        s = qformat.repeat_blocks(s.reshape(-1, n_out), block_size, k)
    else:
        s = s.reshape(1, -1).expand(1, n_out)
    return torch.matmul(x.to(torch.float32), w * s)


def qdecode_attn_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_n: qformat.Exponent, v_n: qformat.Exponent,
                     kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Dequantize-everything decode attention.

    q (B, Hq, D) f32; caches (B, S, Hkv, D) int8; k_n/v_n scalar exponents;
    ``kv_len`` scalar or (B,) live lengths.  Returns (B, Hq, D).
    """
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    k = qformat.dequantize(k_cache, k_n)
    v = qformat.dequantize(v_cache, v_n)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
        kv_len = kv_len[:, None, None, None]
    scores = torch.where(pos < kv_len, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(b, hq, d).to(q.dtype)


def check_chunk_target(c: int, b: int, s: int, slot: int, start: int,
                       what: str = "qchunk_attn") -> None:
    """Raise unless rows [start, start+C) of batch row ``slot`` lie inside a
    (B, S) cache.  The reference's ``dynamic_update_slice`` would silently
    shift such a write; the scheduler's chunk-padded extent check keeps
    every real chunk inside."""
    if not (0 <= slot < b and 0 <= start and start + c <= s):
        raise ValueError(f"{what}: chunk of {c} rows at slot {slot}, start {start} "
                         f"does not fit a cache of {b} slots x {s} rows")


def qchunk_attn_ref(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_n: qformat.Exponent, v_n: qformat.Exponent,
                    slot: int, start: int) -> torch.Tensor:
    """Chunked-prefill attention into one slot of a dense int8 cache.

    Quantizes the chunk's K/V onto the pow2 grid, writes them **in place**
    into rows [start, start+C) of ``slot`` of the (B, S, Hkv, D) int8 caches,
    then attends query c over positions <= start + c of that slot.  q
    (C, Hq, D), k/v chunk (C, Hkv, D) f32; ``slot``/``start`` Python ints.
    Returns out (C, Hq, D).
    """
    c, hq, d = q.shape
    b, s, hkv = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    check_chunk_target(c, b, s, slot, start)
    k_cache[slot, start:start + c] = qformat.quantize(k_chunk, k_n, 8)
    v_cache[slot, start:start + c] = qformat.quantize(v_chunk, v_n, 8)
    k = qformat.dequantize(k_cache[slot], k_n)
    v = qformat.dequantize(v_cache[slot], v_n)
    qg = q.reshape(c, hkv, g, d).to(torch.float32)
    scores = torch.einsum("chgd,shd->hgcs", qg, k) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    visible = pos[None, :] <= start + torch.arange(c, device=q.device)[:, None]
    p = torch.softmax(torch.where(visible, scores, torch.full_like(scores, NEG_INF)), dim=-1)
    out = torch.einsum("hgcs,shd->chgd", p, v)
    return out.reshape(c, hq, d).to(q.dtype)


def gather_pages_ref(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Densify a paged pool: (P, ps, H, D) + (B, max_pages) -> (B, max_pages*ps, H, D).

    Unmapped (-1) entries read pool page 0, whose rows every consumer masks
    through the live length.
    """
    b, mp = page_table.shape
    pages = pool[torch.clamp(page_table, min=0).to(torch.int64)]
    return pages.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def qpaged_decode_attn_ref(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           k_n: qformat.Exponent, v_n: qformat.Exponent,
                           page_table: torch.Tensor,
                           kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Paged decode attention: gather each slot's pages into a dense
    (B, max_pages*ps, Hkv, D) view through the table, then the dense
    dequantize-everything decode.  q (B, Hq, D) f32; pools (P, ps, Hkv, D)
    int8; table (B, max_pages) int32, -1 unmapped; kv_len int or (B,).
    """
    k = gather_pages_ref(k_pool, page_table)
    v = gather_pages_ref(v_pool, page_table)
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device).reshape(-1)
    return qdecode_attn_ref(q, k, v, k_n, v_n, lens.expand(q.shape[0]))


def qpaged_chunk_attn_ref(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                          k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_n: qformat.Exponent, v_n: qformat.Exponent,
                          page_row: torch.Tensor, start: int) -> torch.Tensor:
    """Paged chunked prefill: quantize the chunk onto the pow2 grid, write its
    rows **in place** into the pool pages the slot's ``page_row``
    (max_pages,) names, then attend chunk query c over logical positions
    <= start + c through the row.  Rows on -1 entries or past the table are
    dropped.  q (C, Hq, D), k/v chunk (C, Hkv, D) f32; pools (P, ps, Hkv, D)
    int8.  Returns out (C, Hq, D).
    """
    c, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    mp = page_row.shape[0]
    pos = start + torch.arange(c, device=q.device)
    page = page_row[torch.clamp(pos // ps, max=mp - 1)]
    valid = (pos // ps < mp) & (page >= 0)
    # dropped rows go to a sentinel row past the pool: no mask of data-dependent
    # shape, so the function runs without a host sync (and in a CUDA graph)
    rows = n_pages * ps
    flat = torch.where(valid, page * ps + pos % ps, rows).to(torch.int64)
    for pool, x, n in ((k_pool, k_chunk, k_n), (v_pool, v_chunk, v_n)):
        ext = torch.cat([pool.reshape(rows, hkv, d), pool.new_zeros(1, hkv, d)])
        ext[flat] = qformat.quantize(x, n, 8)
        pool.copy_(ext[:rows].view(pool.shape))
    kf = qformat.dequantize(gather_pages_ref(k_pool, page_row[None])[0], k_n)
    vf = qformat.dequantize(gather_pages_ref(v_pool, page_row[None])[0], v_n)
    qg = q.reshape(c, hkv, g, d).to(torch.float32)
    scores = torch.einsum("chgd,shd->hgcs", qg, kf) / math.sqrt(d)
    visible = torch.arange(kf.shape[0], device=q.device)[None, :] <= pos[:, None]
    p = torch.softmax(torch.where(visible, scores, torch.full_like(scores, NEG_INF)), dim=-1)
    out = torch.einsum("hgcs,shd->chgd", p, vf)
    return out.reshape(c, hq, d).to(q.dtype)


def qragged_attn_ref(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_n: qformat.Exponent, v_n: qformat.Exponent, table: torch.Tensor,
                     slot_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Ragged token-batch attention: per-token scatter, then per-token attention.

    Token t is logical row ``positions[t]`` of slot ``slot_ids[t]``: its K/V
    row is quantized onto the pow2 grid and written **in place** into the
    pool through the (slots, max_pages) ``table`` (rows with position < 0,
    past the table or on a -1 entry are dropped), then its query attends
    that slot's mapped positions ``<= positions[t]``.  Rows that see nothing
    (inert rows, position < 0) give exact zeros.  q (T, Hq, D), k/v new
    (T, Hkv, D) f32; pools (P, ps, Hkv, D) int8; slot_ids/positions (T,)
    int32.  Returns out (T, Hq, D).
    """
    t, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    mp = table.shape[1]
    slots = slot_ids.to(torch.int64)
    pos = positions.to(torch.int64)
    lpage = torch.clamp(pos, min=0) // ps
    page = table[slots, torch.clamp(lpage, max=mp - 1)].to(torch.int64)
    valid = (pos >= 0) & (lpage < mp) & (page >= 0)
    # dropped rows go to a sentinel row past the pool (see qpaged_chunk_attn_ref)
    rows = n_pages * ps
    flat = torch.where(valid, page * ps + torch.clamp(pos, min=0) % ps, rows)
    for pool, x, n in ((k_pool, k_new, k_n), (v_pool, v_new, v_n)):
        ext = torch.cat([pool.reshape(rows, hkv, d), pool.new_zeros(1, hkv, d)])
        ext[flat] = qformat.quantize(x, n, 8)
        pool.copy_(ext[:rows].view(pool.shape))
    # densify each token's slot through the table, then mask to <= positions
    rows_t = table[slots]                                        # (T, max_pages)
    kf = qformat.dequantize(gather_pages_ref(k_pool, rows_t), k_n)   # (T, S', Hkv, D)
    vf = qformat.dequantize(gather_pages_ref(v_pool, rows_t), v_n)
    s = kf.shape[1]
    qg = q.reshape(t, hkv, g, d).to(torch.float32)
    scores = torch.einsum("thgd,tshd->thgs", qg, kf) / math.sqrt(d)
    mapped = torch.repeat_interleave(rows_t >= 0, ps, dim=1)    # (T, S')
    vis = (torch.arange(s, device=q.device)[None, :] <= pos[:, None]) & mapped
    p = torch.softmax(torch.where(vis[:, None, None, :], scores,
                                  torch.full_like(scores, NEG_INF)), dim=-1)
    # a row that sees nothing gives zeros, not a fully-masked softmax's mean
    p = torch.where(vis.any(dim=-1)[:, None, None, None], p, torch.zeros_like(p))
    out = torch.einsum("thgs,tshd->thgd", p, vf)
    return out.reshape(t, hq, d).to(q.dtype)
