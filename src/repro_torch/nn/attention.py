"""Grouped-query attention with RoPE over a dense or paged (optionally
int8) KV cache (``repro/nn/attention.py``: the lockstep and per-slot serving
paths).

Cache contract, one dict per layer (stacked layers add a leading layer axis
to ``k``/``v``), in one of two geometries:

* dense: ``{"k", "v": (B, S, Hkv, D), "len"}``;
* paged: ``{"k", "v": (P, ps, Hkv, D), "page_table": (B, max_pages), "len"}``
  — one pool of P pages of ps rows shared by every slot, and per slot a
  row of pool page indices (-1 unmapped): logical row p of slot b lives at
  row p % ps of pool page ``page_table[b, p // ps]``.

An int8 cache on the paper's Qm.n grid adds the exponents ``"k_n"`` /
``"v_n"`` (ints).  ``len`` is an int (lockstep) or, for the
continuous-batching scheduler, a (B,) int32 tensor on the cache's device
(``per_slot_len``; always for paged caches): every slot writes, masks and
ropes at its own offset.  One (B,) ``len`` and one page table serve every
layer of a stack, where the reference keeps an equal copy per layer.

Unlike the reference, the cache functions write K/V rows in place: the
returned dict shares the cache's ``k``/``v`` tensors, and only ``len`` and
``page_table`` are replaced by new values.  A paged pool is a view of the
first P * ps rows of a storage with one more row: the reference's scatters
drop rows at the out-of-range sentinel index P * ps, and here that index is
a real row that nothing reads, so a dropped write needs neither a
synchronizing mask nor a clamp onto a live row.

The ragged tick (:class:`RaggedBatch`) runs one forward over a flat (1, T)
token batch, each token with its own slot and logical row: int8 caches go
through ``ops.qragged_attn`` (a dense slab as a pool of B pages under the
identity table), float caches through :func:`append_kv_ragged` and
:func:`ragged_attention`.  Its layers leave ``len`` as it was;
``Stack.apply`` raises it once per tick (:func:`ragged_len`).

Cross-attention (the EncDec decoder, whisper) reads keys and values
projected from the encoder's output: with ``kv_source`` they are projected
on every call; with ``cross_cache`` (:func:`init_cross_cache`, written once
per admission by ``EncDecLM.write_cross_kv``) they are read from the slot's
cached rows, masked past its ``xlen``.  Both are plain float32 attention
without RoPE, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import qformat
from repro_torch.dist import shard_ops
from repro_torch.kernels.ref import check_chunk_target
from repro_torch.nn.layers import Dense
from repro_torch.nn.module import Context, Params

NEG_INF = -1e30


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse rotary frequencies ``1/theta^(2i/d)`` over half the head dim."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs     # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _flash_scores(q: torch.Tensor, k: torch.Tensor, q_offset, kv_len, causal: bool,
                  sliced: bool) -> torch.Tensor:
    """Masked scores (B, Hkv, G, Sq, Skv) of q (B, Sq, Hkv, G, D), already
    scaled, against k (B, Skv, Hkv, D).  ``sliced``: k holds only the keys
    below ``kv_len``; otherwise keys at or past it are masked."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = None if sliced else kpos < kv_len
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        seen = kpos[None, :] <= qpos[:, None]
        mask = seen if mask is None else mask & seen
    if mask is None:
        return s
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _flash_inputs(q, k, v, kv_len):
    """float32 q grouped as (B, Sq, Hkv, G, D) and scaled by 1/sqrt(D); k and
    v cut at ``kv_len`` when it is a Python int (then ``sliced``)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    sliced = not isinstance(kv_len, torch.Tensor)
    if sliced:
        k, v = k[:, :kv_len], v[:, :kv_len]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d) * (1.0 / math.sqrt(d))
    return qg, k.to(torch.float32), v.to(torch.float32), sliced


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: the forward is plain
    masked softmax attention; it saves only (q, k, v, out, lse), and the
    backward recomputes P one query block at a time (the FlashAttention-2
    recipe of the reference's ``_flash_bwd``), so nothing (Sq, Skv)-sized
    outlives a block."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, block_q):
        b, sq, hq, d = q.shape
        qg, kf, vf, sliced = _flash_inputs(q, k, v, kv_len)
        s = _flash_scores(qg, kf, q_offset, kv_len, causal, sliced)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
        out = torch.einsum("bhgqk,bkhd->bhgqd", p, vf) / l
        out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
        if any(ctx.needs_input_grad[:3]):
            lse = (m + torch.log(l))[..., 0]                    # (B, Hkv, G, Sq)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.q_offset, ctx.kv_len, ctx.causal, ctx.block_q = q_offset, kv_len, causal, block_q
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, lse = ctx.saved_tensors
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        scale = 1.0 / math.sqrt(d)
        qg, kf, vf, sliced = _flash_inputs(q, k, v, ctx.kv_len)
        go = gout.to(torch.float32).reshape(b, sq, hkv, g, d)
        # D_i = rowsum(dout * out)
        dall = torch.sum(go * out.reshape(b, sq, hkv, g, d), dim=-1).permute(0, 2, 3, 1)
        dq = torch.empty_like(qg)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        for i0 in range(0, sq, ctx.block_q):
            i1 = min(sq, i0 + ctx.block_q)
            qi, gi = qg[:, i0:i1], go[:, i0:i1]
            s = _flash_scores(qi, kf, ctx.q_offset + i0, ctx.kv_len, ctx.causal, sliced)
            p = torch.exp(s - lse[..., i0:i1, None])             # recomputed P
            dv += torch.einsum("bhgqk,bqhgd->bkhd", p, gi)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", gi, vf)
            ds = p * (dp - dall[..., i0:i1, None])
            dq[:, i0:i1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
            dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qi)
        pad = (0, 0, 0, 0, 0, skv - kf.shape[1])                  # keys cut at kv_len
        return (dq.reshape(b, sq, hq, d).to(q.dtype), F.pad(dk, pad).to(k.dtype),
                F.pad(dv, pad).to(v.dtype), None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset,
                    kv_len, causal: bool, block_q: int = 512) -> torch.Tensor:
    """The reference's ``flash_attention``: softmax attention in float32,
    differentiable in O(S·D) saved memory (:class:`_FlashAttention`).

    q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D), Hq = G * Hkv.  Key j is visible
    to query i when j < kv_len and, if causal, j <= q_offset + i.
    ``q_offset`` and ``kv_len`` are Python ints or 0-d device tensors; an
    int ``kv_len`` drops the keys at or past it before the product (the
    reference masks them to exp(-1e30 - m) = 0, which adds nothing), a
    tensor masks them.  ``block_q`` is the backward's query block.
    """
    return _FlashAttention.apply(q, k, v, q_offset, kv_len, causal, block_q)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
                     *, k_n: Optional[qformat.Exponent] = None,
                     v_n: Optional[qformat.Exponent] = None) -> torch.Tensor:
    """Single-token decode over the full cache; q (B, 1, Hq, D).

    int8 caches go to the ``qdecode_attn`` kernel (plain version on CPU);
    float caches take the einsum path.
    """
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.dtype == torch.int8:
        from repro_torch.kernels import ops

        out = ops.qdecode_attn(q[:, 0].to(torch.float32), k, v, k_n, v_n, kv_len)
        return out[:, None]
    qf = q[:, 0].reshape(b, hkv, hq // hkv, d).to(torch.float32) / math.sqrt(d)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.to(torch.float32))
    if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
        kv_len = kv_len[:, None, None, None]
    mask = torch.arange(skv, device=q.device) < kv_len
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return out.reshape(b, 1, hq, d)


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
                  quantized: bool, device, cache_n: int = 3,
                  layers: Optional[int] = None,
                  per_slot_len: bool = False) -> Dict[str, Any]:
    """A zeroed dense cache; ``layers`` adds a leading stacked-layer axis.

    ``cache_n`` is the frozen fractional-bit exponent of the int8 grid
    (Q4.3: range +-16, resolution 1/8).  ``per_slot_len`` makes ``len`` a
    (B,) int32 tensor, shared by the stacked layers.
    """
    shape = ((layers,) if layers else ()) + (batch, max_len, n_kv_heads, head_dim)
    dtype = torch.int8 if quantized else torch.float32
    ln = torch.zeros(batch, dtype=torch.int32, device=device) if per_slot_len else 0
    cache: Dict[str, Any] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device),
                             "len": ln}
    if quantized:
        cache["k_n"] = cache_n
        cache["v_n"] = cache_n
    return cache


def init_cross_cache(slots: int, enc_len: int, n_kv_heads: int, head_dim: int, *, device,
                     layers: Optional[int] = None) -> Dict[str, Any]:
    """A zeroed per-slot cross-attention cache (EncDec serving): ``xk`` /
    ``xv`` (slots, enc_len, Hkv, D) float32 hold each slot's encoder K/V
    rows, projected once at admission, and ``xlen`` (slots,) int32 the
    slot's live encoder length (0: evicted; rows past it are masked).
    ``layers`` adds a leading stacked-layer axis to all three, as the
    reference's scanned decoder stores them.  Deliberately not the ``{"k",
    "len"}`` pair of a KV cache, so the KV walkers pass it by."""
    lead = (layers,) if layers else ()
    shape = lead + (slots, enc_len, n_kv_heads, head_dim)
    return {"xk": torch.zeros(shape, dtype=torch.float32, device=device),
            "xv": torch.zeros(shape, dtype=torch.float32, device=device),
            "xlen": torch.zeros(lead + (slots,), dtype=torch.int32, device=device)}


def host_ints(values, device, dtype=torch.int32) -> torch.Tensor:
    """Host integers as a tensor on ``device``.  A CUDA copy goes through
    pinned memory without blocking the host: ``t[i] = python_int`` or a
    pageable copy would synchronize with the device."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def host_tensor(array, device) -> torch.Tensor:
    """A host (numpy) array on ``device``, through pinned memory on CUDA."""
    t = torch.from_numpy(array)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def init_paged_kv_cache(slots: int, max_pages: int, page_size: int, num_pages: int,
                        n_kv_heads: int, head_dim: int, *, quantized: bool, device,
                        cache_n: int = 3, layers: Optional[int] = None) -> Dict[str, Any]:
    """A zeroed paged cache: ``num_pages`` pool pages of ``page_size`` rows
    shared by ``slots`` slots, each with a ``max_pages``-entry table row
    (all -1, unmapped) and a (slots,) int32 ``len``.

    ``layers`` adds a leading stacked-layer axis to the pools; the table and
    ``len`` are shared by every layer.  Each pool is a view of the first
    ``num_pages * page_size`` rows of a storage with one spare row per
    layer, the target of dropped writes (:func:`paged_flat_index`).
    """
    dtype = torch.int8 if quantized else torch.float32
    lead = (layers,) if layers else ()
    rows = num_pages * page_size

    def pool():
        storage = torch.zeros(lead + (rows + 1, n_kv_heads, head_dim), dtype=dtype,
                              device=device)
        return storage.narrow(len(lead), 0, rows).unflatten(len(lead), (num_pages, page_size))

    cache: Dict[str, Any] = {
        "k": pool(), "v": pool(),
        "page_table": torch.full((slots, max_pages), -1, dtype=torch.int32, device=device),
        "len": torch.zeros(slots, dtype=torch.int32, device=device)}
    if quantized:
        cache["k_n"] = cache_n
        cache["v_n"] = cache_n
    return cache


def is_paged_cache(cache: Dict[str, Any]) -> bool:
    """True when ``cache`` is a paged pool dict (has a ``page_table``)."""
    return "page_table" in cache


def _pool_rows(pool: torch.Tensor) -> torch.Tensor:
    """The (P * ps + 1, Hkv, D) rows of one layer's (P, ps, Hkv, D) pool: its
    own rows, then the spare row that dropped writes land on."""
    n, ps, h, d = pool.shape
    end = (pool.storage_offset() + (n * ps + 1) * h * d) * pool.element_size()
    if not pool.is_contiguous() or pool.untyped_storage().nbytes() < end:
        raise ValueError("a paged pool needs its spare row: build it with init_paged_kv_cache")
    return pool.as_strided((n * ps + 1, h, d), (h * d, d, 1))


def paged_flat_index(row: torch.Tensor, pos: torch.Tensor, page_size: int,
                     num_pages: int) -> torch.Tensor:
    """Flat pool rows (int64) of logical positions ``pos`` of one slot.

    ``row``: (max_pages,) int32 table row; position p maps to
    ``row[p // page_size] * page_size + p % page_size``.  Positions past the
    table or on unmapped (-1) entries map to the sentinel
    ``num_pages * page_size``, the pool's spare row, which nothing reads.
    """
    mp = row.shape[-1]
    lp = pos // page_size
    page = row[torch.clamp(lp, max=mp - 1)]
    valid = (lp < mp) & (page >= 0)
    return torch.where(valid, page * page_size + pos % page_size,
                       num_pages * page_size).to(torch.int64)


def gather_kv_pages(cache: Dict[str, Any], slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify one slot of a (one-layer) paged cache: its pages in logical
    order, (max_pages * page_size, Hkv, D).  Unmapped entries read pool page
    0, past the slot's live length, which every consumer masks."""
    idx = torch.clamp(cache["page_table"][slot], min=0).to(torch.int64)
    ps = cache["k"].shape[1]
    sh = (idx.shape[0] * ps,) + tuple(cache["k"].shape[2:])
    return cache["k"][idx].reshape(sh), cache["v"][idx].reshape(sh)


@dataclasses.dataclass
class PageZero:
    """Where a data rank's decode reads the one device's pool page 0, under
    a mesh whose data ranks each hold one block of a paged pool.

    On one device a decode row reads pool page 0 through every unmapped
    (-1) entry below its live length: an idle slot's row (its ``len``
    keeps ticking) and a lane's slot past its reserved pages.  Those rows'
    outputs are never sampled, but an MoE routes them with the rest, so
    they compete for expert capacity.  Page 0 lies in data rank 0's block:
    every other rank keeps a mirror of it as one more page of its pool,
    ``page``, and reads its unmapped entries there.  ``refresh`` (the
    scheduler's call: page 0 was written since the last refresh, or may be
    in this step): each layer's decode broadcasts data rank 0's page 0,
    after that layer's appends, into every rank's mirror over ``axis``.
    """

    mesh: Any
    axis: str
    page: int
    refresh: bool
    _read: Optional[torch.Tensor] = None

    def read_table(self, cache: Dict[str, Any]) -> torch.Tensor:
        """One layer's (after its appends) table to read through."""
        rank = shard_ops.axis_index(self.mesh, self.axis)
        if self.refresh:
            pages = torch.stack([cache["k"][0], cache["v"][0]]) if rank == 0 else \
                torch.empty((2,) + tuple(cache["k"].shape[1:]), dtype=cache["k"].dtype,
                            device=cache["k"].device)
            shard_ops.broadcast(pages, self.mesh, self.axis, kind="page0")
            if rank != 0:
                cache["k"][self.page].copy_(pages[0])
                cache["v"][self.page].copy_(pages[1])
        if rank == 0:
            return cache["page_table"]
        if self._read is None:      # one table serves every layer of the step
            table = cache["page_table"]
            self._read = torch.where(table >= 0, table, torch.full_like(table, self.page))
        return self._read


def paged_decode_attention(q: torch.Tensor, cache: Dict[str, Any],
                           page_zero: Optional[PageZero] = None) -> torch.Tensor:
    """Single-token decode over a paged cache; q (B, 1, Hq, D).

    int8 pools go to the ``qpaged_decode_attn`` kernel (plain version on
    CPU), which reads through the table; float pools are densified through
    the table and take the einsum path.  ``page_zero``: under a mesh, read
    the unmapped entries where the one device's page 0 is
    (:class:`PageZero`).
    """
    ln = cache["len"]
    table = cache["page_table"] if page_zero is None else page_zero.read_table(cache)
    if cache["k"].dtype == torch.int8:
        from repro_torch.kernels import ops

        out = ops.qpaged_decode_attn(q[:, 0].to(torch.float32), cache["k"], cache["v"],
                                     cache["k_n"], cache["v_n"], table, ln)
        return out[:, None]
    b, mp, ps = q.shape[0], table.shape[1], cache["k"].shape[1]
    idx = torch.clamp(table, min=0).to(torch.int64)
    sh = (b, mp * ps) + tuple(cache["k"].shape[2:])
    return decode_attention(q, cache["k"][idx].reshape(sh), cache["v"][idx].reshape(sh), ln)


def _pages_axis(cache: Dict[str, Any]) -> int:
    """The pool axis of ``k``/``v``: 1 for stacked (L, P, ps, Hkv, D) pools."""
    return cache["k"].ndim - 4


def copy_kv_page(cache: Dict[str, Any], src: int, dst: int) -> Dict[str, Any]:
    """Copy pool page ``src`` onto pool page ``dst`` (K and V, every layer of
    a stacked pool), in place: the copy-on-write of prefix sharing, before
    the row that points at ``dst`` is installed."""
    ax = _pages_axis(cache)
    for name in ("k", "v"):
        cache[name].select(ax, dst).copy_(cache[name].select(ax, src))
    return cache


def set_page_row(cache: Dict[str, Any], slot: int, row) -> Dict[str, Any]:
    """Install a slot's table row (admission, resume): ``row`` (max_pages,)
    host ints, -1 past the allocated pages.  Returns the cache with a new
    table; one table serves every layer."""
    table = cache["page_table"].clone()
    table[slot].copy_(host_ints(row, table.device), non_blocking=True)
    return dict(cache, page_table=table)


def set_page_entry(cache: Dict[str, Any], slot: int, idx: int, page: int) -> Dict[str, Any]:
    """``page_table[slot, idx] = page`` — the lazy decode-growth append.
    ``fill_`` takes the value as a kernel argument, with no host sync."""
    table = cache["page_table"].clone()
    table[slot, idx:idx + 1].fill_(page)
    return dict(cache, page_table=table)


def gather_pool_pages(cache: Dict[str, Any], pages) -> Dict[str, torch.Tensor]:
    """Whole pool pages read out of the K/V pools (the swap-out gather):
    ``{"k", "v": (n, ps, Hkv, D)}``, a leading layer axis for stacked pools.
    Raw pool dtype, so int8 pages round-trip bit for bit."""
    ax = _pages_axis(cache)
    idx = host_ints(pages, cache["k"].device, torch.int64)
    return {name: cache[name].index_select(ax, idx) for name in ("k", "v")}


def scatter_pool_pages(cache: Dict[str, Any], pages, data) -> Dict[str, Any]:
    """Write :func:`gather_pool_pages` data (tensors, or host numpy arrays)
    back into pool pages ``pages``, in place (the swap-in restore).
    Duplicate indices carry the same rows, as the scheduler pads them."""
    ax = _pages_axis(cache)
    dev = cache["k"].device
    idx = host_ints(pages, dev, torch.int64)
    for name in ("k", "v"):
        src = data[name]
        src = src.to(dev) if isinstance(src, torch.Tensor) else host_tensor(src, dev)
        cache[name].index_copy_(ax, idx, src.to(cache[name].dtype))
    return cache


def _quantized_rows(cache: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor):
    """New K/V rows in the cache's storage: int8 codes on its grid, or f32."""
    if cache["k"].dtype == torch.int8:
        return (qformat.quantize(k_new, cache["k_n"], 8),
                qformat.quantize(v_new, cache["v_n"], 8))
    return k_new.to(cache["k"].dtype), v_new.to(cache["v"].dtype)


def update_kv_cache(cache: Dict[str, Any], k_new: torch.Tensor,
                    v_new: torch.Tensor) -> Dict[str, Any]:
    """Write (B, S_new, Hkv, D) at row ``cache['len']`` (in place) and return
    the cache with ``len`` advanced.

    A (B,) ``len`` writes each slot at its own offset.  As in the reference,
    a write that would run past ``max_len`` starts early enough to fit (a
    single row clamps to row S-1): only free slots, whose ``len`` keeps
    ticking under the scheduler's decode mask, ever get there.  A paged
    cache takes one row per slot through its table; a slot whose row maps
    to an unmapped page or past the table (an evicted slot still ticking)
    writes the pool's spare row, never another slot's page.
    """
    idx = cache["len"]
    k_new, v_new = _quantized_rows(cache, k_new, v_new)
    b, s_new, s_max = k_new.shape[0], k_new.shape[1], cache["k"].shape[1]
    if is_paged_cache(cache):
        if s_new != 1:
            raise NotImplementedError("multi-token insert into a paged cache: admission goes "
                                      "through the chunked path (append_kv_chunk)")
        table = cache["page_table"]
        n_pool, ps, mp = cache["k"].shape[0], cache["k"].shape[1], table.shape[1]
        lp = (idx // ps).to(torch.int64)
        page = table.gather(1, torch.clamp(lp, max=mp - 1)[:, None])[:, 0]
        flat = torch.where((lp < mp) & (page >= 0), page * ps + idx % ps,
                           n_pool * ps).to(torch.int64)
        _pool_rows(cache["k"])[flat] = k_new[:, 0]
        _pool_rows(cache["v"])[flat] = v_new[:, 0]
        return dict(cache, len=idx + 1)
    if isinstance(idx, int):
        start = min(max(idx, 0), s_max - s_new)
        cache["k"][:, start:start + s_new] = k_new
        cache["v"][:, start:start + s_new] = v_new
    else:
        start = torch.clamp(idx, 0, s_max - s_new).to(torch.int64)
        rows = start[:, None] + torch.arange(s_new, device=start.device)
        slots = torch.arange(b, device=start.device)[:, None]
        cache["k"][slots, rows] = k_new
        cache["v"][slots, rows] = v_new
    return dict(cache, len=idx + s_new)


def reset_kv_slot(cache: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Free one slot of a per-slot cache: ``len[slot] = 0``.

    The stale K/V rows stay: every consumer masks positions ``>= len`` and
    the next admission overwrites them, so eviction is O(1).  A paged cache
    also unmaps the slot's table row (all -1): its pool pages go back to the
    host-side allocator, and the slot's later decode writes are dropped.
    """
    out = dict(cache, len=set_kv_slot_len(cache["len"], slot, 0))
    if is_paged_cache(cache):
        table = cache["page_table"].clone()
        table[slot].fill_(-1)
        out["page_table"] = table
    return out


def set_kv_slot_len(ln: torch.Tensor, slot: int, new_len: int) -> torch.Tensor:
    """A copy of the (B,) length vector with ``len[slot] = new_len``.

    ``fill_`` takes the value as a kernel argument; ``out[slot] = new_len``
    would stage it in host memory and synchronize with the device.
    """
    out = ln.clone()
    out[slot:slot + 1].fill_(new_len)
    return out


def write_kv_slot(big: Dict[str, Any], small: Dict[str, Any], slot: int,
                  length: int) -> Dict[str, Any]:
    """Copy a batch-1 prefilled cache ``small`` into slot ``slot`` of the
    per-slot cache ``big`` (in place) and set ``len[slot] = length``.

    Rows of ``small`` past ``length`` may hold prompt-bucket padding; the
    length masks them until decode overwrites them.  Stacked caches carry
    the leading layer axis in both.
    """
    b_axis = big["k"].ndim - 4
    for name in ("k", "v"):
        big[name].select(b_axis, slot).copy_(small[name].select(b_axis, 0))
    return dict(big, len=set_kv_slot_len(big["len"], slot, length))


@dataclasses.dataclass(frozen=True)
class KVChunk:
    """Chunked-prefill target: one prompt chunk headed for rows
    [start, start+C) of batch slot ``slot`` of a per-slot cache.

    ``length`` is the number of valid (non-pad) tokens in the chunk: C for
    every chunk but the last, which may be partial.  All three are Python
    ints, known to the scheduler, so the layers read nothing back.

    Under a data split every data rank runs the chunk (each takes part in
    the forward's collectives), but one holds the slot: ``slot`` is its
    local index there and None on the others, whose attention writes and
    reads no cache row and outputs zeros (their activations are never
    kept: the weight-stationary MoE takes the owner's, ``Context.rows``).
    """

    slot: Optional[int]
    start: int
    length: int


@dataclasses.dataclass(frozen=True)
class RaggedBatch:
    """Per-token addressing of a ragged tick's (1, T) token batch: every live
    slot's decode token and the prompt-chunk tokens of several admission
    lanes.  Token t is logical row ``positions[t]`` of batch slot
    ``slots[t]`` ((T,) int32 tensors on the cache's device); position -1
    marks an inert pad row, which writes nothing, leaves ``len`` as it is and
    outputs a row that no caller samples."""

    slots: torch.Tensor
    positions: torch.Tensor


def _ragged_flat_rows(table: torch.Tensor, slots: torch.Tensor, pos: torch.Tensor,
                      ps: int, n_pool: int) -> torch.Tensor:
    """:func:`paged_flat_index` over a ragged batch: token t's pool row
    ``table[slots[t], pos[t] // ps] * ps + pos[t] % ps`` (int64); inert rows,
    positions past the table and unmapped entries map to the sentinel
    ``n_pool * ps``."""
    mp = table.shape[1]
    pos = pos.to(torch.int64)
    lp = torch.clamp(pos, min=0) // ps
    page = table[slots.to(torch.int64), torch.clamp(lp, max=mp - 1)].to(torch.int64)
    valid = (pos >= 0) & (lp < mp) & (page >= 0)
    return torch.where(valid, page * ps + torch.clamp(pos, min=0) % ps, n_pool * ps)


def ragged_len(ln: torch.Tensor, ragged: RaggedBatch) -> torch.Tensor:
    """A copy of the (B,) lengths with ``len[slot] = max(len[slot],
    positions + 1)`` over each slot's tokens; pad rows (slot 0, position -1)
    leave it as it is."""
    return ln.clone().scatter_reduce_(0, ragged.slots.to(torch.int64),
                                      (ragged.positions + 1).to(ln.dtype), "amax")


def _scatter_kv_ragged(cache: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor,
                       ragged: RaggedBatch) -> None:
    """Write a (1, T, Hkv, D) ragged batch's rows in place (int8 caches
    quantize on write); inert rows and rows past the slab or the table are
    dropped."""
    k_new, v_new = _quantized_rows(cache, k_new, v_new)
    pos = ragged.positions
    if is_paged_cache(cache):
        n_pool, ps = cache["k"].shape[0], cache["k"].shape[1]
        flat = _ragged_flat_rows(cache["page_table"], ragged.slots, pos, ps, n_pool)
        _pool_rows(cache["k"])[flat] = k_new[0]
        _pool_rows(cache["v"])[flat] = v_new[0]
        return
    b, s, hkv, d = cache["k"].shape
    flat = torch.where((pos >= 0) & (pos < s),
                       ragged.slots.to(torch.int64) * s + torch.clamp(pos, min=0), b * s)
    # a dense slab has no spare row: scatter into a copy with one
    for name, x in (("k", k_new), ("v", v_new)):
        ext = torch.cat([cache[name].reshape(b * s, hkv, d), x.new_zeros(1, hkv, d)])
        ext[flat.to(torch.int64)] = x[0]
        cache[name].copy_(ext[:b * s].view(cache[name].shape))


def append_kv_ragged(cache: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor,
                     ragged: RaggedBatch) -> Dict[str, Any]:
    """Scatter a (1, T, Hkv, D) ragged batch into a per-slot cache (in
    place) and raise each slot's ``len`` to cover its tokens
    (:func:`ragged_len`).

    Token t's K/V row lands at logical row ``positions[t]`` of slot
    ``slots[t]``, through the table for a paged cache; int8 caches quantize
    on write.  The plain sibling of the write inside ``ops.qragged_attn``.
    """
    _scatter_kv_ragged(cache, k_new, v_new, ragged)
    return dict(cache, len=ragged_len(cache["len"], ragged))


def ragged_attention(q: torch.Tensor, cache: Dict[str, Any],
                     ragged: RaggedBatch) -> torch.Tensor:
    """Ragged queries (1, T, Hq, D) over a per-slot cache whose rows already
    hold the batch (:func:`append_kv_ragged`): token t attends the mapped
    positions ``<= positions[t]`` of slot ``slots[t]``, densified per token
    (through the table for a paged cache).  int8 caches are dequantized on
    their pow2 grid.  A row that sees nothing (inert) gives exact zeros.
    """
    _, t, hq, d = q.shape
    hkv = cache["k"].shape[2]
    g = hq // hkv
    slots = ragged.slots.to(torch.int64)
    pos = ragged.positions.to(torch.int64)
    if is_paged_cache(cache):
        table = cache["page_table"][slots]                       # (T, max_pages)
        mp, ps = table.shape[1], cache["k"].shape[1]
        idx = torch.clamp(table, min=0).to(torch.int64)
        sh = (t, mp * ps) + tuple(cache["k"].shape[2:])
        kt, vt = cache["k"][idx].reshape(sh), cache["v"][idx].reshape(sh)
        mapped = torch.repeat_interleave(table >= 0, ps, dim=1)
    else:
        kt, vt = cache["k"][slots], cache["v"][slots]           # (T, S, Hkv, D)
        mapped = torch.ones(kt.shape[:2], dtype=torch.bool, device=q.device)
    if kt.dtype == torch.int8:
        kt = qformat.dequantize(kt, cache["k_n"])
        vt = qformat.dequantize(vt, cache["v_n"])
    else:
        kt, vt = kt.to(torch.float32), vt.to(torch.float32)
    s = kt.shape[1]
    qg = q[0].reshape(t, hkv, g, d).to(torch.float32) / math.sqrt(d)
    scores = torch.einsum("thgd,tshd->thgs", qg, kt)
    vis = (torch.arange(s, device=q.device)[None, :] <= pos[:, None]) & mapped
    p = torch.softmax(torch.where(vis[:, None, None, :], scores,
                                  torch.full_like(scores, NEG_INF)), dim=-1)
    p = torch.where(vis.any(dim=-1)[:, None, None, None], p, torch.zeros_like(p))
    out = torch.einsum("thgs,tshd->thgd", p, vt)
    return out.reshape(1, t, hq, d).to(q.dtype)


_IDENTITY_TABLES: Dict[Tuple[int, str], torch.Tensor] = {}


def identity_table(batch: int, device) -> torch.Tensor:
    """The (B, 1) int32 table ``arange(B)[:, None]`` under which a dense
    (B, S, Hkv, D) slab is a pool of B pages of S rows; made once per
    (B, device) and shared, so a ragged layer launches nothing for it."""
    key = (batch, str(torch.device(device)))
    if key not in _IDENTITY_TABLES:
        _IDENTITY_TABLES[key] = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    return _IDENTITY_TABLES[key]


def append_kv_chunk(cache: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor,
                    chunk: KVChunk) -> Dict[str, Any]:
    """Write a (1, C, Hkv, D) chunk in place into rows [start, start+C) of
    ``chunk.slot`` and set ``len[slot] = start + length``.

    The plain sibling of the write inside ``ops.qchunk_attn`` (int8 caches
    quantize on write).  The length is set absolutely, so the junk rows the
    decode half appended for this still-prefilling slot are overwritten.
    A dense chunk that does not fit raises, where the reference would shift
    it.  A paged chunk goes through the slot's table row; rows on unmapped
    entries or past the table (the padded tail of a last chunk) are dropped.
    The scheduler makes sure no row goes through a shared page.
    """
    k_new, v_new = _quantized_rows(cache, k_new, v_new)
    c, slot, start = k_new.shape[1], chunk.slot, chunk.start
    if is_paged_cache(cache):
        n_pool, ps = cache["k"].shape[0], cache["k"].shape[1]
        flat = paged_flat_index(cache["page_table"][slot],
                                start + torch.arange(c, device=k_new.device), ps, n_pool)
        _pool_rows(cache["k"])[flat] = k_new[0]
        _pool_rows(cache["v"])[flat] = v_new[0]
    else:
        check_chunk_target(c, cache["k"].shape[0], cache["k"].shape[1], slot, start,
                           "append_kv_chunk")
        cache["k"][slot, start:start + c] = k_new[0]
        cache["v"][slot, start:start + c] = v_new[0]
    return dict(cache, len=set_kv_slot_len(cache["len"], slot, start + chunk.length))


def chunk_attention(q: torch.Tensor, cache: Dict[str, Any], slot: int,
                    start: int) -> torch.Tensor:
    """Chunk queries (1, C, Hq, D) over slot ``slot`` of a float per-slot
    cache whose rows [start, start+C) already hold the chunk
    (``append_kv_chunk``): query c attends positions <= start + c.

    Only rows before ``start + C`` are read, as the reference's blocked loop
    visits them; a paged cache is densified through the slot's table row
    first.  int8 caches go through ``ops.qchunk_attn`` / ``ops.
    qpaged_chunk_attn`` instead.
    """
    if cache["k"].dtype == torch.int8:
        raise ValueError("chunk_attention takes float caches; int8 caches go "
                         "through kernels.ops.qchunk_attn or qpaged_chunk_attn")
    _, c, hq, d = q.shape
    kc, vc = gather_kv_pages(cache, slot) if is_paged_cache(cache) \
        else (cache["k"][slot], cache["v"][slot])
    end = min(start + c, kc.shape[0])
    k = kc[:end].to(torch.float32)
    v = vc[:end].to(torch.float32)
    hkv = k.shape[1]
    qg = q[0].reshape(c, hkv, hq // hkv, d).to(torch.float32) * (1.0 / math.sqrt(d))
    scores = torch.einsum("chgd,shd->hgcs", qg, k)
    visible = (torch.arange(end, device=q.device)[None, :]
               <= start + torch.arange(c, device=q.device)[:, None])
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    out = torch.einsum("hgcs,shd->chgd", p, v) \
        / torch.clamp(torch.sum(p, dim=-1), min=1e-30).permute(2, 0, 1)[..., None]
    return out.reshape(1, c, hq, d).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class Attention:
    """Multi-head attention: GQA and RoPE, with the dense and paged serving cache paths."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    use_qkv_bias: bool = False
    use_out_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    name: str = "attn"

    def _projs(self):
        q_dim, kv_dim = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        return {
            "wq": Dense(self.d_model, q_dim, self.use_qkv_bias, name="wq"),
            "wk": Dense(self.d_model, kv_dim, self.use_qkv_bias, name="wk"),
            "wv": Dense(self.d_model, kv_dim, self.use_qkv_bias, name="wv"),
            "wo": Dense(q_dim, self.d_model, self.use_out_bias, name="wo"),
        }

    def init(self, gen: torch.Generator, device) -> Params:
        return {nm: layer.init(gen, device) for nm, layer in self._projs().items()}

    def project_kv(self, params: Params, kv_in: torch.Tensor, ctx: Context,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``kv_in`` (B, S, d_model) projected to K and V (B, S, Hkv, D) as
        ``apply`` projects them: what ``EncDecLM.write_cross_kv`` writes into
        a slot's cross-attention cache once per admission."""
        return self._kv(params, kv_in, ctx.scope(self.name))

    def _kv(self, params: Params, kv_in: torch.Tensor, ctx: Context):
        projs = self._projs()
        b, skv, _ = kv_in.shape
        k = projs["wk"].apply(params["wk"], kv_in, ctx)
        v = projs["wv"].apply(params["wv"], kv_in, ctx)
        return (k.reshape(b, skv, self.n_kv_heads, self.head_dim),
                v.reshape(b, skv, self.n_kv_heads, self.head_dim))

    def _cross(self, params: Params, x: torch.Tensor, ctx: Context, *,
               kv_source: Optional[torch.Tensor], cross_cache: Optional[Dict[str, Any]],
               chunk: Optional[KVChunk]) -> torch.Tensor:
        """Cross-attention of ``x`` (B, S, d_model), non-causal and without
        RoPE: over ``kv_source`` (B, S_enc, d_model) projected here, or over
        the cached rows of ``cross_cache``.  A chunk reads its slot's rows up
        to that slot's ``xlen``; otherwise every row is one slot's single
        token (decode, or a ragged tick's tokens as a batch) over its own
        slot's rows, masked per row by ``xlen``.  ``xlen`` stays on the
        device: the mask reads it there."""
        projs = self._projs()
        b, s, _ = x.shape
        q = projs["wq"].apply(params["wq"], x, ctx).reshape(b, s, self.n_heads, self.head_dim)
        if cross_cache is None:
            k, v = self._kv(params, kv_source, ctx)
            out = flash_attention(q, k, v, 0, k.shape[1], False)
        elif chunk is not None:
            sl = chunk.slot
            out = flash_attention(q, cross_cache["xk"][sl:sl + 1], cross_cache["xv"][sl:sl + 1],
                                  0, cross_cache["xlen"][sl], False)
        else:
            if s != 1:
                raise NotImplementedError("cached cross-attention expects single-token rows "
                                          "(decode / tokens-as-batch) or a chunk")
            out = decode_attention(q, cross_cache["xk"], cross_cache["xv"], cross_cache["xlen"])
        return projs["wo"].apply(params["wo"], out.reshape(b, s, self.n_heads * self.head_dim),
                                 ctx)

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              kv_source: Optional[torch.Tensor] = None,
              cross_cache: Optional[Dict[str, Any]] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """Attend over ``x`` (B, S, d_model).

        ``kv_source`` or ``cross_cache`` makes it cross-attention
        (:meth:`_cross`), which returns no cache.

        With ``cache``: ``ragged`` runs a ragged tick's (1, T) batch, each
        token writing its own row of its own slot and attending that slot
        (``len`` is left as it was: the stack raises it once per tick);
        ``chunk`` writes one prompt chunk (B = 1) into its slot of a per-slot
        cache and attends over that slot; one token with ``decode`` runs the
        decode step (each slot at its own ``len`` for a per-slot cache);
        otherwise the prompt is written into a lockstep cache and attends
        over it, causal from the length before the write.
        """
        ctx = ctx.scope(self.name)
        if kv_source is not None or cross_cache is not None:
            return self._cross(params, x, ctx, kv_source=kv_source, cross_cache=cross_cache,
                               chunk=chunk), None
        projs = self._projs()
        b, s, _ = x.shape
        q = projs["wq"].apply(params["wq"], x, ctx).reshape(b, s, self.n_heads, self.head_dim)
        k = projs["wk"].apply(params["wk"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = projs["wv"].apply(params["wv"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        per_slot = cache is not None and isinstance(cache["len"], torch.Tensor)
        if ragged is not None:          # per-token rows; pad rows rope at 0
            positions = torch.clamp(ragged.positions, min=0)[None, :]
        elif chunk is not None:
            positions = chunk.start + torch.arange(s, device=x.device)
        elif cache is not None and decode and per_slot:
            positions = cache["len"][:, None] + torch.arange(s, device=x.device)[None, :]
        else:
            start = cache["len"] if cache is not None and decode else 0
            positions = torch.arange(start, start + s, device=x.device)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)

        new_cache = None
        if cache is None:
            out = flash_attention(q, k, v, 0, s, self.causal)
        elif ragged is not None:
            if not per_slot or b != 1:
                raise NotImplementedError("the ragged tick runs one (1, T) batch over a "
                                          "per-slot cache (init_cache(per_slot_len=True))")
            if cache["k"].dtype == torch.int8:
                from repro_torch.kernels import ops

                if is_paged_cache(cache):
                    table = cache["page_table"]
                else:
                    table = identity_table(cache["k"].shape[0], cache["k"].device)
                out = ops.qragged_attn(q[0], k[0], v[0], cache["k"], cache["v"],
                                       cache["k_n"], cache["v_n"], table, ragged.slots,
                                       ragged.positions)[None]
            else:
                _scatter_kv_ragged(cache, k, v, ragged)
                out = ragged_attention(q, cache, ragged)
            new_cache = dict(cache)
        elif chunk is not None:
            if not per_slot or b != 1:
                raise NotImplementedError("chunked prefill targets one slot of a per-slot "
                                          "cache (init_cache(per_slot_len=True))")
            if chunk.slot is None:      # another data rank holds the slot
                out, new_cache = torch.zeros_like(q), dict(cache)
            elif cache["k"].dtype == torch.int8:
                from repro_torch.kernels import ops

                if is_paged_cache(cache):
                    out = ops.qpaged_chunk_attn(q[0], k[0], v[0], cache["k"], cache["v"],
                                                cache["k_n"], cache["v_n"],
                                                cache["page_table"][chunk.slot],
                                                chunk.start)[None]
                else:
                    out = ops.qchunk_attn(q[0], k[0], v[0], cache["k"], cache["v"],
                                          cache["k_n"], cache["v_n"], chunk.slot,
                                          chunk.start)[None]
                new_cache = dict(cache, len=set_kv_slot_len(cache["len"], chunk.slot,
                                                            chunk.start + chunk.length))
            else:
                new_cache = append_kv_chunk(cache, k, v, chunk)
                out = chunk_attention(q, new_cache, chunk.slot, chunk.start)
        elif decode and s == 1:
            new_cache = update_kv_cache(cache, k, v)
            if is_paged_cache(cache):
                out = paged_decode_attention(q, new_cache, ctx.page_zero)
            else:
                out = decode_attention(q, new_cache["k"], new_cache["v"], new_cache["len"],
                                       k_n=new_cache.get("k_n"), v_n=new_cache.get("v_n"))
        elif per_slot:
            raise NotImplementedError("multi-token prefill into a per-slot cache: use the "
                                      "chunked path (chunk=KVChunk(...)) or a batch-1 "
                                      "prefill + write_kv_slot")
        else:
            new_cache = update_kv_cache(cache, k, v)
            live = new_cache["len"]
            kf, vf = new_cache["k"][:, :live], new_cache["v"][:, :live]
            if kf.dtype == torch.int8:
                kf = qformat.dequantize(kf, new_cache["k_n"])
                vf = qformat.dequantize(vf, new_cache["v_n"])
            out = flash_attention(q, kf, vf, cache["len"], live, self.causal)
        y = projs["wo"].apply(params["wo"], out.reshape(b, s, self.n_heads * self.head_dim), ctx)
        return y, new_cache
