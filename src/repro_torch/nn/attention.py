"""Grouped-query attention with RoPE over a dense (optionally int8) KV cache
(``repro/nn/attention.py``: the lockstep and per-slot serving paths).

Cache contract, one dict per layer (stacked layers add a leading layer axis
to ``k``/``v``): ``{"k", "v": (B, S, Hkv, D), "len"}`` plus, for an int8
cache on the paper's Qm.n grid, the exponents ``"k_n"``/``"v_n"`` (ints).
``len`` is an int (lockstep) or, for the continuous-batching scheduler, a
(B,) int32 tensor on the cache's device (``per_slot_len``): every slot
writes, masks and ropes at its own offset.  One (B,) ``len`` serves every
layer of a stack, where the reference keeps an equal copy per layer.

Unlike the reference, the cache functions write K/V rows in place: the
returned dict shares the cache's ``k``/``v`` tensors, and only ``len`` is
replaced by a new value.  Paged pools and the ragged tick belong to later
slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import qformat
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                    kv_len: int, causal: bool) -> torch.Tensor:
    """Forward of the reference's ``flash_attention``, as plain masked
    softmax attention in float32 (its custom backward comes with training).

    q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D), Hq = G * Hkv.  Key j is visible
    to query i when j < kv_len and, if causal, j <= q_offset + i.  Keys at
    or past ``kv_len`` are dropped before the product: the reference masks
    them to exp(-1e30 - m) = 0, which adds nothing.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    k = k[:, :kv_len].to(torch.float32)
    v = v[:, :kv_len].to(torch.float32)
    qg = q.to(torch.float32).reshape(b, sq, hkv, g, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    if causal:
        kpos = torch.arange(k.shape[1], device=q.device)
        qpos = q_offset + torch.arange(sq, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v) / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


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
    ticking under the scheduler's decode mask, ever get there.
    """
    idx = cache["len"]
    k_new, v_new = _quantized_rows(cache, k_new, v_new)
    b, s_new, s_max = k_new.shape[0], k_new.shape[1], cache["k"].shape[1]
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
    the next admission overwrites them, so eviction is O(1).
    """
    return dict(cache, len=set_kv_slot_len(cache["len"], slot, 0))


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
    """

    slot: int
    start: int
    length: int


def append_kv_chunk(cache: Dict[str, Any], k_new: torch.Tensor, v_new: torch.Tensor,
                    chunk: KVChunk) -> Dict[str, Any]:
    """Write a (1, C, Hkv, D) chunk in place into rows [start, start+C) of
    ``chunk.slot`` and set ``len[slot] = start + length``.

    The plain sibling of the write inside ``ops.qchunk_attn`` (int8 caches
    quantize on write).  The length is set absolutely, so the junk rows the
    decode half appended for this still-prefilling slot are overwritten.
    A chunk that does not fit raises, where the reference would shift it.
    """
    k_new, v_new = _quantized_rows(cache, k_new, v_new)
    c, slot, start = k_new.shape[1], chunk.slot, chunk.start
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
    visits them.  int8 caches go through ``ops.qchunk_attn`` instead.
    """
    if cache["k"].dtype == torch.int8:
        raise ValueError("chunk_attention takes float caches; int8 caches go "
                         "through kernels.ops.qchunk_attn")
    _, c, hq, d = q.shape
    end = min(start + c, cache["k"].shape[1])
    k = cache["k"][slot, :end].to(torch.float32)
    v = cache["v"][slot, :end].to(torch.float32)
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
    """Multi-head attention: GQA and RoPE, with the dense serving cache paths."""

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

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """Attend over ``x`` (B, S, d_model).

        With ``cache``: ``chunk`` writes one prompt chunk (B = 1) into its
        slot of a per-slot cache and attends over that slot; one token with
        ``decode`` runs the decode step (each slot at its own ``len`` for a
        per-slot cache); otherwise the prompt is written into a lockstep
        cache and attends over it, causal from the length before the write.
        """
        ctx = ctx.scope(self.name)
        projs = self._projs()
        b, s, _ = x.shape
        q = projs["wq"].apply(params["wq"], x, ctx).reshape(b, s, self.n_heads, self.head_dim)
        k = projs["wk"].apply(params["wk"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = projs["wv"].apply(params["wv"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        per_slot = cache is not None and isinstance(cache["len"], torch.Tensor)
        if chunk is not None:
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
        elif chunk is not None:
            if not per_slot or b != 1:
                raise NotImplementedError("chunked prefill targets one slot of a per-slot "
                                          "cache (init_cache(per_slot_len=True))")
            if cache["k"].dtype == torch.int8:
                from repro_torch.kernels import ops

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
