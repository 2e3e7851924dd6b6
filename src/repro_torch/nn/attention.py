"""Grouped-query attention with RoPE over a dense (optionally int8) KV cache
(``repro/nn/attention.py``, the lockstep serving paths).

Cache contract, one dict per layer (stacked layers add a leading layer axis
to ``k``/``v``): ``{"k", "v": (B, S, Hkv, D), "len": int}`` plus, for an
int8 cache on the paper's Qm.n grid, the exponents ``"k_n"``/``"v_n"``
(ints).  Unlike the reference, :func:`update_kv_cache` writes the new rows
in place: the returned dict shares the cache's tensors.  Per-slot (B,)
lengths, paged pools, chunked and ragged prefill belong to later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import qformat
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
                  layers: Optional[int] = None) -> Dict[str, Any]:
    """A zeroed dense cache; ``layers`` adds a leading stacked-layer axis.

    ``cache_n`` is the frozen fractional-bit exponent of the int8 grid
    (Q4.3: range +-16, resolution 1/8).
    """
    shape = ((layers,) if layers else ()) + (batch, max_len, n_kv_heads, head_dim)
    dtype = torch.int8 if quantized else torch.float32
    cache: Dict[str, Any] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                             "v": torch.zeros(shape, dtype=dtype, device=device),
                             "len": 0}
    if quantized:
        cache["k_n"] = cache_n
        cache["v_n"] = cache_n
    return cache


def update_kv_cache(cache: Dict[str, Any], k_new: torch.Tensor,
                    v_new: torch.Tensor) -> Dict[str, Any]:
    """Write (B, S_new, Hkv, D) at row ``cache['len']`` (in place) and return
    the cache with ``len`` advanced.  As in the reference, a write that would
    run past the end starts early enough to fit."""
    idx = cache["len"]
    if not isinstance(idx, int):
        raise NotImplementedError("per-slot cache lengths arrive with the "
                                  "continuous-batching slice of the port")
    if cache["k"].dtype == torch.int8:
        k_new = qformat.quantize(k_new, cache["k_n"], 8)
        v_new = qformat.quantize(v_new, cache["v_n"], 8)
    s_new, s_max = k_new.shape[1], cache["k"].shape[1]
    start = min(max(idx, 0), s_max - s_new)
    cache["k"][:, start:start + s_new] = k_new
    cache["v"][:, start:start + s_new] = v_new
    return dict(cache, len=idx + s_new)


@dataclasses.dataclass(frozen=True)
class Attention:
    """Multi-head attention: GQA and RoPE, with the lockstep cache paths."""

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
              decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """Attend over ``x`` (B, S, d_model).

        With ``cache``: one token and ``decode`` runs the decode step;
        otherwise the prompt is written into the cache and attends over the
        dequantized cache, causal from the length before the write.
        """
        ctx = ctx.scope(self.name)
        projs = self._projs()
        b, s, _ = x.shape
        q = projs["wq"].apply(params["wq"], x, ctx).reshape(b, s, self.n_heads, self.head_dim)
        k = projs["wk"].apply(params["wk"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = projs["wv"].apply(params["wv"], x, ctx).reshape(b, s, self.n_kv_heads, self.head_dim)
        start = cache["len"] if cache is not None and decode else 0
        positions = torch.arange(start, start + s, device=x.device)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)

        new_cache = None
        if cache is None:
            out = flash_attention(q, k, v, 0, s, self.causal)
        elif decode and s == 1:
            new_cache = update_kv_cache(cache, k, v)
            out = decode_attention(q, new_cache["k"], new_cache["v"], new_cache["len"],
                                   k_n=new_cache.get("k_n"), v_n=new_cache.get("v_n"))
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
