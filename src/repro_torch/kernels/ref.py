"""Plain PyTorch versions of the ported kernels (``repro/kernels/ref.py``).

Each is the straightforward tensor expression of what its CUDA kernel
computes.  The wrappers run them for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels to them on the card.
"""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.core import qformat

NEG_INF = -1e30


def wq_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale) -> torch.Tensor:
    """float32 x (M, K) @ (int8 wq (K, N) * scale), scale () or (N,)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=wq.device)
    if s.numel() not in (1, wq.shape[1]):
        raise ValueError(f"wq_matmul: scale has {s.numel()} entries for N={wq.shape[1]}")
    w = wq.to(torch.float32) * s.reshape(-1).expand(wq.shape[1])
    return torch.matmul(x.to(torch.float32), w)


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
