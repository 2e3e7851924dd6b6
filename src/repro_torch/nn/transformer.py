"""Transformer block and layer stack (``repro/nn/transformer.py``).

The slice's :class:`Block` is the pre-norm "a" layout: RMSNorm -> attention
-> residual, RMSNorm -> gated FFN -> residual.  :class:`Stack` keeps the
reference's stacked parameter layout (one leading layer axis per body
position when ``n_periods > 1``) and loops over the layer axis where the
reference runs ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.nn.attention import (Attention, KVChunk, RaggedBatch, init_kv_cache,
                                      init_paged_kv_cache, ragged_len)
from repro_torch.nn.layers import RMSNorm
from repro_torch.nn.mlp import GatedMLP
from repro_torch.nn.module import Context, Params, tree_unstack


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual layer: norm + attention + norm + gated FFN."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    activation: str = "silu"
    name: str = "block"

    def _mixer(self) -> Attention:
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         use_qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                         use_rope=self.use_rope, causal=self.causal, name="attn")

    def _ffn(self) -> GatedMLP:
        return GatedMLP(self.d_model, self.d_ff, activation=self.activation, name="ffn")

    def init(self, gen: torch.Generator, device) -> Params:
        return {"norm1": RMSNorm(self.d_model, name="norm1").init(gen, device),
                "mixer": self._mixer().init(gen, device),
                "norm2": RMSNorm(self.d_model, name="norm2").init(gen, device),
                "ffn": self._ffn().init(gen, device)}

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool, device,
                   layers: Optional[int] = None, per_slot_len: bool = False,
                   page_size: Optional[int] = None,
                   num_pages: Optional[int] = None) -> Dict[str, Any]:
        """A dense KV slab, or with ``page_size`` a paged pool of
        ``num_pages`` pages (default: dense parity, batch * max_pages)."""
        if page_size is None:
            return {"kv": init_kv_cache(batch, max_len, self.n_kv_heads, self.head_dim,
                                        quantized=quantized_kv, device=device, layers=layers,
                                        per_slot_len=per_slot_len)}
        if not per_slot_len:
            raise ValueError("paged KV caches are per-slot by construction: pass "
                             "per_slot_len=True alongside page_size/num_pages")
        max_pages = -(-max_len // page_size)
        return {"kv": init_paged_kv_cache(
            batch, max_pages, page_size, num_pages if num_pages is not None else batch * max_pages,
            self.n_kv_heads, self.head_dim, quantized=quantized_kv, device=device,
            layers=layers)}

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """The block's mixer is attention, so it takes ``ragged`` as it
        comes; the reference's recurrent mixers, which refuse it, wait for
        the port's other-architectures slice."""
        ctx = ctx.scope(self.name)
        h = RMSNorm(self.d_model, name="norm1").apply(params["norm1"], x, ctx)
        mix, kv = self._mixer().apply(params["mixer"], h, ctx,
                                      cache=None if cache is None else cache["kv"],
                                      decode=decode, chunk=chunk, ragged=ragged)
        x = x + mix
        h2 = RMSNorm(self.d_model, name="norm2").apply(params["norm2"], x, ctx)
        x = x + self._ffn().apply(params["ffn"], h2, ctx)
        return x, (None if kv is None else {"kv": kv})


@dataclasses.dataclass(frozen=True)
class Stack:
    """``body`` (a period of blocks) repeated ``n_periods`` times."""

    body: Tuple[Block, ...]
    n_periods: int
    name: str = "stack"

    @property
    def n_layers(self) -> int:
        return len(self.body) * self.n_periods

    @property
    def stacked(self) -> bool:
        """Whether params and caches carry a leading layer axis."""
        return self.n_periods > 1

    def init(self, gen: torch.Generator, device) -> Params:
        if not self.stacked:
            return {"body": [blk.init(gen, device) for blk in self.body]}
        body = []
        for blk in self.body:
            layers = [blk.init(gen, device) for _ in range(self.n_periods)]
            body.append(_stack_trees(layers))
        return {"body": body}

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool,
                   device, per_slot_len: bool = False, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None) -> Dict[str, Any]:
        layers = self.n_periods if self.stacked else None
        return {"body": [blk.init_cache(batch, max_len, quantized_kv=quantized_kv,
                                        device=device, layers=layers,
                                        per_slot_len=per_slot_len, page_size=page_size,
                                        num_pages=num_pages)
                         for blk in self.body]}

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        ctx = ctx.scope(self.name)
        lens = {}
        body = params["body"]
        if self.stacked:
            body = [tree_unstack(p, self.n_periods) for p in body]
        for period in range(self.n_periods):
            for pos, blk in enumerate(self.body):
                p, c = body[pos], None if cache is None else cache["body"][pos]
                if self.stacked:
                    p = p[period]
                    if c is not None:
                        c = {"kv": dict(c["kv"], k=c["kv"]["k"][period],
                                        v=c["kv"]["v"][period])}
                bctx = ctx.scope(f"p{pos}" if self.stacked else f"l{pos}")
                x, nc = blk.apply(p, x, bctx, cache=c, decode=decode, chunk=chunk,
                                  ragged=ragged)
                if nc is not None:
                    lens[pos] = nc["kv"]["len"]
        if cache is None:
            return x, None
        if ragged is not None:
            # the ragged layers leave ``len`` alone; it rises once per tick
            lens = {pos: ragged_len(ln, ragged) for pos, ln in lens.items()}
        # every layer wrote its k/v rows in place; only the length advances
        # (each layer of a period got the same ``len`` and computed the same
        # new one).  A paged cache's per-layer pools are views of the
        # stacked (L, P, ps, Hkv, D) pools; its one table serves every layer.
        return x, {"body": [{"kv": dict(c["kv"], len=lens[pos])}
                            for pos, c in enumerate(cache["body"])]}


def _stack_trees(trees):
    """Stack a list of identically-shaped param trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
