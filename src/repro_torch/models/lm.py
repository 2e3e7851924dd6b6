"""Decoder-only ``CausalLM`` (``repro/models/lm.py``).

The vocabulary is padded (``vocab_padded``) as in the reference; serving
masks the padded tail before sampling, and the training loss keeps it out
of the normalizer.  The LM head is tied to the embedding, or with
``tie_embeddings=False`` an ``lm_head`` :class:`Dense` without bias (the
``wq_matmul`` / ``wq4_matmul`` kernels under weight-only quantization).
``embeds`` (the VLM's stub vision prefix, (B, S_vis, D)) is prepended to
the text tokens' embeddings; the loss scores the text positions only.
``EncDecLM`` waits for the EncDec part of the other-architectures slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.nn.attention import KVChunk, RaggedBatch
from repro_torch.nn.layers import Dense, Embedding, LayerNorm, RMSNorm
from repro_torch.nn.module import Context, Params
from repro_torch.nn.transformer import Stack


@dataclasses.dataclass(frozen=True)
class CausalLM:
    vocab: int                    # true vocabulary size
    vocab_padded: int
    d_model: int
    stack: Stack
    norm: str = "rms"             # rms | ln, the final norm's kind
    tie_embeddings: bool = True
    name: str = "lm"

    def _embed(self) -> Embedding:
        return Embedding(self.vocab_padded, self.d_model, name="embed")

    def _final_norm(self):
        # the params key is "final_norm" either way; the scope is the reference's
        if self.norm == "ln":
            return LayerNorm(self.d_model, name="final_ln")
        return RMSNorm(self.d_model, name="final_norm")

    def _lm_head(self) -> Dense:
        return Dense(self.d_model, self.vocab_padded, use_bias=False, name="lm_head")

    def init(self, gen: torch.Generator, device) -> Params:
        """Random parameters drawn from ``gen`` (a generator on ``device``)."""
        p: Params = {"embed": self._embed().init(gen, device),
                     "stack": self.stack.init(gen, device),
                     "final_norm": self._final_norm().init(gen, device)}
        if not self.tie_embeddings:
            p["lm_head"] = self._lm_head().init(gen, device)
        return p

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool = False,
                   device, per_slot_len: bool = False, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None) -> Dict[str, Any]:
        """Serving cache (serve.engine): per attention layer a dense KV slab,
        or paged with ``page_size``; per Mamba or RWKV-6 layer its zeroed
        recurrent state, which every path (prefill, decode, ``chunk``)
        passes through and returns new."""
        return self.stack.init_cache(batch, max_len, quantized_kv=quantized_kv, device=device,
                                     per_slot_len=per_slot_len, page_size=page_size,
                                     num_pages=num_pages)

    def apply(self, params: Params, tokens: Optional[torch.Tensor], ctx: Context, *,
              embeds: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              logit_pos: Optional[int] = None,
              logit_rows: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """Returns (logits (B, S, vocab_padded) f32, new_cache).

        ``embeds`` (B, S_vis, D): a vision prefix placed before the tokens'
        embeddings (logits then cover S_vis + S positions); with ``tokens``
        None the forward runs over ``embeds`` alone.

        ``chunk``: route this (1, C) forward as a chunked prefill into one
        slot of a per-slot cache (``serve.engine.make_mixed_step``).
        ``ragged``: route this (1, T) forward as one ragged tick over a
        per-slot cache (``serve.engine.make_ragged_step``).
        ``logit_pos``: logits at that one position only ((B, 1, V));
        ``logit_rows``: at those (R,) token rows only ((B, R, V)).  Both slice
        the hidden states before the LM head, which dominates a small-batch
        forward.
        """
        ctx = ctx.scope(self.name)
        if tokens is not None:
            x = self._embed().apply(params["embed"], tokens, ctx)
            if embeds is not None:      # VLM: vision prefix + text tokens
                x = torch.cat([embeds.to(x.dtype), x], dim=1)
        else:
            x = embeds.to(torch.float32)
        x, new_cache = self.stack.apply(params["stack"], x, ctx, cache=cache,
                                        decode=decode, chunk=chunk, ragged=ragged)
        if logit_rows is not None:
            x = x.index_select(1, logit_rows)
        if logit_pos is not None:
            pos = logit_pos % x.shape[1]
            x = x[:, pos:pos + 1]
        x = self._final_norm().apply(params["final_norm"], x, ctx)
        if self.tie_embeddings:
            logits = self._embed().attend(params["embed"], x, ctx)
        else:
            logits = self._lm_head().apply(params["lm_head"], x, ctx)
        return logits.to(torch.float32), new_cache

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], ctx: Context,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``batch["tokens"]`` against
        ``batch["labels"]`` (labels < 0 are masked), plus the sum of
        ``ctx.losses``; a ``batch["embeds"]`` vision prefix runs in front and
        its positions are not scored.  The padded-vocabulary tail sits at
        -1e9, so it never wins.  Returns (loss, {"nll", "aux", "accuracy"}),
        all device tensors.  One card needs no vocab-sharded indicator sum, so
        the gold logit is a ``gather``."""
        embeds = batch.get("embeds")
        logits, _ = self.apply(params, batch["tokens"], ctx, embeds=embeds)
        labels = batch["labels"]
        if embeds is not None and batch.get("tokens") is not None:
            logits = logits[:, -labels.shape[1]:]       # the text positions
        mask = (labels >= 0).to(torch.float32)
        labels_safe = torch.clamp(labels, min=0).to(torch.int64)
        pad = torch.arange(self.vocab_padded, device=logits.device) >= self.vocab
        logits = logits + pad.to(torch.float32) * -1e9
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
        denom = torch.clamp(torch.sum(mask), min=1.0)
        nll = torch.sum((lse - gold) * mask) / denom
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        for v in ctx.losses.values():
            aux = aux + v
        hit = (torch.argmax(logits, dim=-1) == labels_safe).to(torch.float32)
        acc = torch.sum(hit * mask) / denom
        return nll + aux, {"nll": nll, "aux": aux, "accuracy": acc}
