"""Decoder-only ``CausalLM`` and encoder-decoder ``EncDecLM``
(``repro/models/lm.py``).

The vocabulary is padded (``vocab_padded``) as in the reference; serving
masks the padded tail before sampling, and the training loss keeps it out
of the normalizer.  The LM head is tied to the embedding, or with
``tie_embeddings=False`` an ``lm_head`` :class:`Dense` without bias (the
``wq_matmul`` / ``wq4_matmul`` kernels under weight-only quantization).
``embeds`` (the VLM's stub vision prefix, (B, S_vis, D)) is prepended to
the text tokens' embeddings; the loss scores the text positions only.
``EncDecLM`` (whisper) encodes stub frame embeddings (B, S_enc, D) and
decodes with cross-attention to them, through the learned position table
of its decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn.attention import KVChunk, RaggedBatch
from repro_torch.nn.layers import Dense, Embedding, LayerNorm, RMSNorm
from repro_torch.nn.module import Context, Params, tree_layer
from repro_torch.nn.transformer import Stack


def _final_norm(norm: str, d_model: int):
    # the params key is the caller's; the scope name is the reference's
    if norm == "ln":
        return LayerNorm(d_model, name="final_ln")
    return RMSNorm(d_model, name="final_norm")


def _next_token_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                     ctx: Context) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy of ``logits`` (B, S, V_padded) against
    ``labels`` (labels < 0 masked), plus the sum of ``ctx.losses``; the
    padded-vocabulary tail sits at -1e9, so it never wins.  One card needs no
    vocab-sharded indicator sum, so the gold logit is a ``gather``."""
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp(labels, min=0).to(torch.int64)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
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
        return _final_norm(self.norm, self.d_model)

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
        its positions are not scored (:func:`_next_token_loss`).  Returns
        (loss, {"nll", "aux", "accuracy"}), all device tensors."""
        embeds = batch.get("embeds")
        logits, _ = self.apply(params, batch["tokens"], ctx, embeds=embeds)
        labels = batch["labels"]
        if embeds is not None and batch.get("tokens") is not None:
            logits = logits[:, -labels.shape[1]:]       # the text positions
        return _next_token_loss(logits, labels, self.vocab, ctx)


def sinusoid_positions(s: int, d_model: int, device) -> torch.Tensor:
    """Whisper's (S, D) sinusoidal encoder positions, ``[sin | cos]`` of
    ``pos / 10000^(2i / D)``.  The exponent is the reference's float32
    quotient of int32s; its power is taken in float64 and rounded once,
    which gives XLA's float32 ``jnp.power`` at every exponent of the
    configs (a float32 ``torch.pow`` misses one of whisper-tiny's 192 by an
    ulp, which frame 1499 grows to 3.8e-6 in the angle)."""
    expo = (2 * np.arange(d_model // 2, dtype=np.int32)).astype(np.float32) \
        / np.float32(d_model)
    div = np.power(10000.0, expo.astype(np.float64)).astype(np.float32)
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        / torch.from_numpy(div).to(device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


@dataclasses.dataclass(frozen=True)
class EncDecLM:
    """Encoder-decoder (whisper-style); the encoder's input is stub frame
    embeddings (B, S_enc, D).

    ``enc_len`` (the config's encoder length ceiling) sizes the per-slot
    cross-attention cache of serving (``init_cache(cross_attn_cache=True)``):
    each slot's encoder K/V rows are projected once (:meth:`write_cross_kv`)
    and read by every decode step.  Without it, or with
    ``cross_attn_cache=False``, every step re-projects ``enc``.
    """

    vocab: int
    vocab_padded: int
    d_model: int
    encoder: Stack
    decoder: Stack
    max_target_len: int = 448
    norm: str = "ln"
    enc_len: Optional[int] = None
    name: str = "encdec"

    def _embed(self) -> Embedding:
        return Embedding(self.vocab_padded, self.d_model, name="embed")

    def init(self, gen: torch.Generator, device) -> Params:
        """Random parameters drawn from ``gen`` (a generator on ``device``);
        the learned decoder positions are N(0, 0.02^2), as in the reference."""
        return {
            "embed": self._embed().init(gen, device),
            "pos_embed": {"table": 0.02 * torch.randn(
                (self.max_target_len, self.d_model), generator=gen, device=device)},
            "encoder": self.encoder.init(gen, device),
            "enc_norm": _final_norm(self.norm, self.d_model).init(gen, device),
            "decoder": self.decoder.init(gen, device),
            "final_norm": _final_norm(self.norm, self.d_model).init(gen, device),
        }

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool = False,
                   device, per_slot_len: bool = False, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None,
                   cross_attn_cache: bool = True) -> Dict[str, Any]:
        """The decoder's serving cache; a per-slot cache also gets an
        ``"xkv"`` cross-attention node of ``enc_len`` rows a slot in every
        cross block, unless ``cross_attn_cache=False``."""
        enc_len = self.enc_len if (cross_attn_cache and per_slot_len) else None
        return self.decoder.init_cache(batch, max_len, quantized_kv=quantized_kv,
                                       device=device, per_slot_len=per_slot_len,
                                       page_size=page_size, num_pages=num_pages,
                                       enc_len=enc_len)

    def encode(self, params: Params, embeds: torch.Tensor, ctx: Context) -> torch.Tensor:
        """Frame embeddings (B, S_enc, D) plus :func:`sinusoid_positions`
        through the non-causal encoder and its final norm."""
        ctx = ctx.scope(self.name)
        x = embeds.to(torch.float32) + sinusoid_positions(embeds.shape[1], self.d_model,
                                                          embeds.device)
        x, _ = self.encoder.apply(params["encoder"], x, ctx)
        return _final_norm(self.norm, self.d_model).apply(params["enc_norm"], x, ctx)

    def write_cross_kv(self, params: Params, cache: Dict[str, Any], enc_row: torch.Tensor,
                       slot: int, ctx: Context) -> Dict[str, Any]:
        """Project one slot's encoder output ``enc_row`` (1, S_row, D), S_row
        <= ``enc_len``, through every cross block's K/V projections, once,
        and write the rows into slot ``slot`` of its ``"xkv"`` node in place
        (each layer of a stacked node with its own layer's weights); sets
        ``xlen[..., slot] = S_row``.  Rows past S_row keep what they held:
        consumers mask them by ``xlen``.  Nothing else of the cache is
        copied.  Returns the cache."""
        sctx = ctx.scope(self.name).scope(self.decoder.name)
        length = enc_row.shape[1]
        dec = self.decoder
        for i, c in enumerate(cache["body"]):
            blk = dec.body[i]
            if not (blk.cross and "xkv" in c):
                continue
            node, p_x = c["xkv"], params["decoder"]["body"][i]["xattn"]
            bctx = sctx.scope(f"p{i}" if dec.stacked else f"l{i}").scope(blk.name)
            for li in range(dec.n_periods) if dec.stacked else (None,):
                p = p_x if li is None else tree_layer(p_x, li)
                k, v = blk._xattn().project_kv(p, enc_row, bctx)
                xk = node["xk"] if li is None else node["xk"][li]
                xv = node["xv"] if li is None else node["xv"][li]
                xk[slot, :length] = k[0]
                xv[slot, :length] = v[0]
            node["xlen"][..., slot].fill_(length)
        return cache

    def _decoder_len(self, cache: Dict[str, Any]):
        """The decoder's live self-attention length: the first KV node's
        ``len`` (an int, or a (B,) device tensor for a per-slot cache; one
        serves every layer), or None for a cache without one."""
        for node in cache["body"]:
            if "kv" in node:
                return node["kv"]["len"]
        return None

    def _positions(self, s: int, device, cache, decode: bool, chunk: Optional[KVChunk],
                   ragged: Optional[RaggedBatch]) -> torch.Tensor:
        """Rows of the learned position table for a (B, S) token block: a
        ragged tick's per-token positions (pads at 0), a chunk's start + i,
        a decode step's live length + i (per slot, read on the device), or
        0..S-1; clipped to the table."""
        top = self.max_target_len - 1
        if ragged is not None:
            return torch.clamp(ragged.positions, 0, top).to(torch.int64)[None, :]
        start = 0
        if chunk is not None:
            start = chunk.start
        elif decode and cache is not None and self._decoder_len(cache) is not None:
            start = self._decoder_len(cache)
        if isinstance(start, torch.Tensor):
            pos = start.to(torch.int64)[:, None] + torch.arange(s, device=device)[None, :]
            return torch.clamp(pos, 0, top)
        return torch.clamp(torch.arange(start, start + s, device=device), 0, top)

    def decode_step(self, params: Params, tokens: torch.Tensor, enc: Optional[torch.Tensor],
                    ctx: Context, *, cache: Optional[Dict[str, Any]] = None,
                    decode: bool = False, chunk: Optional[KVChunk] = None,
                    ragged: Optional[RaggedBatch] = None, logit_pos: Optional[int] = None,
                    logit_rows: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """The decoder over ``tokens`` with cross-attention to ``enc`` (or to
        the cache's ``"xkv"`` rows); (logits (B, S, V_padded) f32, new cache).
        ``chunk``, ``ragged``, ``logit_pos`` and ``logit_rows`` route and
        slice as in :meth:`CausalLM.apply`."""
        ctx = ctx.scope(self.name)
        x = self._embed().apply(params["embed"], tokens, ctx)
        pos = self._positions(tokens.shape[1], tokens.device, cache, decode, chunk, ragged)
        x = x + params["pos_embed"]["table"][pos].to(x.dtype)
        x, new_cache = self.decoder.apply(params["decoder"], x, ctx, cache=cache, enc=enc,
                                          decode=decode, chunk=chunk, ragged=ragged)
        if logit_rows is not None:
            x = x.index_select(1, logit_rows)
        if logit_pos is not None:
            p = logit_pos % x.shape[1]
            x = x[:, p:p + 1]
        x = _final_norm(self.norm, self.d_model).apply(params["final_norm"], x, ctx)
        return self._embed().attend(params["embed"], x, ctx).to(torch.float32), new_cache

    def apply(self, params: Params, tokens: torch.Tensor, ctx: Context, *,
              embeds: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, Any]] = None,
              decode: bool = False,
              enc: Optional[torch.Tensor] = None,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              logit_pos: Optional[int] = None,
              logit_rows: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """:meth:`CausalLM.apply`'s signature: encodes ``embeds`` unless the
        encoder output ``enc`` is given.  A serving cache whose every cross
        block has its ``"xkv"`` node needs neither."""
        if enc is None and embeds is not None:
            enc = self.encode(params, embeds, ctx)
        if enc is None and not _all_cached(cache):
            raise ValueError("EncDecLM needs the encoder's input (embeds) or its output "
                             "(enc): the decoder cross-attends it")
        return self.decode_step(params, tokens, enc, ctx, cache=cache, decode=decode,
                                chunk=chunk, ragged=ragged, logit_pos=logit_pos,
                                logit_rows=logit_rows)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], ctx: Context,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy of the decoder over ``batch["tokens"]``
        given ``batch["embeds"]`` (:func:`_next_token_loss`)."""
        logits, _ = self.apply(params, batch["tokens"], ctx, embeds=batch["embeds"])
        return _next_token_loss(logits, batch["labels"], self.vocab, ctx)


def _all_cached(cache) -> bool:
    """Whether every block of ``cache`` has an ``"xkv"`` node to read."""
    return cache is not None and all("xkv" in node for node in cache["body"])
