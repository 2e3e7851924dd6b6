"""Transformer block and layer stack (``repro/nn/transformer.py``).

The port's :class:`Block` is a pre-norm layer: norm -> mixer (attention,
Mamba or RWKV-6 time-mix) -> residual, norm -> FFN (gated, the classic MLP,
the routed experts of :class:`~repro_torch.nn.moe.MoE`, or the RWKV-6
channel-mix) -> residual, with RMSNorm or LayerNorm; ``parallel=True``
gives the command-r block, in which attention and the FFN both read the one
normed input (``x + attn(norm1(x)) + ffn(norm1(x))``, no ``norm2``).
``cross=True`` (the whisper decoder) adds a cross-attention sub-layer after
the mixer: ``x + xattn(norm_x(x))`` over the encoder's output, projected
every call from ``enc`` or read from the block's ``"xkv"`` cache node
(``nn/attention.py`` ``init_cross_cache``), which only
``EncDecLM.write_cross_kv`` writes: the layers read it and hand it back as
it was.
:class:`Stack` keeps the reference's stacked parameter layout (one leading
layer axis per body position when ``n_periods > 1``) and loops over the
layer axis where the reference runs ``lax.scan``; its ``prelude`` (kimi-k2's
dense first layer) is a stack of one period run before the body, each of
its layers with its own unstacked parameters and cache node
(``params["prelude"][i]``, ``cache["prelude"][i]``).

``Stack(remat=)`` rematerializes each layer's activations in a backward,
the reference's ``REMAT_POLICIES``: ``"off"`` saves them; ``"none"`` and
``"full"`` save only the layer's inputs and recompute the rest
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` also saves the
outputs of the non-batched matmuls (``aten.mm``/``aten.addmm``, the
counterpart of ``dots_with_no_batch_dims_saveable``).  It applies where a
layer's input requires grad (a training step); a serving forward runs the
layers as they are.  The layer's range statistics and auxiliary losses
leave the checkpointed region as outputs, merged once into the caller's
context as the reference's ``merge_scanned`` does, so a recompute adds no
second loss; a dropout mask comes from ``Context.fold_rng`` (a generator
seeded from the scoped name) and is drawn again equal.

A block's cache node holds ``"kv"`` (attention: written in place, only its
``len`` comes back new) or the recurrent state, ``"ssm"`` (the mixer's) and
with the channel-mix ``"cm"`` (its token shift).  Recurrent leaves of a
stacked node carry the layer axis in front (``serve/slot_state.py``
``REC_BASE_RANK``); each step returns new recurrent tensors and leaves the
old ones as they were.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.nn.attention import (Attention, KVChunk, RaggedBatch, init_cross_cache,
                                      init_kv_cache, init_paged_kv_cache, ragged_len)
from repro_torch.nn.layers import LayerNorm, RMSNorm
from repro_torch.nn.mlp import MLP, GatedMLP
from repro_torch.nn.module import Context, Params, tree_unstack
from repro_torch.nn.moe import MoE
from repro_torch.nn.ssm import Mamba, RWKV6ChannelMix, RWKV6TimeMix

# block cache keys of recurrent state: the mixer's and the channel-mix's
RECURRENT_KEYS = ("ssm", "cm")

# the reference's activation rematerialization policies (``off`` = none taken)
REMAT_POLICIES = ("off", "none", "dots", "full")


def _dots_saveable(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of the non-batched matmuls,
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` run under ``torch.utils.checkpoint`` by ``policy``.  The
    port draws no number from torch's global generators in a forward, so
    their states are not stashed."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_saveable)
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **kw)


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual layer: norm + mixer (``"attn"``, ``"mamba"`` or
    ``"rwkv"``) + norm + FFN (``"gated"``, ``"mlp"``, ``"moe"`` or
    ``"rwkv"``; one norm before both, side by side, when ``parallel``), with
    cross-attention between them when ``cross``."""

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
    norm: str = "rms"              # rms | ln
    parallel: bool = False         # command-r parallel attention + FFN
    mixer: str = "attn"            # attn | mamba | rwkv
    ffn: str = "gated"             # gated | mlp | moe | rwkv
    cross: bool = False            # whisper decoder cross-attention
    n_experts: int = 0             # moe: routed experts of d_ff each
    top_k: int = 0
    n_shared_experts: int = 0
    name: str = "block"

    def _norm(self, name: str):
        if self.norm == "ln":
            return LayerNorm(self.d_model, name=name)
        return RMSNorm(self.d_model, name=name)

    def _mixer(self):
        if self.mixer == "attn":
            return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                             use_qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                             use_rope=self.use_rope, causal=self.causal, name="attn")
        if self.mixer == "mamba":
            return Mamba(self.d_model, name="mamba")
        if self.mixer == "rwkv":
            return RWKV6TimeMix(self.d_model, head_dim=self.head_dim or 64, name="timemix")
        raise ValueError(self.mixer)

    def _ffn(self):
        if self.ffn == "gated":
            return GatedMLP(self.d_model, self.d_ff, activation=self.activation, name="ffn")
        if self.ffn == "mlp":
            return MLP(self.d_model, self.d_ff, activation=self.activation, name="ffn")
        if self.ffn == "moe":
            return MoE(self.d_model, self.d_ff, self.n_experts, self.top_k,
                       n_shared_experts=self.n_shared_experts, activation=self.activation,
                       name="moe")
        if self.ffn == "rwkv":
            return RWKV6ChannelMix(self.d_model, self.d_ff, name="chanmix")
        raise ValueError(self.ffn)

    def _xattn(self) -> Attention:
        return Attention(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
                         use_rope=False, causal=False, name="xattn")

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"norm1": self._norm("norm1").init(gen, device),
                     "mixer": self._mixer().init(gen, device)}
        if not self.parallel:
            p["norm2"] = self._norm("norm2").init(gen, device)
        p["ffn"] = self._ffn().init(gen, device)
        if self.cross:
            p["norm_x"] = self._norm("norm_x").init(gen, device)
            p["xattn"] = self._xattn().init(gen, device)
        return p

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool, device,
                   layers: Optional[int] = None, per_slot_len: bool = False,
                   page_size: Optional[int] = None, num_pages: Optional[int] = None,
                   enc_len: Optional[int] = None) -> Dict[str, Any]:
        """Attention: a dense KV slab, or with ``page_size`` a paged pool of
        ``num_pages`` pages (default: dense parity, batch * max_pages), and
        for a cross-attention block of a per-slot cache with ``enc_len`` an
        ``"xkv"`` node of ``enc_len`` encoder rows a slot.  Recurrent mixers:
        their zeroed per-slot state (batch rows are slot rows, so one node
        serves lockstep and continuous batching; KV options do not apply)."""
        c = self._self_cache(batch, max_len, quantized_kv=quantized_kv, device=device,
                             layers=layers, per_slot_len=per_slot_len, page_size=page_size,
                             num_pages=num_pages)
        if self.cross and per_slot_len and enc_len is not None:
            c["xkv"] = init_cross_cache(batch, enc_len, self.n_kv_heads, self.head_dim,
                                        device=device, layers=layers)
        return c

    def _self_cache(self, batch, max_len, *, quantized_kv, device, layers, per_slot_len,
                    page_size, num_pages) -> Dict[str, Any]:
        if self.mixer != "attn":
            c = {"ssm": self._mixer().init_state(batch, device, layers)}
            if self.ffn == "rwkv":
                c["cm"] = self._ffn().init_state(batch, device, layers)
            return c
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
              enc: Optional[torch.Tensor] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        """Run the block; the new cache node holds the new ``kv`` (attention)
        or recurrent state (``ssm``, and ``cm`` for the channel-mix).
        Recurrent mixers refuse ``ragged``, as in the reference.  ``enc``
        (B, S_enc, d_model) is the encoder output a cross-attention block
        attends when its cache has no ``"xkv"`` node."""
        ctx = ctx.scope(self.name)
        h = self._norm("norm1").apply(params["norm1"], x, ctx)
        new_cache: Dict[str, Any] = {}
        if self.mixer == "attn":
            mix, kv = self._mixer().apply(params["mixer"], h, ctx,
                                          cache=None if cache is None else cache["kv"],
                                          decode=decode, chunk=chunk, ragged=ragged)
            if kv is not None:
                new_cache["kv"] = kv
        else:
            if ragged is not None:
                raise NotImplementedError(
                    "the ragged step routes tokens by per-row cache positions; recurrent "
                    "state has no position axis — serve recurrent mixers through the "
                    "chunked path")
            mix, st = self._mixer().apply(params["mixer"], h, ctx,
                                          state=None if cache is None else cache["ssm"],
                                          chunk=chunk)
            if st is not None:
                new_cache["ssm"] = st
        if self.parallel:
            # command-r: y = x + attn(norm(x)) + ffn(norm(x))
            return x + mix + self._ffn().apply(params["ffn"], h, ctx), new_cache or None
        x = x + mix
        if self.cross:
            x = x + self._cross(params, x, ctx, None if cache is None else cache.get("xkv"),
                                enc, chunk, ragged)
        h2 = self._norm("norm2").apply(params["norm2"], x, ctx)
        if self.ffn == "rwkv":
            f, cm = self._ffn().apply(params["ffn"], h2, ctx,
                                      state=None if cache is None else cache.get("cm"),
                                      chunk=chunk)
            if cm is not None:
                new_cache["cm"] = cm
        else:
            f = self._ffn().apply(params["ffn"], h2, ctx)
        return x + f, new_cache or None

    def _cross(self, params: Params, x: torch.Tensor, ctx: Context, xkv, enc, chunk,
               ragged) -> torch.Tensor:
        """The cross-attention sub-layer's output.  A ragged tick's (1, T)
        batch mixes tokens of several slots, so its tokens run as a (T, 1)
        batch, each over its own slot's rows (cached rows, or encoder rows
        re-projected per token); pad rows take slot 0's and are never
        sampled.  The slots are gathered with ``index_select`` on the
        device."""
        hx = self._norm("norm_x").apply(params["norm_x"], x, ctx)
        xattn = self._xattn()
        if ragged is None:
            if xkv is not None:
                return xattn.apply(params["xattn"], hx, ctx, cross_cache=xkv, chunk=chunk)[0]
            return xattn.apply(params["xattn"], hx, ctx, kv_source=enc)[0]
        slots = torch.clamp(ragged.slots, min=0).to(torch.int64)
        hx_t = hx.transpose(0, 1)                                  # (T, 1, d)
        if xkv is not None:
            sub = {k: v.index_select(0, slots) for k, v in xkv.items()}
            out = xattn.apply(params["xattn"], hx_t, ctx, cross_cache=sub)[0]
        else:
            out = xattn.apply(params["xattn"], hx_t, ctx, kv_source=enc.index_select(0, slots))[0]
        return out.transpose(0, 1)


@dataclasses.dataclass(frozen=True)
class Stack:
    """The ``prelude`` stack's layers, then ``body`` (a period of blocks)
    repeated ``n_periods`` times.  Unstacked layers are scoped
    ``{layer_scope}{i}``: a prelude is ``Stack(blocks, 1, layer_scope="pre")``
    and shares its parent's name, so its layers are ``stack/pre{i}`` as the
    reference's are."""

    body: Tuple[Block, ...]
    n_periods: int
    prelude: Optional["Stack"] = None
    layer_scope: str = "l"
    remat: str = "full"            # off | none | dots | full
    name: str = "stack"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT_POLICIES}")

    @property
    def blocks(self) -> Tuple[Block, ...]:
        """Every layer's block in order: the prelude's, then the body's
        period after period."""
        return (self.prelude.blocks if self.prelude else ()) + self.body * self.n_periods

    @property
    def n_layers(self) -> int:
        return len(self.blocks)

    @property
    def attention_layers(self) -> int:
        """Layers with an attention mixer, each one KV cache layer."""
        return sum(b.mixer == "attn" for b in self.blocks)

    @property
    def stacked(self) -> bool:
        """Whether params and caches carry a leading layer axis."""
        return self.n_periods > 1

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {}
        if self.prelude:
            p["prelude"] = self.prelude.init(gen, device)["body"]
        if not self.stacked:
            p["body"] = [blk.init(gen, device) for blk in self.body]
            return p
        body = []
        for blk in self.body:
            # each layer is drawn in turn and copied into its slice of the
            # stacked leaves, so the float model is never held twice
            # (glm4-9b's is 35 GB)
            first = blk.init(gen, device)
            stacked = _map_tree(lambda t: t.new_empty((self.n_periods, *t.shape)), first)
            _fill_layer(stacked, first, 0)
            del first
            for i in range(1, self.n_periods):
                _fill_layer(stacked, blk.init(gen, device), i)
            body.append(stacked)
        p["body"] = body
        return p

    def init_cache(self, batch: int, max_len: int, *, quantized_kv: bool,
                   device, per_slot_len: bool = False, page_size: Optional[int] = None,
                   num_pages: Optional[int] = None,
                   enc_len: Optional[int] = None) -> Dict[str, Any]:
        kw = dict(quantized_kv=quantized_kv, device=device, per_slot_len=per_slot_len,
                  page_size=page_size, num_pages=num_pages, enc_len=enc_len)
        c: Dict[str, Any] = {}
        if self.prelude:
            c["prelude"] = self.prelude.init_cache(batch, max_len, **kw)["body"]
        layers = self.n_periods if self.stacked else None
        c["body"] = [blk.init_cache(batch, max_len, layers=layers, **kw) for blk in self.body]
        return c

    def apply(self, params: Params, x: torch.Tensor, ctx: Context, *,
              cache: Optional[Dict[str, Any]] = None,
              enc: Optional[torch.Tensor] = None,
              decode: bool = False,
              chunk: Optional[KVChunk] = None,
              ragged: Optional[RaggedBatch] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        if self.prelude:
            # the prelude takes this stack's context before it is scoped: its
            # own name is this one's
            x, pre = self.prelude.apply(
                {"body": params["prelude"]}, x, ctx,
                cache=None if cache is None else {"body": cache["prelude"]},
                enc=enc, decode=decode, chunk=chunk, ragged=ragged)
        ctx = ctx.scope(self.name)
        lens = {}
        states: Dict[int, list] = {pos: [] for pos in range(len(self.body))}
        body = params["body"]
        if self.stacked:
            body = [tree_unstack(p, self.n_periods) for p in body]
        for period in range(self.n_periods):
            for pos, blk in enumerate(self.body):
                p, c = body[pos], None if cache is None else cache["body"][pos]
                if self.stacked:
                    p = p[period]
                    if c is not None:
                        c = _layer_cache(c, period)
                bctx = ctx.scope(f"p{pos}" if self.stacked else f"{self.layer_scope}{pos}")
                if self.remat != "off" and x.requires_grad and torch.is_grad_enabled():
                    x, nc = self._remat_layer(blk, p, x, bctx, cache=c, enc=enc, decode=decode,
                                              chunk=chunk, ragged=ragged)
                else:
                    x, nc = blk.apply(p, x, bctx, cache=c, enc=enc, decode=decode, chunk=chunk,
                                      ragged=ragged)
                if nc is not None:
                    if "kv" in nc:
                        lens[pos] = nc["kv"]["len"]
                    states[pos].append({k: v for k, v in nc.items() if k in RECURRENT_KEYS})
        if cache is None:
            return x, None
        if ragged is not None:
            # the ragged layers leave ``len`` alone; it rises once per tick
            lens = {pos: ragged_len(ln, ragged) for pos, ln in lens.items()}
        # every attention layer wrote its k/v rows in place; only the length
        # advances (each layer of a period got the same ``len`` and computed
        # the same new one).  A paged cache's per-layer pools are views of the
        # stacked (L, P, ps, Hkv, D) pools; its one table serves every layer.
        # Recurrent layers returned new state, stacked back along the layer axis.
        # A cross-attention node ("xkv") was only read: it goes back as it was.
        out = []
        for pos, c in enumerate(cache["body"]):
            node = dict(c)
            if "kv" in c:
                node["kv"] = dict(c["kv"], len=lens[pos])
            for key in RECURRENT_KEYS:
                if key in c:
                    node[key] = _stack_states([st[key] for st in states[pos]]) \
                        if self.stacked else states[pos][0][key]
            out.append(node)
        new = {"body": out}
        if self.prelude:
            new["prelude"] = pre["body"]
        return x, new

    def _remat_layer(self, blk: Block, p, x, ctx: Context, **kw):
        """One layer under :func:`_remat`: it records into a context of its
        own, whose statistics and losses come out as outputs and are merged
        here (statistics by max, losses added in layer order)."""
        def layer(p, x):
            own = dataclasses.replace(ctx, stats={}, losses={})
            y, nc = blk.apply(p, x, own, **kw)
            return y, nc, own.stats, own.losses

        x, nc, stats, losses = _remat(layer, self.remat)(p, x)
        for k, v in stats.items():
            ctx.stats[k] = torch.maximum(ctx.stats[k], v) if k in ctx.stats else v
        for k, v in losses.items():
            ctx.add_loss(k, v)
        return x, nc


def _layer_cache(node: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s view of a stacked cache node: the KV slabs' slices (the
    length and a paged table serve every layer) and the recurrent leaves'."""
    out = {}
    for key, sub in node.items():
        if key == "kv":
            out[key] = dict(sub, k=sub["k"][i], v=sub["v"][i])
        else:
            out[key] = {k: None if v is None else v[i] for k, v in sub.items()}
    return out


def _stack_states(layers: list) -> Dict[str, Any]:
    """Per-layer recurrent states stacked along a new leading layer axis."""
    return {k: None if layers[0][k] is None else torch.stack([st[k] for st in layers])
            for k in layers[0]}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fill_layer(stacked, layer, i: int) -> None:
    """Copy one layer's param tree into slice ``i`` of the stacked tree."""
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _fill_layer(v, layer[k], i)
    else:
        stacked[i].copy_(layer)
