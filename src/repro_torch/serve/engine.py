"""Batched serving engine and its step builders (``repro/serve/engine.py``).

``weight_quant`` stores every GEMM and embedding weight as an int8
:class:`QTensor` (the ``wq_matmul`` kernel path), or packs the GEMM weights
to int4 (the ``wq4_matmul`` kernel path) or int2; ``quantized_kv`` keeps the
KV cache as int8 on the paper's Qm.n grid (the ``qdecode_attn`` and
``qchunk_attn`` kernel paths, or with ``paged_kv`` the
``qpaged_decode_attn`` and ``qpaged_chunk_attn`` ones; the ragged tick
takes ``qragged_attn`` over either).  PyTorch runs
eagerly, so the reference's jitted steps are plain functions over the
engine's params here; the cache is updated in place.

An EncDec model (whisper) takes its encoder output ``enc`` in every step:
(B, S_enc, D), one row per slot (the chunk half of the mixed step slices
its slot's row).  With ``cross_attn_cache`` (the default) the scheduler's
per-slot cache also holds each slot's projected cross-attention K/V, which
the steps read in place of re-projecting ``enc``.  Its weights stay float:
the reference cannot serve EncDec with int8 weights (its learned position
table becomes a ``QTensor`` that its decoder cannot index), so
``weight_quant`` is refused at construction.

A model with MoE layers serves with int8 weights: each stacked expert
weight is a ``QTensor`` that ``nn/moe.py`` dequantizes whole every forward,
as the reference does.  Packed int4/int2 weights are refused at
construction: the reference packs the expert stacks and then fails on them.

Under a mesh (``mesh``, a (data, model) ``DeviceMesh`` of one process a
rank, with ``axis_rules``) the engine holds this rank's shards of the
params (``param_pspecs(..., serve=True)``) and this data rank's B / D slots
of the cache, and every step takes them:

* each call gathers its weights once (``sharding.gather_serving``: the rows
  cut over ``data`` in a few large collectives, the table whole; the
  columns stay cut over ``model`` and the expert stacks as they are);
* a step's sampled rows reach every rank's host in one gather over
  ``data`` (``shard_ops.gather_host``): the argmax tokens at temperature 0,
  above it the logit rows, which every rank then samples whole from one
  generator (the one device's draws), so every rank takes the same host
  decisions and each step returns the whole batch's tokens;
* the work one data rank's slot owns (the mixed step's chunk, a one-shot
  prompt) runs on every data rank on the same tokens: the owner writes its
  slot, the others nothing (``KVChunk(slot=None)``), and the MoE routes the
  owner's tokens (``Context.rows``); a ragged tick's flat batch is each
  rank's decode rows and the lanes it owns, and its MoE routes the one
  device's flat batch.

* audit mode (``with_health=True``): the health flags of every row travel
  in the same gather, beside the sampled tokens (above temperature 0 every
  rank flags the gathered logit rows itself); a poison vector is this
  rank's rows;
* over a paged pool (one block a data rank), a decode row that reads
  through an unmapped entry reads the one device's pool page 0: data rank
  0's, mirrored on the other ranks (``nn/attention.py`` ``PageZero``;
  the steps' ``page_zero=``).

Recurrent, hybrid and EncDec models, VLM prefixes and packed sub-int8
weights are refused under a mesh (``ROADMAP.md`` queue 1, item 3b.7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.integerize import integerize_weights_only
from repro_torch.dist import shard_ops, sharding
from repro_torch.nn.attention import KVChunk, RaggedBatch
from repro_torch.nn.module import Context, DataRows, resolve_device, tree_to

# Default page size of a paged cache on the card.  qpaged_decode_attn walks
# positions, not pages, so the page size barely moves it: chip_smoke.py's
# sweep at B=8, S=2048 measured 129.27 / 125.88 / 125.73 / 125.98 us for
# ps 16 / 32 / 64 / 128 (NVIDIA H100 80GB HBM3, 700 W).  The smallest of
# them keeps prefix sharing fine-grained and the last page's waste small.
CUDA_PAGE_SIZE = 16
# Off the card, the reference's default outside compiled TPU dispatch.
CPU_PAGE_SIZE = 16


def _weight_quant_kwargs(spec: Union[bool, str], weight_block: int) -> dict:
    """``integerize_weights_only`` kwargs for an engine ``weight_quant`` spec:
    ``True``/``"int8"`` per-channel int8; ``"int4"``/``"int2"`` packed
    per-channel; the ``"-block"`` suffix gives per-block scales of
    ``weight_block`` K rows."""
    if spec is True or spec == "int8":
        return {}
    if isinstance(spec, str):
        base, _, tail = spec.partition("-")
        bits = {"int4": 4, "int2": 2}.get(base)
        if bits is not None and tail in ("", "block"):
            return {"bits": bits, "block_size": weight_block if tail == "block" else None}
    raise ValueError(
        f"weight_quant={spec!r}: expected True, 'int8', 'int4[-block]' "
        f"or 'int2[-block]'")


def mask_vocab_tail(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-inf the padded-vocab tail so it can never be sampled."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota >= vocab, torch.full_like(logits, -torch.inf), logits)


def sample_tokens(logits: torch.Tensor, gen: Optional[torch.Generator], vocab: int,
                  temperature: float) -> torch.Tensor:
    """(..., V) greedy (temperature 0) or categorical sample -> (..., 1) int32.

    ``vocab`` outside (0, V) means no padded tail.  Categorical draws come
    from ``gen`` and are not comparable with the reference's ``jax.random``.
    """
    if 0 < vocab < logits.shape[-1]:
        logits = mask_vocab_tail(logits, vocab)
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=gen)
        nxt = flat.reshape(probs.shape[:-1])
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt[..., None].to(torch.int32)


def enc_kwargs(enc: Optional[torch.Tensor]) -> dict:
    """The ``enc`` keyword of an EncDec model's apply, absent for the rest."""
    return {} if enc is None else {"enc": enc}


#: Where the features a mesh does not serve yet are queued.
MESH_NEXT = "ROADMAP.md queue 1, item 3b.7"


def mesh_refusal(what: str) -> NotImplementedError:
    """The error for a feature not served under a mesh yet."""
    return NotImplementedError(f"{what} under a mesh is not served yet ({MESH_NEXT})")


def _step_context(mesh, axis_rules) -> Context:
    """A serving step's context; under a mesh (``mesh`` and ``axis_rules``
    together) the params are this rank's shards by ``param_pspecs(...,
    serve=True)`` and the cache and the tokens this rank's rows."""
    if (mesh is None) != (axis_rules is None):
        raise ValueError("a serving step under a mesh takes mesh and axis_rules together")
    return Context(mesh=mesh, axis_rules=axis_rules)


def _step_weights(model, mesh, axis_rules) -> Callable:
    """``params -> the weights of one call``: under a mesh the rows cut
    over ``data`` gathered once (``sharding.gather_serving``), by the specs
    of the model's whole shapes (a ``meta`` init); the identity without."""
    if mesh is None:
        return lambda params: params
    specs = sharding.param_pspecs(model.init(torch.Generator(), "meta"), mesh, axis_rules,
                                  serve=True)
    return lambda params: sharding.gather_serving(params, specs, mesh)


def owner_rows(owner: int, n: int, device) -> DataRows:
    """The :class:`DataRows` of a forward whose n tokens are the same on
    every data rank and belong to data rank ``owner``'s slot (a chunk, a
    one-shot prompt): the one device's tokens are the owner's, and every
    rank keeps all n."""
    take = torch.arange(n, device=device)
    return DataRows(select=take + owner * n, take=take)


def sample_over_data(rows: torch.Tensor, n_dec: int, extra_from, gen, vocab: int,
                     temperature: float, mesh, axis: str, *, joint: bool = False,
                     health: bool = False, poison: Optional[torch.Tensor] = None):
    """A step's sampled rows under a data split, the same on every rank.

    ``rows`` (n_dec + E, V): this rank's logit rows, its n_dec decode rows
    then E extra rows (a chunk's or the lanes' first-token rows), of which
    the real one of extra e is data rank ``extra_from`` 's (an int for
    every extra, or an (E,) tensor).  One gather over ``axis``
    (:func:`shard_ops.gather_host`): at temperature 0 this rank's argmax
    tokens; above it the logit rows, which every rank then samples, the
    decode rows of every rank in rank order (the one device's slot order)
    and the extras after them (``joint``: in one draw, as the ragged step
    draws; else two), from ``gen``.  Returns (the whole batch's decode
    tokens (D * n_dec, 1), the extras (E, 1)), int32.

    ``health`` (audit mode): ``poison`` (this rank's first P rows, P =
    n_dec or n_dec + E) is added to the rows first, and every row is
    flagged finite or not as :func:`_health` flags it on one device: at
    temperature 0 the flags travel in the gather beside the tokens, above
    it every rank flags the gathered rows.  Returns then (decode tokens,
    extras, decode flags (D * n_dec,), extras' flags (E,))."""
    extra = rows.shape[0] - n_dec
    if poison is not None:
        rows = torch.cat([rows[:poison.shape[0]] + poison[:, None], rows[poison.shape[0]:]])

    def split(g):
        dec = g[:, :n_dec].reshape((-1,) + tuple(g.shape[2:]))
        if isinstance(extra_from, int):
            return dec, g[extra_from, n_dec:]
        return dec, g[extra_from, n_dec + torch.arange(extra, device=g.device)]

    if temperature > 0.0:
        dec, ext = split(shard_ops.gather_host(rows, mesh, axis))
        if health:
            (dec, dec_ok), (ext, ext_ok) = _health(dec), _health(ext)
        if joint:
            both = sample_tokens(torch.cat([dec, ext]), gen, vocab, temperature)
            out = both[:dec.shape[0]], both[dec.shape[0]:]
        else:
            dec = sample_tokens(dec, gen, vocab, temperature)
            out = dec, (sample_tokens(ext, gen, vocab, temperature) if extra else dec[:0])
        return out + (dec_ok, ext_ok) if health else out
    if not health:
        dec, ext = split(shard_ops.gather_host(sample_tokens(rows, None, vocab, 0.0)[:, 0],
                                               mesh, axis))
        return dec[:, None], ext[:, None]
    rows, ok = _health(rows)
    dec, ext = split(shard_ops.gather_host(
        torch.stack([sample_tokens(rows, None, vocab, 0.0)[:, 0], ok.to(torch.int32)], -1),
        mesh, axis))
    return dec[:, :1], ext[:, :1], dec[:, 1] != 0, ext[:, 1] != 0


def make_prefill_step(model, *, mesh=None, axis_rules=None) -> Callable:
    """(params, tokens (B, P), cache, embeds=None, logit_pos=None, enc=None)
    -> (logits, cache').

    Last-position logits (B, V) by default; ``logit_pos`` returns (B, 1, V)
    at that position, slicing the hidden states before the LM head (a
    slot-targeted prefill over a padded prompt bucket passes its true last
    position).  ``embeds`` (B, S_vis, D) is a VLM's vision prefix, written
    into the cache ahead of the prompt; ``enc`` an EncDec model's encoder
    output.  ``mesh``/``axis_rules``: the sharded execution
    (:func:`_step_context`); each data rank prefills its rows, or with
    ``owner`` (a data rank) every data rank prefills the same prompt (the
    one-shot slot prefill's batch-1 prompt, owner's slot), its MoE routing
    the owner's tokens.
    """
    ctx = _step_context(mesh, axis_rules)
    weights = _step_weights(model, mesh, axis_rules)

    def prefill(params, tokens, cache, embeds: Optional[torch.Tensor] = None,
                logit_pos: Optional[int] = None, enc: Optional[torch.Tensor] = None, *,
                owner: Optional[int] = None):
        c = ctx
        if mesh is not None:
            if embeds is not None:
                raise mesh_refusal("a VLM prefix (embeds)")
            if owner is not None:
                c = dataclasses.replace(ctx, rows=owner_rows(owner, tokens.numel(),
                                                             tokens.device))
        logits, cache = model.apply(weights(params), tokens, c, embeds=embeds, cache=cache,
                                    decode=True, logit_pos=logit_pos, **enc_kwargs(enc))
        return (logits if logit_pos is not None else logits[:, -1]), cache

    return prefill


def _health(row: torch.Tensor, poison: Optional[torch.Tensor] = None):
    """Audit mode's sampling rows: (``row`` (+ ``poison``) with a finite row
    in place of any non-finite one, the (R,) flags: all of the row finite).
    The sampler must see finite rows: ``torch.multinomial`` raises on NaN
    probabilities on the CPU and trips a device-side assert on the card.  A
    flagged row's token is never emitted (its slot is evicted)."""
    if poison is not None:
        row = row + poison[:, None]
    ok = torch.isfinite(row).all(-1)
    return torch.where(ok[:, None], row, torch.zeros_like(row)), ok


def make_decode_step(model, *, mesh=None, axis_rules=None, temperature: float = 0.0,
                     with_health: bool = False) -> Callable:
    """(params, token (B, 1), cache, gen) -> (next (B, 1) int32, cache').

    ``with_health=True`` (the scheduler's audit mode) takes a trailing
    ``poison``, a (B,) float32 tensor added to the last-position logits
    (zeros are an exact no-op, a NaN is the fault plan's injection), and
    returns (next, healthy (B,) bool, cache'): ``healthy[b]`` is False iff
    row b's logits hold a NaN or an Inf.  ``enc`` (B, S_enc, D): an EncDec
    model's encoder output, one row per slot.  ``mesh``/``axis_rules``:
    the sharded execution (:func:`_step_context`): each data rank decodes
    its rows of the cache (the dense decode's ``qdecode_attn`` on them),
    an MoE layer takes the weight-stationary dispatch (``nn/moe.py``), and
    ``next`` (and ``healthy``) are the whole batch's (D * B,) rows on every
    rank (:func:`sample_over_data`); ``poison`` is this rank's B rows, and
    ``page_zero`` (a ``PageZero``) where a paged read finds page 0.
    """
    ctx = _step_context(mesh, axis_rules)
    weights = _step_weights(model, mesh, axis_rules)
    axis = ctx.rule("batch")

    def decode(params, token, cache, gen, poison=None, *, enc=None, page_zero=None):
        c = ctx if page_zero is None else dataclasses.replace(ctx, page_zero=page_zero)
        logits, cache = model.apply(weights(params), token, c, cache=cache, decode=True,
                                    **enc_kwargs(enc))
        if mesh is not None:
            out = sample_over_data(logits[:, -1], token.shape[0], 0, gen, model.vocab,
                                   temperature, mesh, axis, health=with_health, poison=poison)
            return (out[0], out[2], cache) if with_health else (out[0], cache)
        if not with_health:
            return sample_tokens(logits[:, -1], gen, model.vocab, temperature), cache
        row, ok = _health(logits[:, -1], poison)
        return sample_tokens(row, gen, model.vocab, temperature), ok, cache

    return decode


def make_mixed_step(model, *, mesh=None, axis_rules=None, temperature: float = 0.0,
                    with_health: bool = False, merge: Optional[Callable] = None) -> Callable:
    """The chunked-prefill tick: every slot decodes one token, then one
    C-token prompt chunk is written in place into its slot's KV rows (or
    into its recurrent state row).

    (params, tok (B, 1), cache, gen, chunk_tok (1, C), slot, start, length)
      -> (next (B, 1), first (1, 1), cache')

    ``length`` is the chunk's valid token count (< C only on the last,
    padded chunk); ``first`` samples the logits at position length-1 and
    means something only on that last chunk.  The decode half runs first,
    so its append for the still-prefilling slot lands on the row the chunk
    then overwrites (junk stays at rows >= ``len``).

    ``with_health=True`` (audit mode) takes a trailing (B,) ``poison`` for
    the decode rows (see :func:`make_decode_step`) and returns (next, first,
    decode healthy (B,), first healthy (1,), cache').

    ``merge`` (recurrent-state models): ``merge(old, new, active) -> cache``
    runs between the decode half and the chunk half with the step's
    trailing ``active`` ((B,) bool on the device): a recurrence has no
    position axis to hide a masked step behind, so every inactive slot's
    rows go back to their values before the decode half, and the chunk
    half then reads its slot's row unadvanced
    (``serve/slot_state.py`` ``merge_inactive``).

    ``enc`` (EncDec serving): the per-slot encoder outputs (B, S_enc, D).
    The decode half cross-attends each slot to its own row; the batch-1
    chunk half takes the target slot's row.

    ``mesh``/``axis_rules``: the sharded execution; ``tok`` and the cache
    are this data rank's B / D slots and ``slot`` is global.  Every data
    rank runs both halves on the same chunk: the slot's owner writes it
    into its local slot, the others write nothing, and an MoE routes the
    owner's chunk tokens.  ``next`` (B, 1) and ``first`` (1, 1, the
    owner's) come to every rank in one gather (:func:`sample_over_data`).
    """
    if mesh is not None:
        return _mesh_mixed_step(model, mesh, axis_rules, temperature, with_health, merge)
    decode = make_decode_step(model, temperature=temperature, with_health=with_health)

    def mixed(params, tok, cache, gen, chunk_tok, slot: int, start: int, length: int,
              poison=None, active=None, enc=None):
        old = cache
        if with_health:
            nxt, dec_ok, cache = decode(params, tok, cache, gen, poison, enc=enc)
        else:
            nxt, cache = decode(params, tok, cache, gen, enc=enc)
        if merge is not None and active is not None:
            cache = merge(old, cache, active)
        logits, cache = model.apply(params, chunk_tok, Context(), cache=cache, decode=True,
                                    chunk=KVChunk(slot=slot, start=start, length=length),
                                    logit_pos=length - 1,
                                    **enc_kwargs(None if enc is None else enc[slot:slot + 1]))
        if not with_health:
            return nxt, sample_tokens(logits[:, 0], gen, model.vocab, temperature), cache
        row, first_ok = _health(logits[:, 0])
        first = sample_tokens(row, gen, model.vocab, temperature)
        return nxt, first, dec_ok, first_ok, cache

    return mixed


def _mesh_mixed_step(model, mesh, axis_rules, temperature: float, with_health: bool,
                     merge: Optional[Callable]) -> Callable:
    """:func:`make_mixed_step` under a mesh (a causal attention model);
    ``poison`` is this rank's decode rows and ``page_zero`` (a
    ``PageZero``) where the decode half's paged reads find page 0."""
    ctx = _step_context(mesh, axis_rules)
    weights = _step_weights(model, mesh, axis_rules)
    if merge is not None:
        raise mesh_refusal("a recurrent-state model")
    axis = ctx.rule("batch")
    rank = shard_ops.axis_index(mesh, axis)

    def mixed(params, tok, cache, gen, chunk_tok, slot: int, start: int, length: int,
              poison=None, active=None, enc=None, *, page_zero=None):
        if enc is not None:
            raise mesh_refusal("an EncDec model")
        w = weights(params)
        logits, cache = model.apply(w, tok, dataclasses.replace(ctx, page_zero=page_zero),
                                    cache=cache, decode=True)
        owner, local = divmod(slot, tok.shape[0])
        rows = owner_rows(owner, chunk_tok.shape[1], tok.device)
        first, cache = model.apply(w, chunk_tok, dataclasses.replace(ctx, rows=rows),
                                   cache=cache, decode=True,
                                   chunk=KVChunk(slot=local if owner == rank else None,
                                                 start=start, length=length),
                                   logit_pos=length - 1)
        out = sample_over_data(torch.cat([logits[:, -1], first[:, 0]]), tok.shape[0], owner,
                               gen, model.vocab, temperature, mesh, axis, health=with_health,
                               poison=poison)
        return out + (cache,)

    return mixed


def make_ragged_step(model, *, mesh=None, axis_rules=None, temperature: float = 0.0,
                     with_health: bool = False) -> Callable:
    """One ragged forward per tick: the decode tokens of every slot and the
    prompt-chunk tokens of up to L admission lanes flatten into one (1, T)
    token batch, T = B + L*C, so each layer runs one GEMM per projection and
    one attention launch per tick, however many lanes are active.

    (params, tok (B, 1), cache, gen, chunk_tok (L, C), slot_ids (T,),
     positions (T,), logit_rows (R,)) -> (next (R, 1), cache')

    Token t is logical row ``positions[t]`` of slot ``slot_ids[t]``;
    position -1 marks an inert pad row (an idle slot, a lane's tail).
    ``logit_rows`` ((R,) int32, R = B + L) picks the rows that sample: row
    r < B is slot r's decode token, row B + l lane l's last valid chunk
    token (meaningful on its last chunk only); the LM head runs over R rows.
    Every shape depends on (B, L, C) alone.

    ``with_health=True`` (audit mode) takes a trailing (R,) ``poison`` over
    the sampled rows and returns (next (R, 1), healthy (R,), cache').
    ``enc`` (EncDec serving): the per-slot encoder outputs (B, S_enc, D);
    each token cross-attends its own slot's (``nn/transformer.py``).

    ``mesh``/``axis_rules``: the sharded execution.  ``tok``, the cache and
    the addressing are this data rank's: its slots' decode rows and the
    lanes whose slot it owns, the other lanes inert (``serve/lanes.py``
    ``localize_ragged_tick``); the step then takes ``rows`` (the tick's
    :class:`DataRows`: the one device's flat batch, which an MoE routes)
    and ``owners`` ((L,) the data rank that owns each lane), and returns
    the whole batch's (D * B + L, 1) rows (and healthy flags) on every
    rank, the lanes' from their owners (:func:`sample_over_data`);
    ``poison`` is this rank's sampled rows (``LocalTick.sampled``).
    """
    ctx = _step_context(mesh, axis_rules)
    weights = _step_weights(model, mesh, axis_rules)
    axis = ctx.rule("batch")

    def ragged_step(params, tok, cache, gen, chunk_tok, slot_ids, positions, logit_rows,
                    poison=None, enc=None, *, rows: Optional[DataRows] = None,
                    owners: Optional[torch.Tensor] = None):
        if mesh is not None and enc is not None:
            raise mesh_refusal("an EncDec model")
        flat = torch.cat([tok[:, 0], chunk_tok.reshape(-1)])[None, :]
        logits, cache = model.apply(weights(params), flat, dataclasses.replace(ctx, rows=rows),
                                    cache=cache, decode=True,
                                    ragged=RaggedBatch(slots=slot_ids, positions=positions),
                                    logit_rows=logit_rows, **enc_kwargs(enc))
        if mesh is not None:
            out = sample_over_data(logits[0], tok.shape[0], owners, gen, model.vocab,
                                   temperature, mesh, axis, joint=True, health=with_health,
                                   poison=poison)
            nxt = torch.cat(out[:2])
            return (nxt, torch.cat(out[2:]), cache) if with_health else (nxt, cache)
        if not with_health:
            return sample_tokens(logits[0], gen, model.vocab, temperature), cache
        rows, ok = _health(logits[0], poison)
        return sample_tokens(rows, gen, model.vocab, temperature), ok, cache

    return ragged_step


@dataclasses.dataclass
class ServeEngine:
    """Fixed-slot lockstep generation over a (possibly quantized) model.

    ``device`` defaults to ``cuda`` (see ``resolve_device``); the params are
    moved there and, with ``weight_quant``, integerized there: ``True`` or
    ``"int8"`` per-channel int8, ``"int4"``/``"int2"`` packed per-channel,
    ``"int4-block"``/``"int2-block"`` packed with one scale per
    ``weight_block`` K rows.

    ``own_params=True`` hands the caller's tree over: with ``weight_quant``
    it is integerized in place (the caller's containers then hold the
    codes), freeing each float leaf as its codes appear, for a model that
    cannot be held twice (glm4-9b: 35 GB of float32, 8.8 GB of int8 codes).

    ``paged_kv`` makes the scheduler's cache (``new_cache(per_slot=True)``)
    a pool of ``kv_pool_pages`` pages of ``page_size`` rows shared by every
    slot plus a per-slot page table, instead of (slots, max_len) slabs;
    lockstep ``generate()`` stays dense.  ``kv_pool_pages=None`` is dense
    parity (slots * ceil(max_len / page_size)); ``page_size=None`` resolves
    to ``CUDA_PAGE_SIZE`` on the card and ``CPU_PAGE_SIZE`` elsewhere.

    ``cross_attn_cache`` (EncDec models): the scheduler's cache carries each
    slot's projected cross-attention K/V, written once per admission; False
    re-projects the encoder output every step.

    ``mesh``/``axis_rules`` (a (data, model) ``DeviceMesh`` and its rules,
    every rank building the engine alike): the params are integerized
    (``weight_quant``) where the caller made them, cut to this rank's
    shards by ``param_pspecs(..., serve=True)`` and only then moved to
    ``device``; the caches hold this data rank's ``batch_slots / D`` slots
    (and a paged pool its block of ``kv_num_pages / D`` pages: its slots'
    pages, by local id, then one page that mirrors the one device's page
    0, :attr:`page_zero_mirror`); ``generate()``, the steps and every
    scheduler policy and mode run the sharded execution (module
    docstring).  ``batch_slots`` and ``kv_num_pages`` count the whole mesh.
    """

    model: Any
    params: Any
    max_len: int
    batch_slots: int
    quantized_kv: bool = False
    weight_quant: Union[bool, str] = False
    weight_block: int = 32
    temperature: float = 0.0
    device: Any = None
    paged_kv: bool = False
    page_size: Optional[int] = None
    kv_pool_pages: Optional[int] = None
    own_params: bool = False
    cross_attn_cache: bool = True
    mesh: Any = None
    axis_rules: Any = None

    def __post_init__(self):
        if self.mesh is not None or self.axis_rules is not None:
            self._check_mesh()
        if self.weight_quant and self.encdec:
            raise ValueError(
                f"weight_quant={self.weight_quant!r} on an EncDec model: the reference "
                "cannot serve it (integerize_weights_only turns the learned position table "
                "pos_embed/table into a QTensor and its first decode step fails indexing "
                "it); serve EncDec with float weights (quantized_kv is supported)")
        self.device = resolve_device(self.device)
        if self.page_size is None:
            self.page_size = CUDA_PAGE_SIZE if self.device.type == "cuda" else CPU_PAGE_SIZE
        elif self.paged_kv and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.paged_kv and self.kv_pool_pages is not None and self.kv_pool_pages < 1:
            raise ValueError(f"kv_pool_pages must be >= 1, got {self.kv_pool_pages}")
        kw = _weight_quant_kwargs(self.weight_quant, self.weight_block) \
            if self.weight_quant else None
        if kw and any(b.ffn == "moe" for b in self.model.stack.blocks):
            raise ValueError(
                f"weight_quant={self.weight_quant!r} on a model with MoE layers: the reference "
                "cannot serve it (integerize_weights_only packs the stacked expert kernels "
                "and MoE._expert_w, which knows QTensor but not PackedQTensor, fails on them "
                "with AttributeError); serve MoE with int8 weights (weight_quant=True)")
        if kw is not None and self.own_params:
            # the caller's tree is converted in place where its leaves lie, so
            # each float leaf is freed as its codes appear
            self.params = integerize_weights_only(self.params, release=True, **kw)
        if self.mesh is not None:
            if self.paged_kv and self.kv_num_pages % self.data_size:
                raise ValueError(f"kv_num_pages {self.kv_num_pages} does not divide over "
                                 f"{self.data_size} data ranks (each holds its slots' block "
                                 f"of the pool)")
            # integerized where the caller made them, then cut, then moved:
            # a rank's device holds its shards alone
            if kw is not None and not self.own_params:
                self.params = integerize_weights_only(self.params, **kw)
            self.params = sharding.shard_tree(self.params, sharding.param_pspecs(
                self.params, self.mesh, self.axis_rules, serve=True), self.mesh)
            self.params = tree_to(self.params, self.device)
            return
        self.params = tree_to(self.params, self.device)
        if kw is not None and not self.own_params:
            self.params = integerize_weights_only(self.params, **kw)

    def _check_mesh(self) -> None:
        """The mesh, its rules and this engine's geometry: refuse what a
        mesh does not serve yet (:data:`MESH_NEXT`) and what cannot be cut."""
        if self.mesh is None or self.axis_rules is None:
            raise ValueError("ServeEngine under a mesh takes mesh and axis_rules together")
        from repro_torch.models.lm import CausalLM

        blocks = getattr(getattr(self.model, "stack", None), "blocks", ())
        if self.encdec or not isinstance(self.model, CausalLM):
            raise mesh_refusal("an EncDec model")
        if any(b.mixer != "attn" or b.ffn == "rwkv" for b in blocks):
            raise mesh_refusal("a recurrent or hybrid model (Mamba, RWKV-6, jamba)")
        if self.weight_quant and _weight_quant_kwargs(self.weight_quant, self.weight_block):
            raise mesh_refusal(f"packed sub-int8 weights (weight_quant={self.weight_quant!r})")
        if not hasattr(self.mesh, "get_group"):
            raise ValueError("ServeEngine(mesh=...) executes over a DeviceMesh "
                             "(launch.mesh.make_host_mesh); a mapping of axis sizes has no "
                             "process group")
        rule = self.axis_rules.get("batch")
        if rule not in ("data", ("data",)):
            raise ValueError(f"ServeEngine under a mesh splits its slots over the data axis: "
                             f"the batch rule is {rule!r}")
        if self.batch_slots % self.data_size:
            raise ValueError(f"batch_slots {self.batch_slots} does not divide over "
                             f"{self.data_size} data ranks")

    @property
    def data_size(self) -> int:
        """The data ranks the slots are split over (1 without a mesh)."""
        return shard_ops.axis_size(self.mesh, "data")

    @property
    def data_rank(self) -> int:
        """This rank's data index (0 without a mesh)."""
        return shard_ops.axis_index(self.mesh, "data")

    @property
    def local_slots(self) -> int:
        """The slots this data rank holds: ``batch_slots / D``."""
        return self.batch_slots // self.data_size

    @property
    def local_pages(self) -> int:
        """The pool pages this data rank holds: ``kv_num_pages / D``."""
        return self.kv_num_pages // self.data_size

    @property
    def page_zero_mirror(self) -> Optional[int]:
        """Under a mesh of several data ranks over a paged pool, the index
        of the page each rank's pool adds past its block to mirror the one
        device's pool page 0 (``nn/attention.py`` ``PageZero``); else None."""
        if self.mesh is None or not self.paged_kv or self.data_size == 1:
            return None
        return self.local_pages

    @property
    def vocab(self) -> int:
        """True vocab size for tail masking."""
        return self.model.vocab

    @property
    def encdec(self) -> bool:
        """Whether the model is an EncDec one (it has an ``encode``)."""
        return hasattr(self.model, "encode")

    @property
    def kv_max_pages(self) -> int:
        """Page-table width: the per-slot logical length ceiling in pages."""
        return -(-self.max_len // self.page_size)

    @property
    def kv_num_pages(self) -> int:
        """Pool pages allocated (``kv_pool_pages`` or dense parity)."""
        if self.kv_pool_pages is not None:
            return self.kv_pool_pages
        return self.batch_slots * self.kv_max_pages

    def _cache_kw(self, per_slot: bool) -> dict:
        kw = {"cross_attn_cache": self.cross_attn_cache} if self.encdec else {}
        if self.paged_kv and per_slot:
            kw.update(page_size=self.page_size,
                      num_pages=self.local_pages + (self.page_zero_mirror is not None))
        return kw

    def new_cache(self, *, per_slot: bool = False, batch: Optional[int] = None):
        """A fresh serving cache for this engine's geometry.

        ``per_slot=True`` is the scheduler's cache (a (B,) ``len``; paged when
        ``paged_kv``); the default is the lockstep ``generate()`` cache.
        ``batch`` overrides ``batch_slots`` (slot-targeted prefills).  Under
        a mesh, this data rank's slots and pool block.
        """
        return self.model.init_cache(batch or self.local_slots, self.max_len,
                                     quantized_kv=self.quantized_kv, device=self.device,
                                     per_slot_len=per_slot, **self._cache_kw(per_slot))

    def cache_bytes(self, *, per_slot: bool = False) -> int:
        """Bytes of one serving cache, counted as the reference stores it:
        the K/V slabs or pools (without the pools' spare rows) plus, per
        attention layer, an int32 for each exponent, the length (one per
        slot for the scheduler's ``per_slot`` cache) and, paged, the page
        table; and every recurrent and cross-attention leaf whole.  Under a
        mesh, one rank's: its slots and its block of the pool, with the
        page-0 mirror."""
        from repro_torch.serve.slot_state import (_bytes_where, _is_kv, _is_recurrent,
                                                  _is_xkv)

        slots = self.local_slots
        shapes = self.model.init_cache(slots, self.max_len,
                                       quantized_kv=self.quantized_kv, device="meta",
                                       per_slot_len=per_slot, **self._cache_kw(per_slot))
        kv = _bytes_where(shapes, _is_kv, keys=("k", "v"))
        per_layer_ints = (2 if self.quantized_kv else 0) + (slots if per_slot else 1)
        if self.paged_kv and per_slot:
            per_layer_ints += slots * self.kv_max_pages
        stack = self.model.decoder if self.encdec else self.model.stack
        return (kv + 4 * per_layer_ints * stack.attention_layers
                + _bytes_where(shapes, _is_recurrent)
                + _bytes_where(shapes, _is_xkv))

    def scheduler(self, **kwargs):
        """A continuous-batching :class:`Scheduler` over this engine."""
        from repro_torch.serve.scheduler import Scheduler

        return Scheduler(self, **kwargs)

    def prefill(self, prompts: torch.Tensor, cache, enc: Optional[torch.Tensor] = None):
        """Prompt (B, P) into ``cache`` -> (last-position logits (B, V), cache);
        ``enc`` (B, S_enc, D) for an EncDec model.  Under a mesh, this data
        rank's rows (the layers gather the weights they use)."""
        logits, cache = self.model.apply(self.params, prompts, self._context(), cache=cache,
                                         decode=True, logit_pos=prompts.shape[1] - 1,
                                         **enc_kwargs(enc))
        return logits[:, 0], cache

    def decode(self, token: torch.Tensor, cache, enc: Optional[torch.Tensor] = None):
        """One token (B, 1) per slot -> (logits (B, V), cache); under a mesh
        this data rank's rows."""
        logits, cache = self.model.apply(self.params, token, self._context(), cache=cache,
                                         decode=True, **enc_kwargs(enc))
        return logits[:, -1], cache

    def _context(self) -> Context:
        return Context(mesh=self.mesh, axis_rules=self.axis_rules)

    def data_rows(self) -> slice:
        """This data rank's rows of a whole (``batch_slots``, ...) batch."""
        return slice(self.data_rank * self.local_slots, (self.data_rank + 1) * self.local_slots)

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *, seed: int = 0,
                 enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompts (batch_slots, P) int -> (batch_slots, max_new_tokens) int32.
        An EncDec model needs ``enc``, its encoder output (batch_slots,
        S_enc, D): the lockstep cache carries no cross-attention rows."""
        if self.encdec and enc is None:
            raise ValueError("generate() on an EncDec model needs enc, the encoder output "
                             "(batch_slots, S_enc, D) its decoder cross-attends")
        if isinstance(prompts, torch.Tensor):
            prompts = prompts.to(self.device)
        else:
            prompts = torch.tensor(np.asarray(prompts), device=self.device)
        if enc is not None:
            enc = torch.as_tensor(enc, device=self.device)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is not None:
            return self._generate_mesh(prompts, max_new_tokens, gen)
        logits, cache = self.prefill(prompts, self.new_cache(), enc)
        tok = sample_tokens(logits, gen, self.vocab, self.temperature)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode(tok, cache, enc)
            tok = sample_tokens(logits, gen, self.vocab, self.temperature)
            out.append(tok)
        return torch.cat(out, dim=1)

    def _generate_mesh(self, prompts: torch.Tensor, max_new_tokens: int,
                       gen: Optional[torch.Generator]) -> torch.Tensor:
        """``generate()`` under a mesh: each data rank prefills and decodes
        its rows through the sharded steps, whose sampled tokens reach
        every rank each step (one gather over ``data``); every rank returns
        the whole batch's.  An MoE prefill routes each data rank's rows as
        one group, the reference's rule under a mesh."""
        rows = self.data_rows()
        prefill = make_prefill_step(self.model, mesh=self.mesh, axis_rules=self.axis_rules)
        decode = make_decode_step(self.model, mesh=self.mesh, axis_rules=self.axis_rules,
                                  temperature=self.temperature)
        logits, cache = prefill(self.params, prompts[rows], self.new_cache())
        tok, _ = sample_over_data(logits, self.local_slots, 0, gen, self.vocab,
                                  self.temperature, self.mesh, "data")
        out = [tok]
        for _ in range(max_new_tokens - 1):
            tok, cache = decode(self.params, tok[rows], cache, gen)
            out.append(tok)
        return torch.cat(out, dim=1)
