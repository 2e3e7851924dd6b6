"""ArchConfig: declarative architecture -> model (``repro/configs/base.py``).

The port builds the dense attention family (layout ``"a"`` with a gated
FFN, RMSNorm or LayerNorm, the sequential or the parallel (command-r) block,
a tied or an untied LM head, and a vision prefix of ``vis_seq`` stub patch
embeddings: internvl) and the recurrent family: a layout over ``"m"``
(Mamba) and ``"r"`` (RWKV-6 time-mix, with ``ffn_kind="rwkv"``, the RWKV-6
channel-mix).  The layout is a period string repeated ``n_layers /
len(layout)`` times.  A config with ``enc_layers`` builds an
:class:`~repro_torch.models.lm.EncDecLM` (whisper): a non-causal encoder
stack and a causal decoder stack with cross-attention, both with the
classic MLP FFN.  MoE: ``moe_every=k, moe_offset=o`` puts an
:class:`~repro_torch.nn.moe.MoE` FFN at the global layers i >= ``first_k_dense``
with i = o (mod k) (phi3.5-moe every layer, jamba every other one over its
``"mmmammmm"`` Mamba/attention period); the ``first_k_dense`` leading dense
layers (kimi-k2, with its own ``d_ff_dense``) form the stack's unstacked
``prelude``.  ``smoke()`` derives the same reduced config as the reference,
so converted JAX parameters fit it.

``SHAPES`` are the reference's four cells (``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``); :meth:`ArchConfig.supports` says which an
arch runs and :meth:`ArchConfig.input_specs` gives the cell's inputs as
``meta`` tensors (no storage), the port's dtypes: float32 embeddings and a
float32 decode cache, where the reference's dry run takes bf16.
``build(remat=)`` takes the reference's activation rematerialization
policies (``nn/transformer.py`` ``REMAT_POLICIES``; ``"full"`` by default).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.lm import CausalLM, EncDecLM
from repro_torch.nn.transformer import Block, Stack


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the reference's cells: every LM arch is paired with these four
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# families with sub-quadratic decode state run long_500k; pure
# full-attention archs skip it
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")

# the decoder's learned position table: the reference sizes it by
# SHAPES["decode_32k"].seq_len
MAX_TARGET_LEN = SHAPES["decode_32k"].seq_len


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    layout: str = "a"              # period string over {a, m, r}
    n_experts: int = 0             # MoE
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 0             # 0 = no MoE
    moe_offset: int = 0
    first_k_dense: int = 0         # leading dense layers, the unstacked prelude
    d_ff_dense: int = 0            # dense-FFN width where it differs (kimi)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm: str = "rms"              # rms | ln
    parallel_block: bool = False   # command-r: x + attn(norm(x)) + ffn(norm(x))
    activation: str = "silu"
    ffn_kind: str = "gated"        # gated | mlp | rwkv
    tie_embeddings: bool = True
    enc_layers: int = 0            # enc-dec (audio): encoder depth
    enc_seq: int = 1500            # stub frontend output length (whisper frames)
    vis_seq: int = 0               # stub vision-prefix length (vlm)
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def supports(self, shape_name: str) -> bool:
        """Whether this arch runs the cell: ``long_500k`` only for the
        sub-quadratic families."""
        if shape_name == "long_500k":
            return self.family in LONG_CONTEXT_FAMILIES
        return shape_name in SHAPES

    def _is_moe(self, layer_idx: int) -> bool:
        return (self.moe_every > 0 and layer_idx >= self.first_k_dense
                and layer_idx % self.moe_every == self.moe_offset)

    def _block(self, layer_idx: int, mixer_ch: str) -> Block:
        """Global layer ``layer_idx``'s block: an MoE FFN of ``d_ff`` experts
        where :meth:`_is_moe`, else the config's FFN at ``d_ff_dense`` (or
        ``d_ff``)."""
        moe = self._is_moe(layer_idx)
        return Block(d_model=self.d_model, n_heads=self.n_heads,
                     n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                     d_ff=self.d_ff if moe else (self.d_ff_dense or self.d_ff),
                     qkv_bias=self.qkv_bias,
                     rope_theta=self.rope_theta, use_rope=self.use_rope,
                     activation=self.activation, norm=self.norm,
                     parallel=self.parallel_block, mixer=_MIXERS[mixer_ch],
                     ffn="moe" if moe else self.ffn_kind, n_experts=self.n_experts,
                     top_k=self.top_k, n_shared_experts=self.n_shared_experts)

    def build(self, *, remat: str = "full"):
        """The float32 model of this config: an ``EncDecLM`` when it has
        ``enc_layers``, else a ``CausalLM``; its stacks' layers
        rematerialized under ``remat`` (``off``, ``none``, ``dots`` or
        ``full``) in a backward."""
        if self.norm not in ("rms", "ln"):
            raise ValueError(f"{self.arch_id}: norm {self.norm!r}")
        if self.is_encdec:
            return self._build_encdec(remat)
        return CausalLM(vocab=self.vocab, vocab_padded=self.vocab_padded,
                        d_model=self.d_model, stack=self._stack(remat),
                        norm=self.norm, tie_embeddings=self.tie_embeddings)

    def _stack(self, remat: str) -> Stack:
        """The ``first_k_dense`` prelude blocks, then the layout's period
        repeated over the remaining layers (``repro/configs/base.py``); the
        prelude runs without rematerialization, as the reference's does."""
        period = len(self.layout)
        if (self.n_layers - self.first_k_dense) % period:
            raise ValueError(f"{self.arch_id}: {self.n_layers - self.first_k_dense} layers "
                             f"do not repeat the {period}-layer period {self.layout!r}")
        prelude = Stack(body=tuple(self._block(i, self.layout[i % period])
                                   for i in range(self.first_k_dense)),
                        n_periods=1, layer_scope="pre", remat="off") \
            if self.first_k_dense else None
        body = tuple(self._block(self.first_k_dense + p, self.layout[p])
                     for p in range(period))
        return Stack(body=body, n_periods=(self.n_layers - self.first_k_dense) // period,
                     prelude=prelude, remat=remat)

    def _build_encdec(self, remat: str) -> EncDecLM:
        """Whisper's pair of stacks: a non-causal encoder block and a causal
        decoder block with cross-attention, RoPE off and the GELU MLP in
        both (``repro/configs/base.py`` ``build``)."""
        kw = dict(d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                  head_dim=self.head_dim, d_ff=self.d_ff, use_rope=False, ffn="mlp",
                  activation="gelu", norm=self.norm)
        return EncDecLM(vocab=self.vocab, vocab_padded=self.vocab_padded,
                        d_model=self.d_model,
                        encoder=Stack(body=(Block(causal=False, **kw),),
                                      n_periods=self.enc_layers, remat=remat),
                        decoder=Stack(body=(Block(causal=True, cross=True, **kw),),
                                      n_periods=self.n_layers, remat=remat),
                        max_target_len=MAX_TARGET_LEN, norm=self.norm, enc_len=self.enc_seq)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's sizes)."""
        n_heads = 4
        n_kv = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else n_heads
        period = len(self.layout)
        return dataclasses.replace(
            self, arch_id=self.arch_id + "-smoke",
            n_layers=self.first_k_dense + period * (2 if period == 1 else 1),
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
            d_ff=128, d_ff_dense=128 if self.d_ff_dense else 0, vocab=503,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            vis_seq=min(self.vis_seq, 8) if self.vis_seq else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=16 if self.enc_layers else self.enc_seq)

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included, true vocab;
        norms, biases and the recurrent mixers' small leaves left out), the
        reference's formula."""
        d, f = self.d_model, self.d_ff
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        period = len(self.layout)
        for i in range(self.n_layers):
            ch = self.layout[(i - self.first_k_dense) % period] \
                if i >= self.first_k_dense else self.layout[i % period]
            if ch == "a":
                qd, kvd = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
                total += d * (qd + 2 * kvd) + qd * d
            elif ch == "m":
                di, dtr = 2 * d, max(1, math.ceil(d / 16))
                total += d * 2 * di + di * (dtr + 32) + dtr * di + di * d
            elif ch == "r":
                total += 5 * d * d
            if self._is_moe(i):
                total += (self.n_experts + self.n_shared_experts) * 3 * d * f
            elif ch == "r":
                total += 2 * d * f + d * d
            else:
                total += (3 if self.ffn_kind == "gated" else 2) * d * (self.d_ff_dense or f)
        if self.is_encdec:
            total += self.enc_layers * (4 * d * d + 2 * d * f)
        return total

    def active_param_count(self) -> int:
        """Parameters a token runs through: an MoE layer's ``top_k`` (and
        shared) experts of its ``n_experts``, the reference's formula."""
        if not self.moe_every:
            return self.param_count()
        moe_layers = sum(self._is_moe(i) for i in range(self.n_layers))
        return self.param_count() - moe_layers * (self.n_experts - self.top_k) * 3 \
            * self.d_model * self.d_ff

    def input_specs(self, shape_name: str) -> Dict[str, Any]:
        """The cell's model inputs as ``meta`` tensors (the reference's
        ``ShapeDtypeStruct`` stand-ins, in the port's dtypes).

        train:   tokens/labels (B, S) int32 (+ a float32 embeds stub for
                 audio and vlm, whose prefix shortens a vlm's tokens)
        prefill: tokens (B, S) (+ the embeds stub)
        decode:  tokens (B, 1) + the float32 KV/state cache sized for S
                 (+ the encoder output ``enc`` of an EncDec arch)
        """
        sh = SHAPES[shape_name]
        if not self.supports(shape_name):
            raise ValueError(f"{self.arch_id} skips {shape_name}")
        b, s = sh.global_batch, sh.seq_len

        def ints(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        def floats(*shape):
            return torch.empty(shape, dtype=torch.float32, device="meta")

        if sh.kind == "train":
            if self.is_encdec:
                return {"embeds": floats(b, self.enc_seq, self.d_model),
                        "tokens": ints(b, s), "labels": ints(b, s)}
            if self.vis_seq:
                return {"embeds": floats(b, self.vis_seq, self.d_model),
                        "tokens": ints(b, s - self.vis_seq),
                        "labels": ints(b, s - self.vis_seq)}
            return {"tokens": ints(b, s), "labels": ints(b, s)}
        if sh.kind == "prefill":
            out = {"tokens": ints(b, s)}
            if self.is_encdec:
                out["embeds"] = floats(b, self.enc_seq, self.d_model)
            if self.vis_seq:
                out["embeds"] = floats(b, self.vis_seq, self.d_model)
                out["tokens"] = ints(b, s - self.vis_seq)
            return out
        # decode: one new token against an S-token cache
        out = {"tokens": ints(b, 1),
               "cache": self.build().init_cache(b, s, quantized_kv=False, device="meta")}
        if self.is_encdec:
            out["enc"] = floats(b, self.enc_seq, self.d_model)
        return out


_MIXERS = {"a": "attn", "m": "mamba", "r": "rwkv"}
