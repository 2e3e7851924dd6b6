"""ArchConfig: declarative architecture -> model (``repro/configs/base.py``).

The port builds the dense attention family: layout ``"a"`` with a gated
FFN, RMSNorm or LayerNorm, the sequential or the parallel (command-r) block,
a tied or an untied LM head, and a vision prefix of ``vis_seq`` stub patch
embeddings (internvl).  Other layouts and FFN kinds (recurrent mixers, MoE,
EncDec) wait for later slices.  ``smoke()`` derives the same reduced config
as the reference, so converted JAX parameters fit it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import CausalLM
from repro_torch.nn.transformer import Block, Stack


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | vlm (others wait for later slices)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    layout: str = "a"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm: str = "rms"              # rms | ln
    parallel_block: bool = False   # command-r: x + attn(norm(x)) + ffn(norm(x))
    activation: str = "silu"
    ffn_kind: str = "gated"
    tie_embeddings: bool = True
    vis_seq: int = 0               # stub vision-prefix length (vlm)
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    def build(self) -> CausalLM:
        """The float32 CausalLM of this config."""
        if self.layout != "a" or self.ffn_kind != "gated":
            raise NotImplementedError(
                f"{self.arch_id}: layout {self.layout!r} / ffn {self.ffn_kind!r} arrive "
                "with later slices of the port (ROADMAP.md queue 1)")
        if self.norm not in ("rms", "ln"):
            raise ValueError(f"{self.arch_id}: norm {self.norm!r}")
        block = Block(d_model=self.d_model, n_heads=self.n_heads,
                      n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                      d_ff=self.d_ff, qkv_bias=self.qkv_bias,
                      rope_theta=self.rope_theta, use_rope=self.use_rope,
                      activation=self.activation, norm=self.norm,
                      parallel=self.parallel_block)
        return CausalLM(vocab=self.vocab, vocab_padded=self.vocab_padded,
                        d_model=self.d_model,
                        stack=Stack(body=(block,), n_periods=self.n_layers),
                        norm=self.norm, tie_embeddings=self.tie_embeddings)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's sizes)."""
        n_heads = 4
        n_kv = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else n_heads
        return dataclasses.replace(
            self, arch_id=self.arch_id + "-smoke",
            n_layers=len(self.layout) * (2 if len(self.layout) == 1 else 1),
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
            d_ff=128, vocab=503, vis_seq=min(self.vis_seq, 8) if self.vis_seq else 0)

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included, true vocab;
        norms and biases left out), the reference's formula for the dense
        attention layout."""
        d, f = self.d_model, self.d_ff
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        qd, kvd = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        per_layer = d * (qd + 2 * kvd) + qd * d + (3 if self.ffn_kind == "gated" else 2) * d * f
        return total + self.n_layers * per_layer
