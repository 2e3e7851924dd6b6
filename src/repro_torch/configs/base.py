"""ArchConfig: declarative architecture -> model (``repro/configs/base.py``).

The port builds the dense attention family so far: layout ``"a"``, RMSNorm,
gated FFN, no MoE.  ``smoke()`` derives the same reduced config as the
reference, so converted JAX parameters fit it.
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
    norm: str = "rms"
    activation: str = "silu"
    ffn_kind: str = "gated"
    tie_embeddings: bool = True

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    def build(self) -> CausalLM:
        """The float32 CausalLM of this config."""
        if (self.layout, self.norm, self.ffn_kind, self.tie_embeddings) != \
                ("a", "rms", "gated", True):
            raise NotImplementedError(
                f"{self.arch_id}: layout {self.layout!r} / norm {self.norm!r} / ffn "
                f"{self.ffn_kind!r} / untied head arrive with later slices of the port")
        block = Block(d_model=self.d_model, n_heads=self.n_heads,
                      n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                      d_ff=self.d_ff, qkv_bias=self.qkv_bias,
                      rope_theta=self.rope_theta, use_rope=self.use_rope,
                      activation=self.activation)
        return CausalLM(vocab=self.vocab, vocab_padded=self.vocab_padded,
                        d_model=self.d_model,
                        stack=Stack(body=(block,), n_periods=self.n_layers))

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU tests (the reference's sizes)."""
        n_heads = 4
        n_kv = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else n_heads
        return dataclasses.replace(
            self, arch_id=self.arch_id + "-smoke",
            n_layers=len(self.layout) * (2 if len(self.layout) == 1 else 1),
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
            d_ff=128, vocab=503)
