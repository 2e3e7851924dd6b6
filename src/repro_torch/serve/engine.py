"""Batched lockstep serving engine (``repro/serve/engine.py``).

``weight_quant`` stores every GEMM and embedding weight as an int8
:class:`QTensor` (the ``wq_matmul`` kernel path); ``quantized_kv`` keeps the
KV cache as int8 on the paper's Qm.n grid (the ``qdecode_attn`` kernel
path).  PyTorch runs eagerly, so the reference's jitted steps are plain
methods here; the cache is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.integerize import integerize_weights_only
from repro_torch.nn.module import Context, resolve_device, tree_leaves, tree_to


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


@dataclasses.dataclass
class ServeEngine:
    """Fixed-slot lockstep generation over a (possibly quantized) model.

    ``device`` defaults to ``cuda`` (see ``resolve_device``); the params are
    moved there and, with ``weight_quant``, integerized there.
    """

    model: Any
    params: Any
    max_len: int
    batch_slots: int
    quantized_kv: bool = False
    weight_quant: Union[bool, str] = False
    temperature: float = 0.0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = tree_to(self.params, self.device)
        if self.weight_quant:
            if self.weight_quant not in (True, "int8"):
                raise NotImplementedError(
                    f"weight_quant={self.weight_quant!r}: the port serves int8 weights "
                    "(True / 'int8'); packed int4/int2 arrive with the sub-int8 slice "
                    "(ROADMAP.md queue 1)")
            self.params = integerize_weights_only(self.params)

    @property
    def vocab(self) -> int:
        """True vocab size for tail masking."""
        return self.model.vocab

    def new_cache(self, *, batch: Optional[int] = None):
        """A fresh lockstep cache for this engine's geometry."""
        return self.model.init_cache(batch or self.batch_slots, self.max_len,
                                     quantized_kv=self.quantized_kv, device=self.device)

    def cache_bytes(self) -> int:
        """Bytes of one serving cache, counted as the reference stores it:
        the K/V slabs plus an int32 per layer for each exponent and length."""
        shapes = self.model.init_cache(self.batch_slots, self.max_len,
                                       quantized_kv=self.quantized_kv, device="meta")
        slab = sum(t.numel() * t.element_size()
                   for t in tree_leaves(shapes) if isinstance(t, torch.Tensor))
        per_layer_scalars = 3 if self.quantized_kv else 1
        return slab + 4 * per_layer_scalars * self.model.stack.n_layers

    def prefill(self, prompts: torch.Tensor, cache):
        """Prompt (B, P) into ``cache`` -> (last-position logits (B, V), cache)."""
        logits, cache = self.model.apply(self.params, prompts, Context(), cache=cache,
                                         decode=True, logit_pos=prompts.shape[1] - 1)
        return logits[:, 0], cache

    def decode(self, token: torch.Tensor, cache):
        """One token (B, 1) per slot -> (logits (B, V), cache)."""
        logits, cache = self.model.apply(self.params, token, Context(), cache=cache,
                                         decode=True)
        return logits[:, -1], cache

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, *, seed: int = 0) -> torch.Tensor:
        """prompts (batch_slots, P) int -> (batch_slots, max_new_tokens) int32."""
        if isinstance(prompts, torch.Tensor):
            prompts = prompts.to(self.device)
        else:
            prompts = torch.tensor(np.asarray(prompts), device=self.device)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.prefill(prompts, self.new_cache())
        tok = sample_tokens(logits, gen, self.vocab, self.temperature)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode(tok, cache)
            tok = sample_tokens(logits, gen, self.vocab, self.temperature)
            out.append(tok)
        return torch.cat(out, dim=1)
