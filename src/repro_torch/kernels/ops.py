"""Public kernel entry points, dispatched by the device of their tensors
(``repro/kernels/ops.py``).

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, and a kernel that fails to build or launch
raises — nothing falls back.  ``FORCE = "plain"`` runs the plain version
on any device, in-process (how ``chip_smoke.py`` and the tests compare on
the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.qformat import Exponent, QTensor
from repro_torch.kernels import qchunk_attn as _qchunk_attn
from repro_torch.kernels import qdecode_attn as _qdecode_attn
from repro_torch.kernels import ref
from repro_torch.kernels import wq_matmul as _wq_matmul

# None | "plain"
FORCE: Optional[str] = None

_WRAPPERS = {"wq_matmul": _wq_matmul, "qdecode_attn": _qdecode_attn,
             "qchunk_attn": _qchunk_attn}


def _use_kernel(t: torch.Tensor) -> bool:
    if FORCE not in (None, "plain"):
        raise ValueError(f"ops.FORCE={FORCE!r}: expected None or 'plain'")
    return FORCE is None and t.is_cuda


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def wq_matmul(x: torch.Tensor, w: QTensor, *, transpose: bool = False) -> torch.Tensor:
    """x (..., K) float @ dequant(w): the weight-only int8 path.

    ``transpose=True`` gives tied-embedding logits x @ table.T; per-column
    exponents of the (V, D) table would scale K, not N, so that path stays
    dequantize + ``torch.matmul``, as in the reference.
    """
    if transpose:
        return torch.matmul(x, w.dequantize().T.to(x.dtype))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n_out = w.q.shape[-1]
    scale = w.scale.squeeze()
    if _use_kernel(x2):
        y = _wq_matmul.wq_matmul_cuda(x2, w.q, scale.contiguous())
    else:
        y = ref.wq_matmul_ref(x2, w.q, scale)
    return y.reshape(*lead, n_out).to(x.dtype)


def qdecode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_n: Exponent, v_n: Exponent,
                 kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Decode attention over a dense int8 KV cache.

    q (B, Hq, D) f32; caches (B, S, Hkv, D) int8; k_n/v_n scalar pow2
    exponents; kv_len scalar or (B,) live lengths.  Returns (B, Hq, D).
    """
    if _use_kernel(q):
        return _qdecode_attn.qdecode_attn_cuda(q.contiguous(), k_cache, v_cache,
                                               k_n, v_n, kv_len)
    return ref.qdecode_attn_ref(q, k_cache, v_cache, k_n, v_n, kv_len)


def qchunk_attn(q: torch.Tensor, k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, k_n: Exponent, v_n: Exponent,
                slot: int, start: int) -> torch.Tensor:
    """Chunked prefill into one slot of a dense int8 KV cache.

    q (C, Hq, D), k/v chunk (C, Hkv, D) f32; caches (B, S, Hkv, D) int8, whose
    rows [start, start+C) of ``slot`` receive the quantized chunk in place;
    query c attends positions <= start + c.  ``slot``/``start`` are Python
    ints and must keep the chunk inside the cache.  Returns (C, Hq, D).
    """
    if _use_kernel(q):
        return _qchunk_attn.qchunk_attn_cuda(q.contiguous(), k_chunk.contiguous(),
                                             v_chunk.contiguous(), k_cache, v_cache,
                                             k_n, v_n, slot, start)
    return ref.qchunk_attn_ref(q, k_chunk, v_chunk, k_cache, v_cache, k_n, v_n, slot, start)
