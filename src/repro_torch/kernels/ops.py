"""Public kernel entry points, dispatched by the device of their tensors
(``repro/kernels/ops.py``).

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, and a kernel that fails to build or launch
raises — nothing falls back.  ``FORCE`` overrides that in-process:
``"plain"`` runs the plain version on any device (how ``chip_smoke.py`` and
the tests compare on the card), ``"kernel"`` refuses CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.qformat import Exponent, QTensor
from repro_torch.kernels import qdecode_attn as _qdecode_attn
from repro_torch.kernels import ref
from repro_torch.kernels import wq_matmul as _wq_matmul

# None | "kernel" | "plain"
FORCE: Optional[str] = None

_WRAPPERS = {"wq_matmul": _wq_matmul, "qdecode_attn": _qdecode_attn}


def _use_kernel(t: torch.Tensor) -> bool:
    if FORCE not in (None, "kernel", "plain"):
        raise ValueError(f"ops.FORCE={FORCE!r}: expected None, 'kernel' or 'plain'")
    if FORCE == "plain":
        return False
    if t.is_cuda:
        return True
    if FORCE == "kernel":
        raise RuntimeError("ops.FORCE='kernel' needs CUDA tensors")
    return False


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
