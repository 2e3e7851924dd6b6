"""The gradient all-reduce of data-parallel training, exact or on the
paper's power-of-two Qm.n grid (``repro/dist/compress.py``).

The uniform, symmetric, pow2-scale quantizer the paper deploys on the
Cortex-M (``core/qformat``, Eqs. 1-4) doubles as a gradient codec: every
rank quantizes its local gradient onto a grid *shared* by the group (the
exponent comes from the all-reduce MAX of the ranks' maxima, so all ranks
agree bit for bit), the integer codes are all-reduce-summed (exact:
integers add losslessly) and the mean is dequantized with one shift.

The codes travel as ``qformat.accumulator_dtype(bits)``, int32 at 8 bits,
which both NCCL and gloo carry: 4 bytes an element, the same as float32,
so at 8 bits the codec saves no wire bytes (:func:`wire_bytes`).  What it
gives is the shared pow2 grid and error feedback (Seide et al. 2014;
Karimireddy et al. 2019): the residual each step's quantization dropped is
carried into the next step's gradient, so the cumulative compressed update
tracks the cumulative exact one to within one grid step.

Each function makes two collectives for a whole tree, whatever its number
of leaves: one MAX over the leaves' maxima and one SUM over their codes
laid end to end; each leaf keeps its own grid.  The exponents stay device
tensors, so nothing is read back to the host beyond what a collective
itself needs.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import qformat
from repro_torch.nn.module import tree_leaves, tree_unflatten


def _split_like(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``flat`` cut into views of the shapes of ``like``, in order."""
    parts = torch.split(flat, [t.numel() for t in like])
    return [p.view(t.shape) for p, t in zip(parts, like)]


def _compressed_means(leaves: Sequence[torch.Tensor], errs: Sequence[Optional[torch.Tensor]],
                      group, bits: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    world = dist.get_world_size(group)
    acc_dtype = qformat.accumulator_dtype(bits)
    if world * 2 ** (bits - 1) > torch.iinfo(acc_dtype).max:
        raise ValueError(f"{world} ranks of {bits}-bit codes overflow {acc_dtype}")
    vs = [g + (torch.zeros_like(g) if e is None else e) for g, e in zip(leaves, errs)]
    # the shared grid: every rank reads its exponent from the group's max
    ma = torch.stack([torch.amax(torch.abs(v)) for v in vs]).to(torch.float32)
    dist.all_reduce(ma, op=dist.ReduceOp.MAX, group=group)
    n = qformat.frac_bits_for(ma, bits)
    codes, new_errs = [], []
    for i, (g, v) in enumerate(zip(leaves, vs)):
        q = qformat.quantize(v, n[i], bits)
        new_errs.append((v - qformat.dequantize(q, n[i])).to(g.dtype))
        codes.append(q.reshape(-1).to(acc_dtype))
    acc = torch.cat(codes)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    means = [(qformat.dequantize(a, n[i]) / world).to(g.dtype)
             for i, (g, a) in enumerate(zip(leaves, _split_like(acc, leaves)))]
    return means, new_errs


def compressed_psum_mean(g: torch.Tensor, group=None, *, bits: int = 8,
                         error: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` over ``group`` (the default group if None) through a
    ``bits``-wide integer all-reduce.  ``error`` is this rank's
    error-feedback residual for the leaf (zeros on the first step).
    Returns ``(mean, new_error)``, ``new_error`` exactly what quantization
    dropped this step."""
    means, errs = _compressed_means([g], [error], group, bits)
    return means[0], errs[0]


def compressed_grad_allreduce(grads: Any, group=None, *, bits: int = 8,
                              error_state: Optional[Any] = None) -> Tuple[Any, Any]:
    """Tree-wise :func:`compressed_psum_mean`: each leaf its own Qm.n grid
    (per-tensor exponents, the paper's per-layer granularity applied to
    gradients) and its own error-feedback slot, in :func:`tree_leaves`
    order.  Returns ``(mean_tree, new_error_tree)``; ``error_state=None``
    starts the feedback at zero."""
    leaves = tree_leaves(grads)
    if error_state is None:
        errs = [None] * len(leaves)
    else:
        errs = tree_leaves(error_state)
        if len(errs) != len(leaves):
            raise ValueError("error_state must mirror grads")
    means, new_errs = _compressed_means(leaves, errs, group, bits)
    return tree_unflatten(grads, means), tree_unflatten(grads, new_errs)


def grad_allreduce_mean(grads: Any, group=None) -> Any:
    """The exact mean of a float tree over ``group``: one SUM over the
    leaves laid end to end, then a division by the world size (the
    reference's ``pmean``)."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / dist.get_world_size(group)
    return tree_unflatten(grads, [a.to(g.dtype) for g, a in zip(leaves, _split_like(flat, leaves))])


def wire_bytes(grads: Any, bits: int = 0) -> int:
    """Bytes each rank hands the all-reduce for ``grads`` in one call:
    float32 values when ``bits`` is 0, else the leaves' float32 maxima and
    their codes in ``accumulator_dtype(bits)``."""
    leaves = tree_leaves(grads)
    numel = sum(t.numel() for t in leaves)
    if not bits:
        return 4 * numel
    return 4 * len(leaves) + qformat.accumulator_dtype(bits).itemsize * numel
