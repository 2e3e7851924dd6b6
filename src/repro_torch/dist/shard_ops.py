"""The collectives of the sharded execution, as autograd functions.

The reference never writes these: XLA's SPMD partitioner inserts them from
the sharding rules.  The port runs one process a rank over
``torch.distributed`` and states them where the layers need them:

* :func:`gather_fsdp`: the all-gather of a weight dim over ``data`` (FSDP);
  its backward is the reduce-scatter (sum) of the gradient, so each rank
  gets its own rows of the gradient summed over the data ranks' batches;
* :func:`gather_replicated`: the all-gather of a dim over an axis whose
  ranks then compute the same thing (the columns of a column-parallel
  product over ``model``, an expert stack's outputs, a table used whole);
  its backward keeps this rank's own block of the gradient;
* :func:`copy_in`: the identity, whose backward all-reduces over ``model``
  (Megatron's ``f``): a replicated activation that each ``model`` rank
  uses for its own block of columns or experts;
* :func:`psum`: an all-reduce (sum), whose backward is the identity;
* :func:`pmax`: an all-reduce (max) of a statistic, no gradient;
* :func:`gather_host`: a serving tick's host-bound values of every data
  rank, in one call;
* :func:`broadcast`: one rank's tensor onto every rank of an axis, in
  place (the serving pool's page-0 mirror).

Every call is counted by (axis, kind) with the bytes this rank hands the
collective (:func:`collective_counts`, as ``ops.launch_counts``), backward
calls included.  :func:`time_collectives` also times each call (or each
of some kinds) on the host's clock between two device synchronizations
(:func:`collective_ms`): a measurement that stalls the stream, off by
default.

Two forms: NCCL, and gloo on the CPU, run ``all_gather_into_tensor`` and
``reduce_scatter_tensor``.  gloo carries only ``broadcast`` and
``all_reduce`` for CUDA tensors, so there (several ranks sharing one card)
a gather is an all-reduce of a zero-filled buffer that holds this rank's
block, and a reduce-scatter is an all-reduce and a slice.  :func:`form`
names the form of a mesh on a device; it is fixed by the backend the group
formed on and nothing switches it after a failure.  The gather's buffer
is summed as int32 words where its bytes allow (one rank's bits plus
zeros: every bit pattern, -0.0 and NaN included, arrives exact); an odd
number of int8 or 16-bit bytes sums in its own type, where a float -0.0
would arrive as +0.0.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_COUNTS: Dict[Tuple[str, str], list] = {}
_TIMED: Optional[Tuple[str, ...]] = None      # the kinds timed; () every kind


def collective_counts() -> Dict[Tuple[str, str], Tuple[int, int]]:
    """``{(axis, kind): (calls, bytes)}`` since :func:`reset_collective_counts`;
    bytes are what this rank handed the collectives."""
    return {k: (v[0], v[1]) for k, v in _COUNTS.items()}


def collective_ms() -> Dict[Tuple[str, str], float]:
    """``{(axis, kind): ms}`` of the calls made while timing was on."""
    return {k: v[2] for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def time_collectives(on: bool, kinds: Optional[Sequence[str]] = None) -> None:
    """Time every collective (two device synchronizations each), or only
    those of ``kinds``, or none."""
    global _TIMED
    _TIMED = (tuple(kinds) if kinds else ()) if on else None


@contextlib.contextmanager
def _counted(axis: str, kind: str, t: torch.Tensor):
    c = _COUNTS.setdefault((axis, kind), [0, 0, 0.0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()
    if _TIMED is None or (_TIMED and kind not in _TIMED):
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    c[2] += (time.perf_counter() - t0) * 1e3


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on a ``DeviceMesh`` (1 when it has none)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def form(mesh, device) -> str:
    """``"native"`` (all-gather and reduce-scatter collectives) or
    ``"all_reduce"`` (gloo on a card: both made of all-reduces)."""
    return ("all_reduce" if torch.device(device).type == "cuda"
            and dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0])) == "gloo"
            else "native")


def _sum_form(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, dim: int, mesh, axis: str, kind: str = "gather"):
    """The blocks of ``x`` of every rank along ``axis`` joined along ``dim``
    in rank order (no gradient)."""
    world = axis_size(mesh, axis)
    if world == 1:
        return x
    group = mesh.get_group(axis)
    dim = dim % x.ndim
    xt = x.detach().movedim(dim, 0).contiguous()
    if _sum_form(xt, group):
        buf = torch.zeros((world,) + tuple(xt.shape), dtype=xt.dtype, device=xt.device)
        buf[axis_index(mesh, axis)] = xt
        words = buf.view(-1).view(torch.int32) \
            if buf.numel() * buf.element_size() % 4 == 0 else buf
        with _counted(axis, kind, words):
            dist.all_reduce(words, group=group)
        out = buf.reshape((world * xt.shape[0],) + tuple(xt.shape[1:]))
    else:
        out = torch.empty((world * xt.shape[0],) + tuple(xt.shape[1:]), dtype=xt.dtype,
                          device=xt.device)
        with _counted(axis, kind, xt):
            dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def gather_host(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """(R, ...) of this rank -> (world, R, ...) of every rank of ``axis``,
    in rank order, counted as kind ``"host"``: what the serving host reads
    each tick under a data split (the sampled tokens and a finished chunk's
    first token, or the logit rows they are drawn from), in one call, so
    every rank takes the same host decisions.  A gloo call costs
    milliseconds whatever its size, so a tick makes one."""
    return all_gather(x[None], 0, mesh, axis, kind="host")


def broadcast(x: torch.Tensor, mesh, axis: str, kind: str = "broadcast"):
    """``x`` of the first rank along ``axis`` written into ``x`` of every
    rank of it (no gradient), as int32 words where its bytes allow (every
    bit pattern arrives as it was); returns ``x``."""
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    words = x.view(-1).view(torch.int32) \
        if x.is_contiguous() and x.numel() * x.element_size() % 4 == 0 else x
    with _counted(axis, kind, words):
        dist.broadcast(words, src=dist.get_global_rank(group, 0), group=group)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axis: str, kind: str = "reduce_scatter"):
    """The sum of ``x`` over ``axis``, cut along ``dim``: this rank's block
    (no gradient)."""
    world = axis_size(mesh, axis)
    if world == 1:
        return x
    group = mesh.get_group(axis)
    dim = dim % x.ndim
    xt = x.detach().movedim(dim, 0).contiguous()
    part = xt.shape[0] // world
    if _sum_form(xt, group):
        xt = xt.clone() if xt.data_ptr() == x.data_ptr() else xt   # never the caller's
        with _counted(axis, kind, xt):
            dist.all_reduce(xt, group=group)
        out = xt[axis_index(mesh, axis) * part:(axis_index(mesh, axis) + 1) * part]
    else:
        out = torch.empty((part,) + tuple(xt.shape[1:]), dtype=xt.dtype, device=xt.device)
        with _counted(axis, kind, xt):
            dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM,
               kind: str = "all_reduce") -> torch.Tensor:
    """``x`` reduced over ``axis`` (a new tensor, no gradient)."""
    if axis_size(mesh, axis) == 1:
        return x
    out = x.detach().clone()
    with _counted(axis, kind, out):
        dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def own_block(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's block of a dim that is whole on every rank of ``axis``."""
    world = axis_size(mesh, axis)
    if world == 1:
        return x
    size = x.shape[dim] // world
    return x.narrow(dim, axis_index(mesh, axis) * size, size)


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return reduce_scatter(g, dim, mesh, axis, kind="reduce_scatter"), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return own_block(g, dim, mesh, axis).contiguous(), None, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce(g, mesh, axis, kind="copy_in"), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis, kind="psum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_fsdp(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """All-gather ``dim`` over ``axis``; reduce-scatter (sum) backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherFSDP.apply(x, dim, mesh, axis)


def gather_replicated(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """All-gather ``dim`` over ``axis``; this rank's block of the gradient
    backward (every rank of ``axis`` computes the same downstream)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherReplicated.apply(x, dim, mesh, axis)


def copy_in(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The identity; all-reduce (sum) of the gradient over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyIn.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce (sum) over ``axis``; the identity backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Psum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The max of a statistic over every axis of ``axes`` (no gradient)."""
    x = x.detach()
    for a in axes:
        x = all_reduce(x, mesh, a, op=dist.ReduceOp.MAX, kind="pmax")
    return x
