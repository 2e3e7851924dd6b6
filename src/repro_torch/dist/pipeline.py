"""GPipe pipeline parallelism over point-to-point sends
(``repro/dist/pipeline.py``).

A mesh axis (``pod`` by default) serves as the stage axis: rank *s* of the
axis holds stage *s*'s slice of the stacked parameters, and microbatches
flow stage to stage.  The schedule is GPipe's fill/steady/drain: with M
microbatches and S stages it runs M + S - 1 ticks; in each tick every rank
applies its stage to the microbatch in flight and sends the activation to
its successor, so the bubble is (S - 1) / (M + S - 1) of the ticks.

Each microbatch meets the same operations in the same order as in the
sequential composition of the stages, so the output equals it bit for
bit.  The last stage's outputs reach every rank by a broadcast.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.dist import axis_group
from repro_torch.nn.module import tree_map


def make_pipelined_fn(stage_fn: Callable, mesh, *, axis_name: str = "pod") -> Callable:
    """Build ``run(stage_params, x) -> y`` executing ``stage_fn`` as a
    pipeline over ``mesh[axis_name]``.

    ``stage_fn(params_s, x_mb)`` applies one stage to one microbatch.
    ``stage_params`` is a tree whose leaves are stacked ``(n_stages, ...)``
    (each rank reads its own index); ``x`` is ``(n_micro, microbatch,
    ...)`` and the same on every rank.  The output has ``x``'s shape, every
    stage applied in order to every microbatch, on every rank.
    """
    group = axis_group(mesh, axis_name)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    prev_rank = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    next_rank = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
    last_rank = dist.get_global_rank(group, n_stages - 1)

    def run(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        w = tree_map(lambda leaf: leaf[stage], stage_params)
        n_micro = x.shape[0]
        outputs = torch.zeros_like(x)
        inflight = None
        for t in range(n_micro + n_stages - 1):
            # stage s works on microbatch t - s while 0 <= t - s < n_micro
            mb = t - stage
            ops = []
            if next_rank is not None and inflight is not None:
                ops.append(dist.P2POp(dist.isend, inflight, next_rank, group))
            recv = None
            if prev_rank is not None and 0 <= mb < n_micro:
                recv = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, recv, prev_rank, group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            inflight = None
            if 0 <= mb < n_micro:
                y = stage_fn(w, x[mb] if stage == 0 else recv)
                if stage == n_stages - 1:
                    outputs[mb] = y
                else:
                    inflight = y
        dist.broadcast(outputs, src=last_rank, group=group)
        return outputs

    return run
