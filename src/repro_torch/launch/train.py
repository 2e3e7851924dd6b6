"""Training entry point of the port, with fault tolerance
(``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m-smoke \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--qat] [--device cpu]

* restart from the latest checkpoint: the launcher always tries to restore
  before training, so a killed run re-launched with the same flags resumes;
* atomic asynchronous checkpoints every --ckpt-every steps;
* deterministic data: a batch is a pure function of (seed, step);
* a straggler watchdog: a step slower than --straggler-factor x the running
  median is logged;
* the metrics are read back once per step, after it, for the log line;
* distribution: ``--mesh D,M`` under ``torchrun --nproc-per-node D*M``
  (``--standalone`` on one host) forms the group (gloo with ``--device
  cpu``, nccl on cards, or ``--backend``) and builds the ``(data, model)``
  mesh; every rank reads the same global batch and takes its slice, rank 0
  alone logs and writes checkpoints.  ``--mesh D,1`` keeps every parameter
  whole on each rank (the data mesh); with M > 1 the parameters and the
  optimizer moments are sharded by ``dist.sharding``'s rules over
  ``data`` (FSDP) and ``model`` (tensor and expert parallel).  Elastic
  restore: a checkpoint holds whole leaves (gathered before rank 0
  writes), so a run may resume under another ``--mesh``;

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-135m-smoke --mesh 2,2 --device cpu --steps 20

Several ranks may share one card over gloo (``--backend gloo``), whose
CUDA collectives are all-reduces: the sharded step's gathers are then
all-reduces of zero-filled buffers (``dist/shard_ops.py``).  Runs on the
GPU unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.policy import QuantPolicy
from repro_torch.data.pipeline import DataPipeline, markov_batch_fn
from repro_torch.dist import shard_ops, sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.models.registry import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.optim import adamw, multistep_lr, sgd
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (init_train_state, make_train_step, meta_state,
                                      shard_state, state_pspecs)


def main(argv=None, on_step: Optional[Callable[[int, dict, float], None]] = None):
    """Train; returns the final state.  ``on_step(step, metrics, seconds)``
    gets each step's metrics as Python floats and its wall time, after the
    step's checkpoint (if any) has started."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--qat", action="store_true", help="int8 QAT (paper 4.3)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="1,1", help="data,model")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--backend", default=None, choices=meshlib.BACKENDS,
                    help="process-group backend under torchrun (default: nccl on cards, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)

    dm, tp = (int(x) for x in args.mesh.split(","))
    distributed = meshlib.launched()
    if dm * tp > 1 and not distributed:
        raise SystemExit(f"--mesh {args.mesh}: start {dm * tp} ranks with torchrun "
                         f"--standalone --nproc-per-node {dm * tp} -m repro_torch.launch.train")
    device = resolve_device(args.device)
    mesh, own_group = None, False
    if distributed:
        # a rank script may have formed the group already; main then uses it
        if not dist.is_initialized():
            meshlib.init_process_group(device, args.backend)
            own_group = True
        backend = dist.get_backend()
        if args.backend and backend != args.backend:
            raise SystemExit(f"--backend {args.backend}: the group is up on {backend}")
        if dist.get_world_size() != dm * tp:
            raise SystemExit(f"--mesh {args.mesh}: the world has {dist.get_world_size()} ranks")
        mesh = meshlib.make_host_mesh(dm, tp, device)
        if dist.get_rank() == 0:
            print(f"[dist] backend {backend}, world {dist.get_world_size()}, mesh "
                  f"{args.mesh}" + (f", parameters sharded, collectives in the "
                                    f"{shard_ops.form(mesh, device)} form" if tp > 1 else ""),
                  flush=True)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    try:
        return _train(args, device, mesh, on_step)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device, mesh, on_step):
    leader = not dist.is_initialized() or dist.get_rank() == 0
    cfg = get_config(args.arch)
    # every layer recomputed in the backward, as the reference's launch.train builds
    model = cfg.build(remat="none")
    optimizer = (adamw(weight_decay=0.01) if args.optimizer == "adamw"
                 else sgd(momentum=0.9, weight_decay=5e-4))
    schedule = multistep_lr(args.lr, milestones=(args.steps * 2 // 3, args.steps * 5 // 6))
    policy = QuantPolicy.int8_qat() if args.qat else QuantPolicy.float32()
    # a model axis shards the parameters by the rules; a data mesh keeps them whole
    rules = sharding.make_axis_rules(mesh) if mesh is not None and \
        sharding.mesh_shape(mesh)["model"] > 1 else None
    step_fn = make_train_step(model, optimizer, schedule, policy=policy, mesh=mesh,
                              axis_rules=rules, microbatch_split=args.microbatch)
    pipe = DataPipeline(markov_batch_fn(cfg.vocab, args.batch, args.seq, seed=args.seed))
    state = init_train_state(model, optimizer,
                             torch.Generator(device=device).manual_seed(args.seed), device)
    layout = {}
    if rules is not None:
        state = shard_state(state, mesh, rules)
        layout = {"specs": state_pspecs(meta_state(model, optimizer), mesh, rules),
                  "mesh": mesh}

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state, **layout)
            pipe.restore({"step": latest})
            if leader:
                print(f"[restore] resumed from step {latest}")

    times = []
    try:
        for step in range(int(state["step"]), args.steps):
            batch = next(pipe)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            metrics = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) > 20:
                times.pop(0)
            med = statistics.median(times)
            if leader and dt > args.straggler_factor * med and len(times) > 5:
                print(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s")
            if leader and (step % args.log_every == 0 or step == args.steps - 1):
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"acc {metrics['accuracy']:.3f} lr {metrics['lr']:.2e} "
                      f"{dt * 1e3:.0f}ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, state, **layout)
            if on_step is not None:
                on_step(step, metrics, dt)
        if ckpt:
            ckpt.save(args.steps, state, **layout)
    finally:
        if ckpt:
            ckpt.close()
    if leader:
        print("done")
    return state


if __name__ == "__main__":
    main()
