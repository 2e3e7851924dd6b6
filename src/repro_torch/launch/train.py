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
* the metrics are read back once per step, after it, for the log line.

Runs on the GPU unless --device says otherwise.  ``--mesh`` other than
``1,1`` (data x model parallelism) waits for the port's distribution slice.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.data.pipeline import DataPipeline, markov_batch_fn
from repro_torch.models.registry import get_config
from repro_torch.nn.module import resolve_device
from repro_torch.optim import adamw, multistep_lr, sgd
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import init_train_state, make_train_step


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
    args = ap.parse_args(argv)

    if tuple(int(x) for x in args.mesh.split(",")) != (1, 1):
        raise SystemExit(f"--mesh {args.mesh}: data and model parallelism wait for the "
                         "port's distribution slice (ROADMAP.md queue 1); use --mesh 1,1")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = cfg.build()
    optimizer = (adamw(weight_decay=0.01) if args.optimizer == "adamw"
                 else sgd(momentum=0.9, weight_decay=5e-4))
    schedule = multistep_lr(args.lr, milestones=(args.steps * 2 // 3, args.steps * 5 // 6))
    policy = QuantPolicy.int8_qat() if args.qat else QuantPolicy.float32()
    step_fn = make_train_step(model, optimizer, schedule, policy=policy,
                              microbatch_split=args.microbatch)
    pipe = DataPipeline(markov_batch_fn(cfg.vocab, args.batch, args.seq, seed=args.seed))
    state = init_train_state(model, optimizer,
                             torch.Generator(device=device).manual_seed(args.seed), device)

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state)
            pipe.restore({"step": latest})
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
            if dt > args.straggler_factor * med and len(times) > 5:
                print(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"acc {metrics['accuracy']:.3f} lr {metrics['lr']:.2e} "
                      f"{dt * 1e3:.0f}ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, state)
            if on_step is not None:
                on_step(step, metrics, dt)
        if ckpt:
            ckpt.save(args.steps, state)
    finally:
        if ckpt:
            ckpt.close()
    print("done")
    return state


if __name__ == "__main__":
    main()
