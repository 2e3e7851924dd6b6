"""Rank programs of the port's multi-rank tests, and their launcher.

``launch(world, suite, inputs, out)`` starts ``world`` gloo ranks on the CPU
with ``torchrun --standalone`` (which picks a free port), one thread each,
under a time limit, and kills and reaps them whatever happens.  Each rank
runs ``SUITES[suite]`` on the arrays of ``inputs`` (an ``.npz`` the test
wrote) and saves its results to ``<out>/<suite>_w<world>_r<rank>.npz``;
``launch`` returns them, rank by rank.  The pytest process itself never
joins a process group.

This file is not collected by pytest and imports only torch, numpy and
repro_torch.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
_TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID")


def launch(world: int, suite: str, inputs: Path, out: Path, timeout: float = 240.0):
    """Run ``suite`` on ``world`` ranks; each rank's results as a dict."""
    env = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", __file__, suite, str(inputs), str(out)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{suite} at world {world} exited {proc.returncode}:\n{log[-6000:]}")
    return [dict(np.load(out / f"{suite}_w{world}_r{r}.npz")) for r in range(world)]


# --------------------------------------------------------------------------
# Trees as flat {dotted path: array} dicts
# --------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a dict/list tree (the checkpoint's keys)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def as_numpy(tree, prefix: str) -> dict:
    return {f"{prefix}/{k}": v.detach().cpu().numpy() for k, v in flatten(tree).items()}


def from_flat(data, prefix: str, template):
    """``template``'s tree with each leaf read from ``data[prefix/<path>]``."""
    from repro_torch.nn.module import tree_unflatten

    return tree_unflatten(template, [torch.from_numpy(np.array(data[f"{prefix}/{k}"]))
                                     for k in flatten(template)])


# --------------------------------------------------------------------------
# Suites
# --------------------------------------------------------------------------

def suite_compress(data, rank: int, world: int) -> dict:
    """Every case ``c`` of the inputs: ``c/g/<leaf>`` and optionally
    ``c/e/<leaf>`` are (world, ...) arrays, a row a rank; ``c/bits``,
    ``c/steps`` (error feedback carried over the steps, from ``c/e`` or
    zeros) and ``c/single`` (``compressed_psum_mean`` on the one leaf, else
    ``compressed_grad_allreduce`` on the tree).  Writes the means and new
    errors of every step.  ``pipe/Ws`` and ``pipe/x`` run GPipe over the
    whole world as the ``pod`` axis, with the port's sequential composition
    beside it."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.compress import compressed_grad_allreduce, compressed_psum_mean
    from repro_torch.dist.pipeline import make_pipelined_fn

    res = {}
    for c in sorted({k.split("/")[0] for k in data if "/g/" in k}):
        bits, steps = int(data[f"{c}/bits"]), int(data[f"{c}/steps"])
        names = sorted(k.split("/")[2] for k in data if k.startswith(f"{c}/g/"))
        g = {n: torch.from_numpy(data[f"{c}/g/{n}"][rank]) for n in names}
        e = ({n: torch.from_numpy(data[f"{c}/e/{n}"][rank]) for n in names}
             if f"{c}/e/{names[0]}" in data else None)
        means, errs = [], []
        for _ in range(steps):
            if bool(data[f"{c}/single"]):
                (n,) = names
                m, ne = compressed_psum_mean(g[n], bits=bits, error=None if e is None else e[n])
                m, ne = {n: m}, {n: ne}
            else:
                m, ne = compressed_grad_allreduce(g, bits=bits, error_state=e)
            e = ne
            means.append(m)
            errs.append(ne)
        for n in names:
            res[f"{c}/mean/{n}"] = np.stack([m[n].numpy() for m in means])
            res[f"{c}/err/{n}"] = np.stack([x[n].numpy() for x in errs])
    if "pipe/Ws" in data:
        ws, x = torch.from_numpy(data["pipe/Ws"]), torch.from_numpy(data["pipe/x"])
        mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("pod",))

        def stage_fn(w, xb):
            return torch.tanh(xb @ w)

        res["pipe/y"] = make_pipelined_fn(stage_fn, mesh, axis_name="pod")(ws, x).numpy()
        seq = x
        for i in range(ws.shape[0]):
            seq = torch.stack([stage_fn(ws[i], seq[m]) for m in range(seq.shape[0])])
        res["pipe/seq"] = seq.numpy()
    return res


def suite_dp(data, rank: int, world: int) -> dict:
    """smollm-135m-smoke from ``params/*`` over the batches ``batch/<s>/*``
    (SGD 0.9, lr 0.05): ``make_dp_shardmap_train_step`` with
    ``compress_bits`` 8 and 0, ``make_train_step(mesh=)`` float and int8
    QAT, one float step of it on ``masked/*`` (labels masked unevenly
    between the ranks) without and with ``microbatch_split=2``, and
    ``make_eval_step(mesh=)`` on batch 0; each step's loss, accuracy and
    parameters."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.optim import sgd
    from repro_torch.train import trainer

    model = get_config("smollm-135m-smoke").build()
    params = from_flat(data, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    steps = sorted({int(k.split("/")[1]) for k in data if k.startswith("batch/")})
    batches = [{f: data[f"batch/{s}/{f}"] for f in ("tokens", "labels")} for s in steps]
    mesh = make_host_mesh(world, 1, "cpu")
    opt = sgd(momentum=0.9)
    runs = {
        "dp8": trainer.make_dp_shardmap_train_step(model, opt, 0.05, mesh, compress_bits=8),
        "dp0": trainer.make_dp_shardmap_train_step(model, opt, 0.05, mesh),
        "mesh_float": trainer.make_train_step(model, opt, 0.05, mesh=mesh),
        "mesh_qat": trainer.make_train_step(model, opt, 0.05, mesh=mesh,
                                            policy=QuantPolicy.int8_qat()),
    }
    # one step on a batch whose labels are masked unevenly between the ranks
    masked = {f: data[f"masked/{f}"] for f in ("tokens", "labels")}
    runs["mesh_masked"] = trainer.make_train_step(model, opt, 0.05, mesh=mesh)
    runs["mesh_masked_micro"] = trainer.make_train_step(model, opt, 0.05, mesh=mesh,
                                                        microbatch_split=2)
    res = {}
    for name, step_fn in runs.items():
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        for s, batch in enumerate([masked] if name.startswith("mesh_masked") else batches):
            state, mets = step_fn(state, batch)
            res[f"{name}/{s}/loss"] = mets["loss"].numpy()
            res[f"{name}/{s}/accuracy"] = mets["accuracy"].numpy()
            res.update(as_numpy(state["params"], f"{name}/{s}/params"))
        if "err" in state:
            res.update(as_numpy(state["err"], f"{name}/err"))
    ev = trainer.make_eval_step(model, mesh=mesh)(params, batches[0])
    res.update({f"eval/{k}": v.numpy() for k, v in ev.items()})
    return res


def suite_ckpt_write(data, rank: int, world: int) -> dict:
    """Checkpoints 1 (``save``) and 2 (``save_async``, then ``close``) of
    the tree ``tree/*`` into ``dir``; every rank lists the completed steps
    after the barrier."""
    from repro_torch.train.checkpoint import CheckpointManager

    tree = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in data.items()
            if k.startswith("tree/")}
    ck = CheckpointManager(str(data["dir"]))
    ck.save(1, tree)
    seen_1 = ck.all_steps()
    ck.save_async(2, {k: v + 1 for k, v in tree.items()})
    ck.close()
    return {"seen_after_save": np.array(seen_1), "seen_after_close": np.array(ck.all_steps())}


class _Preempted(Exception):
    pass


def suite_launch(data, rank: int, world: int) -> dict:
    """At world 2: checkpoint 1 of ``dir`` restored at this world size;
    ``launch.train.main --mesh 2,1`` for 20 steps (the losses), for 6 steps
    checkpointed every 3 into ``whole``, and the same run preempted after
    step 3's checkpoint into ``cut``."""
    from repro_torch.launch import train as t_launch
    from repro_torch.train.checkpoint import CheckpointManager

    target = {k.split("/", 1)[1]: torch.from_numpy(v).new_empty(0) for k, v in data.items()
              if k.startswith("tree/")}
    res = {f"restored/{k}": v.numpy()
           for k, v in CheckpointManager(str(data["dir"])).restore(1, target).items()}

    base = ["--arch", "smollm-135m-smoke", "--device", "cpu", "--mesh", f"{world},1",
            "--optimizer", "sgd", "--lr", "0.05"]
    losses = []
    state = t_launch.main(base + ["--steps", "20", "--batch", "16", "--seq", "32",
                                  "--log-every", "5"],
                          on_step=lambda s, m, dt: losses.append(m["loss"]))
    res["learn/losses"] = np.array(losses)
    res.update(as_numpy(state["params"], "learn/params"))

    short = base + ["--steps", "6", "--batch", "4", "--seq", "16", "--ckpt-every", "3"]
    state = t_launch.main(short + ["--ckpt-dir", str(data["whole"])])
    res.update(as_numpy(state["params"], "whole/params"))

    def preempt(step, metrics, dt):
        if step == 3:
            raise _Preempted

    try:
        t_launch.main(short + ["--ckpt-dir", str(data["cut"])], on_step=preempt)
    except _Preempted:
        res["cut/preempted"] = np.array(True)
    return res


SUITES = {"compress": suite_compress, "dp": suite_dp, "ckpt_write": suite_ckpt_write,
          "launch": suite_launch}


def main() -> None:
    suite, inputs, out = sys.argv[1], sys.argv[2], Path(sys.argv[3])
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    torch.set_num_threads(1)
    init_process_group(torch.device("cpu"), "gloo")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        with np.load(inputs) as data:
            res = SUITES[suite](dict(data), rank, world)
        np.savez(out / f"{suite}_w{world}_r{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
