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


def _sharded_steps(model, opt, params, batches, mesh, rules, runs, prefix) -> dict:
    """Each run of ``runs`` ({name: make_train_step kwargs}) from
    ``params`` cut by the rules, one step a batch: the losses and this
    rank's shards after every step."""
    from repro_torch.train import trainer

    res = {}
    for name, kw in runs.items():
        state = trainer.shard_state({"params": params, "opt": opt.init(params),
                                     "step": torch.zeros((), dtype=torch.int32)}, mesh, rules)
        step_fn = trainer.make_train_step(model, opt, 0.05, mesh=mesh, axis_rules=rules, **kw)
        for s, batch in enumerate(batches):
            state, mets = step_fn(state, batch)
            res[f"{prefix}{name}/{s}/loss"] = mets["loss"].numpy()
            res.update(as_numpy(state["params"], f"{prefix}{name}/{s}/params"))
    return res


def _gather_params(params, model, mesh, rules):
    from repro_torch.dist import sharding

    whole = model.init(torch.Generator(), "meta")
    return sharding.gather_tree(params, sharding.param_pspecs(whole, mesh, rules), mesh)


def suite_shard(data, rank: int, world: int) -> dict:
    """smollm-135m-smoke from ``params/*`` on a (world / 2, 2) mesh under
    the sharding rules, SGD 0.9 at lr 0.05 over ``batch/<s>/*``:
    ``make_train_step(mesh=, axis_rules=)`` float, int8 QAT and
    ``int8_weight_gather`` (the losses and this rank's shards after every
    step), and ``fake_int8_weights`` of the cut tree gathered whole.  At
    world 4 also phi3.5-moe-smoke (two float steps; the port's single
    process with two routing groups beside it, gathered whole) and
    ``launch.train.main --mesh 2,2`` for 6 steps checkpointed every 3, whole
    and preempted after step 3 (copied to ``cut2``); at world 2 the
    preempted run resumed under ``--mesh 1,2``."""
    import shutil

    import torch.distributed as dist

    from repro_torch.core.integerize import fake_int8_weights
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data.pipeline import markov_batch_fn
    from repro_torch.dist import sharding
    from repro_torch.launch import train as t_launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn.module import tree_leaves
    from repro_torch.optim import sgd
    from repro_torch.train import trainer

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model = get_config("smollm-135m-smoke").build()
    params = from_flat(data, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    steps = sorted({int(k.split("/")[1]) for k in data if k.startswith("batch/")})
    batches = [{f: data[f"batch/{s}/{f}"] for f in ("tokens", "labels")} for s in steps]
    opt = sgd(momentum=0.9)
    res = _sharded_steps(model, opt, params, batches, mesh, rules,
                         {"float": {}, "qat": {"policy": QuantPolicy.int8_qat()},
                          "i8": {"int8_weight_gather": True}}, "")

    specs = sharding.param_pspecs(params, mesh, rules)
    ev = trainer.make_eval_step(model, mesh=mesh, axis_rules=rules)(
        sharding.shard_tree(params, specs, mesh), batches[0])
    res.update({f"eval/{k}": v.numpy() for k, v in ev.items()})

    # the int8 codes' gather: dequantized, then the model-cut columns gathered
    deq = fake_int8_weights(sharding.shard_tree(params, specs, mesh), mesh=mesh, rules=rules,
                            specs=specs)
    cols = [tuple("model" if "model" in sharding._axes(e) and t.shape[d] < w.shape[d] else None
                  for d, e in enumerate(sp))
            for (w, sp), t in zip(sharding.leaves_with_specs(params, specs), tree_leaves(deq))]
    it = iter(cols)
    from repro_torch.nn.module import tree_map

    deq = sharding.gather_tree(deq, tree_map(lambda _: next(it), deq), mesh)
    res.update(as_numpy(deq, "i8codes"))

    if world == 4:
        phi = get_config("phi3.5-moe-42b-a6.6b-smoke").build()
        pp = phi.init(torch.Generator().manual_seed(0), "cpu")
        bf = markov_batch_fn(get_config("phi3.5-moe-42b-a6.6b-smoke").vocab, 8, 16, seed=3)
        phi_batches = [bf(s) for s in range(2)]
        state = trainer.shard_state({"params": pp, "opt": opt.init(pp),
                                     "step": torch.zeros((), dtype=torch.int32)}, mesh, rules)
        step_fn = trainer.make_train_step(phi, opt, 0.05, mesh=mesh, axis_rules=rules)
        real = moe_mod.MoE.apply
        moe_mod.MoE.apply = lambda self, p, x, ctx, num_groups=None: real(
            self, p, x, ctx, num_groups=2 if ctx.mesh is None else num_groups)
        try:
            one = {"params": pp, "opt": opt.init(pp), "step": torch.zeros((), dtype=torch.int32)}
            one_fn = trainer.make_train_step(phi, opt, 0.05)
            for s, batch in enumerate(phi_batches):
                state, mets = step_fn(state, batch)
                one, one_mets = one_fn(one, batch)
                res[f"phi/{s}/loss"] = mets["loss"].numpy()
                res[f"phi_one/{s}/loss"] = one_mets["loss"].numpy()
        finally:
            moe_mod.MoE.apply = real
        res.update(as_numpy(_gather_params(state["params"], phi, mesh, rules), "phi/params"))
        res.update(as_numpy(one["params"], "phi_one/params"))

        short = ["--arch", "smollm-135m-smoke", "--device", "cpu", "--mesh", "2,2",
                 "--optimizer", "sgd", "--lr", "0.05", "--steps", "6", "--batch", "8",
                 "--seq", "16", "--ckpt-every", "3"]
        state = t_launch.main(short + ["--ckpt-dir", str(data["whole"])])
        res.update(as_numpy(_gather_params(state["params"], model, mesh, rules),
                            "whole/params"))

        def preempt(step, metrics, dt):
            if step == 3:
                raise _Preempted

        try:
            t_launch.main(short + ["--ckpt-dir", str(data["cut"])], on_step=preempt)
        except _Preempted:
            res["cut/preempted"] = np.array(True)
        dist.barrier()
        if rank == 0:
            shutil.copytree(str(data["cut"]), str(data["cut2"]))
        dist.barrier()
    else:
        resume = ["--arch", "smollm-135m-smoke", "--device", "cpu", "--mesh", "1,2",
                  "--optimizer", "sgd", "--lr", "0.05", "--steps", "6", "--batch", "8",
                  "--seq", "16", "--ckpt-every", "3", "--ckpt-dir", str(data["cut"])]
        state = t_launch.main(resume)
        res.update(as_numpy(_gather_params(state["params"], model, mesh, rules),
                            "resume12/params"))
    return res


def suite_shard_serve(data, rank: int, world: int) -> dict:
    """phi3.5-moe-smoke from ``params/*`` on a (2, 2) mesh: the reference's
    one-device prefill of ``toks`` into a float32 cache (recomputed here on
    one rank's whole batch), then one decode step of ``nxt`` with the
    parameters cut by ``param_pspecs(serve=True)`` and this rank's rows of
    the cache: the logits and ``make_decode_step``'s tokens of its rows.
    The same with int8 weights and an int8 cache against this rank's own
    one-device decode; and a sharded prefill (each data rank's rows one
    routing group) against the one-device prefill with two groups."""
    import copy

    from repro_torch.core.integerize import integerize_weights_only
    from repro_torch.dist import shard_ops, sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn.module import Context
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model = get_config("phi3.5-moe-42b-a6.6b-smoke").build()
    params = from_flat(data, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    toks = torch.from_numpy(data["toks"])
    nxt = torch.from_numpy(data["nxt"])
    b = toks.shape[0]
    rows = slice(shard_ops.axis_index(mesh, "data") * b // (world // 2),
                 (shard_ops.axis_index(mesh, "data") + 1) * b // (world // 2))
    res = {}
    with torch.no_grad():
        for name, wq in (("float", False), ("int8", True)):
            p = integerize_weights_only(params) if wq else params
            cache = model.init_cache(b, 16, quantized_kv=wq, device="cpu")
            _, cache = model.apply(p, toks, Context(), cache=cache, decode=True)
            one, _ = model.apply(p, nxt, Context(), cache=copy.deepcopy(cache), decode=True)
            pp = sharding.shard_tree(p, sharding.param_pspecs(p, mesh, rules, serve=True), mesh)
            cs = sharding.shard_tree(cache, sharding.cache_rows_pspecs(cache, mesh, rules), mesh)
            ctx = Context(mesh=mesh, axis_rules=rules)
            shard_ops.reset_collective_counts()
            got, _ = model.apply(pp, nxt[rows], ctx, cache=copy.deepcopy(cs), decode=True)
            counts = shard_ops.collective_counts()
            step = make_decode_step(model, mesh=mesh, axis_rules=rules)
            res[f"{name}/next"] = step(pp, nxt[rows], cs, None)[0].numpy()
            res[f"{name}/logits"] = got.numpy()
            res[f"{name}/one"] = one[rows].numpy()
            res[f"{name}/one_next"] = one[:, -1].argmax(-1).numpy()
            res[f"{name}/psum_bytes"] = np.array(counts.get(("data", "psum"), (0, 0))[1])
        # a sharded prefill: each data rank's rows one routing group
        real = moe_mod.MoE.apply
        moe_mod.MoE.apply = lambda self, p, x, ctx, num_groups=None: real(
            self, p, x, ctx, num_groups=world // 2 if ctx.mesh is None else num_groups)
        try:
            one, _ = make_prefill_step(model)(params, toks, model.init_cache(
                b, 16, quantized_kv=False, device="cpu"))
        finally:
            moe_mod.MoE.apply = real
        pp = sharding.shard_tree(params, sharding.param_pspecs(params, mesh, rules), mesh)
        got, _ = make_prefill_step(model, mesh=mesh, axis_rules=rules)(
            pp, toks[rows], model.init_cache(b // (world // 2), 16, quantized_kv=False,
                                             device="cpu"))
        res["prefill/logits"] = got.numpy()
        res["prefill/one"] = one[rows].numpy()

    # the all-reduce form (gloo on a card) against the native collectives,
    # forced on these CPU tensors: float32 with -0.0 and NaN, odd int8 blocks
    gen = torch.Generator().manual_seed(rank)
    blocks = {"f32": torch.randn(3, 5, generator=gen),
              "i8": torch.randint(-128, 128, (3, 3), generator=gen, dtype=torch.int8)}
    blocks["f32"][0, 0], blocks["f32"][1, 1] = -0.0, float("nan")
    real = shard_ops._sum_form
    for form in ("native", "all_reduce"):
        shard_ops._sum_form = (lambda x, g: True) if form == "all_reduce" else real
        try:
            for axis in ("data", "model"):
                for name, t in blocks.items():
                    res[f"forms/{form}/{axis}/gather/{name}"] = shard_ops.all_gather(
                        t, 1, mesh, axis).view(torch.uint8 if name == "i8" else
                                               torch.int32).numpy()
                res[f"forms/{form}/{axis}/reduce_scatter"] = shard_ops.reduce_scatter(
                    torch.arange(24.0).reshape(4, 6) * (rank + 1), 0, mesh, axis).numpy()
        finally:
            shard_ops._sum_form = real
    return res


# --------------------------------------------------------------------------
# Serving under a mesh: the scheduler's policies, generate() and restarts
# --------------------------------------------------------------------------

#: name -> (ServeEngine keywords, Scheduler keywords) of the served policies
#: (page size 4, chunk 4, two ragged lanes); the reference takes them as they are
MESH_POLICIES = {
    "scheduler": ({}, {}),
    "chunked": ({}, {"chunk_size": 4}),
    "chunked_paged": ({"paged_kv": True, "page_size": 4},
                      {"chunk_size": 4, "prefix_sharing": False}),
    "ragged": ({}, {"chunk_size": 4, "ragged": True, "prefill_lanes": 2}),
    "ragged_paged": ({"paged_kv": True, "page_size": 4},
                     {"chunk_size": 4, "ragged": True, "prefill_lanes": 2,
                      "prefix_sharing": False}),
}
MESH_SLOTS, MESH_MAX_LEN = 4, 32


def mesh_requests(data, prefix: str):
    """The (rid, prompt, max_new, arrival) tuples stored under ``prefix``."""
    return [(int(r), data[f"{prefix}/prompts"][i, :data[f"{prefix}/plens"][i]].astype(np.int32),
             int(data[f"{prefix}/max_new"][i]), int(data[f"{prefix}/arrival"][i]))
            for i, r in enumerate(data[f"{prefix}/rids"])]


def stream_array(results, rids, width: int) -> np.ndarray:
    """Each rid's tokens as a row padded with -1, then its status as a code
    (0 ok) in the last column."""
    from repro_torch.serve.scheduler import STATUSES

    out = np.full((len(rids), width + 1), -1, np.int64)
    for i, rid in enumerate(rids):
        toks = results[rid].tokens
        out[i, :len(toks)] = toks
        out[i, -1] = STATUSES.index(results[rid].status)
    return out


def _serve(model, params, reqs, eng_kw, sched_kw, mesh, rules, *, weight_quant, run_kw=None,
           temperature=0.0, seed=0, eos_id=None, wrap=None, record=None):
    """One scheduler run (no warm-up; ``mesh`` None: the port's one
    device) of ``ServeEngine(**eng_kw).scheduler(**sched_kw)`` over
    ``reqs`` with ``run(**run_kw)`` (:func:`run_kwargs`); ``wrap(sched,
    eng)`` may patch the scheduler first.  (results, stats, the collective
    counts by (axis, kind))."""
    from repro_torch.dist import shard_ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request

    eng = ServeEngine(model, params, max_len=MESH_MAX_LEN, batch_slots=MESH_SLOTS,
                      quantized_kv=True, weight_quant=weight_quant, temperature=temperature,
                      device="cpu", mesh=mesh, axis_rules=rules, **eng_kw)
    if record is not None:
        record["local_pages"] = eng.local_pages
    sched = eng.scheduler(eos_id=eos_id, **sched_kw)
    if wrap is not None:
        wrap(sched, eng)
    shard_ops.reset_collective_counts()
    res, stats = sched.run(
        [Request(rid=r, prompt=p, max_new=m, arrival=a) for r, p, m, a in reqs], seed=seed,
        warmup=False, **run_kwargs(run_kw or {}))
    return res, stats, shard_ops.collective_counts()


def _mesh_run(model, params, reqs, policy, mesh, rules, *, weight_quant, temperature=0.0,
              seed=0, record=None, eos_id=None):
    """One scheduler run of ``policy`` (no warm-up; ``mesh`` None: the
    port's one device); (results, stats, the collective counts by (axis,
    kind))."""
    eng_kw, sched_kw = MESH_POLICIES[policy]
    return _serve(model, params, reqs, eng_kw, sched_kw, mesh, rules, weight_quant=weight_quant,
                  temperature=temperature, seed=seed, eos_id=eos_id, record=record)


def _page_recorder(record: dict):
    """Wrap the scheduler's page-table writes: each (global slot, global
    row, local row) this rank installs goes to ``record["installs"]``, each
    (global slot, global page, local page) a lazy growth maps to
    ``record["grown"]``, and each block an allocation found dry to
    ``record["dry"]``."""
    from repro_torch.serve import scheduler as sched_mod

    from repro_torch.serve.paging import PageAllocator

    real_row, real_entry = sched_mod.set_cache_page_row, sched_mod.set_cache_page_entry
    real_alloc = PageAllocator.alloc

    def alloc(self, n, block=0):
        got = real_alloc(self, n, block)
        if got is None:
            record.setdefault("dry", set()).add(block)
        return got

    def installed(cache, slot, row, *, shard=None):
        if shard is not None and shard.local(slot) is not None:
            record.setdefault("installs", []).append(
                (slot, np.asarray(row, np.int64), shard.local_pages(row).astype(np.int64)))
        return real_row(cache, slot, row, shard=shard)

    def grown(cache, slot, idx, page, *, shard=None):
        if shard is not None and shard.local(slot) is not None:
            record.setdefault("grown", []).append((slot, page, int(shard.local_pages([page])[0])))
        return real_entry(cache, slot, idx, page, shard=shard)

    sched_mod.set_cache_page_row, sched_mod.set_cache_page_entry = installed, grown
    PageAllocator.alloc = alloc

    def undo():
        sched_mod.set_cache_page_row, sched_mod.set_cache_page_entry = real_row, real_entry
        PageAllocator.alloc = real_alloc
    return undo


def suite_mesh_serve(data, rank: int, world: int) -> dict:
    """smollm-135m-smoke from ``params/*`` on a (2, 2) mesh, int8 KV, float
    and int8 weights: every policy of :data:`MESH_POLICIES` over the
    requests ``req/*``, ``run_restart_batching`` over ``rreq/*`` and
    ``generate()`` of ``lock/prompts``; each run's streams (``stream_array``),
    its ticks and the collective calls by (axis, kind), and for the paged
    policies every page-table row this rank installed (global and local
    ids).  Then what a mesh does not serve yet: each refusal's message."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ServeEngine, make_prefill_step
    from repro_torch.serve.scheduler import Request, run_restart_batching

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model = get_config("smollm-135m-smoke").build()
    params = from_flat(data, "params", model.init(torch.Generator().manual_seed(0), "cpu"))
    reqs, rreqs = mesh_requests(data, "req"), mesh_requests(data, "rreq")
    new = max(m for _, _, m, _ in reqs)
    res = {"data_rank": np.array(rank // 2)}
    for label, wq in (("float", False), ("int8", True)):
        for policy in MESH_POLICIES:
            record = {}
            undo = _page_recorder(record)
            try:
                out, stats, counts = _mesh_run(model, params, reqs, policy, mesh, rules,
                                               weight_quant=wq, record=record)
            finally:
                undo()
            key = f"{label}/{policy}"
            res[f"{key}/streams"] = stream_array(out, [r for r, *_ in reqs], new)
            res[f"{key}/ticks"] = np.array(stats.decode_steps)
            for (axis, kind), (calls, nbytes) in counts.items():
                res[f"{key}/calls/{axis}/{kind}"] = np.array([calls, nbytes])
            if "installs" in record:
                res[f"{key}/local_pages"] = np.array(record["local_pages"])
                res[f"{key}/page_slots"] = np.array([i[0] for i in record["installs"]])
                res[f"{key}/page_rows"] = np.stack([i[1] for i in record["installs"]])
                res[f"{key}/page_local"] = np.stack([i[2] for i in record["installs"]])
        eng = ServeEngine(model, params, max_len=MESH_MAX_LEN, batch_slots=MESH_SLOTS,
                          quantized_kv=True, weight_quant=wq, device="cpu", mesh=mesh,
                          axis_rules=rules)
        out, _ = run_restart_batching(
            eng, [Request(rid=r, prompt=p, max_new=m, arrival=a) for r, p, m, a in rreqs],
            warmup=False)
        res[f"{label}/restart/streams"] = stream_array(
            out, [r for r, *_ in rreqs], max(m for _, _, m, _ in rreqs))
        res[f"{label}/lockstep/tokens"] = eng.generate(data["lock/prompts"],
                                                       int(data["lock/new"])).numpy()
        res[f"{label}/cache_bytes"] = np.array([eng.cache_bytes(), eng.cache_bytes(per_slot=True)])

    # what a mesh does not serve yet: the archs, a VLM prefix, packed weights
    def engine(arch, **kw):
        return lambda: ServeEngine(get_config(arch).build(), None, max_len=MESH_MAX_LEN,
                                   batch_slots=MESH_SLOTS, device="cpu", mesh=mesh,
                                   axis_rules=rules, **kw)

    def vlm_prefix():
        prefill = make_prefill_step(model, mesh=mesh, axis_rules=rules)
        prefill(params, torch.zeros((1, 4), dtype=torch.int32), None,
                embeds=torch.zeros((1, 2, 8)))

    refused = {"recurrent": engine("mamba-130m-smoke"), "jamba": engine("jamba-v0.1-52b-smoke"),
               "whisper": engine("whisper-tiny-smoke"), "embeds": vlm_prefix,
               "int4": lambda: ServeEngine(model, params, max_len=MESH_MAX_LEN,
                                           batch_slots=MESH_SLOTS, weight_quant="int4",
                                           device="cpu", mesh=mesh, axis_rules=rules)}
    for name, fn in refused.items():
        try:
            fn()
            res[f"refused/{name}"] = np.array("")
        except NotImplementedError as e:
            res[f"refused/{name}"] = np.array(str(e))
    return res


def _decode_rows(record: list, mesh):
    """Patch the engine's sampling so that each decode step's logit rows
    go to ``record``: under a mesh this rank's (``sample_over_data``'s
    decode rows), on one device every slot's (the first rows of a
    ``sample_tokens`` call of at least (slots, V): a decode step's, a
    ragged tick's).  Returns the undo."""
    from repro_torch.serve import engine as eng_mod

    name = "sample_tokens" if mesh is None else "sample_over_data"
    real = getattr(eng_mod, name)

    def recorded(rows, *a, **k):
        if mesh is not None:
            record.append(rows[:a[0]].clone())
        elif rows.ndim == 2 and rows.shape[0] >= MESH_SLOTS:
            record.append(rows[:MESH_SLOTS].clone())
        return real(rows, *a, **k)

    setattr(eng_mod, name, recorded)
    return lambda: setattr(eng_mod, name, real)


def suite_mesh_moe(data, rank: int, world: int) -> dict:
    """The MoE archs on a (2, 2) mesh, int8 weights and KV, over the
    requests ``req/*``: ``arch/<a>`` (a registry id) under each policy of
    ``policies/<a>`` (a comma-joined list of :data:`MESH_POLICIES`), the
    streams and every decode step's logit rows (this rank's, and every
    slot's) of the mesh and of the port's one device (no group) side by
    side; then smollm-135m-smoke at temperature 0.7 under ``sampled``'s
    policies and ``generate()`` (``seed`` 3), and greedy under them with an
    ``eos_id`` its streams emit, the mesh's and the one device's."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ServeEngine

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    reqs = mesh_requests(data, "req")
    rids = [r for r, *_ in reqs]
    new = max(m for _, _, m, _ in reqs)
    res = {}
    for arch in sorted(k.split("/", 1)[1] for k in data if k.startswith("arch/")):
        model = get_config(str(data[f"arch/{arch}"])).build()
        for policy in str(data[f"policies/{arch}"]).split(","):
            for where, m, r in (("mesh", mesh, rules), ("one", None, None)):
                params = model.init(torch.Generator().manual_seed(0), "cpu")
                rows = []
                undo = _decode_rows(rows, m)
                try:
                    out, stats, counts = _mesh_run(model, params, reqs, policy, m, r,
                                                   weight_quant=True)
                finally:
                    undo()
                res[f"{arch}/{policy}/{where}"] = stream_array(out, rids, new)
                res[f"{arch}/{policy}/{where}/rows"] = torch.stack(rows).numpy()
                if m is not None:
                    res[f"{arch}/{policy}/ticks"] = np.array(stats.decode_steps)
                    for (axis, kind), (calls, nbytes) in counts.items():
                        res[f"{arch}/{policy}/calls/{axis}/{kind}"] = np.array([calls, nbytes])
    model = get_config("smollm-135m-smoke").build()
    for policy in str(data["sampled"]).split(","):
        for where, m, r in (("mesh", mesh, rules), ("one", None, None)):
            params = model.init(torch.Generator().manual_seed(0), "cpu")
            out, _, _ = _mesh_run(model, params, reqs, policy, m, r, weight_quant=True,
                                  temperature=0.7, seed=3)
            res[f"sampled/{policy}/{where}"] = stream_array(out, rids, new)
    # an EOS id the greedy streams emit mid-stream: the hosts evict on the
    # gathered tokens and refill the slots
    one, _, _ = _mesh_run(model, model.init(torch.Generator().manual_seed(0), "cpu"), reqs,
                          "chunked", None, None, weight_quant=True)
    eos = one[rids[0]].tokens[2]
    res["eos/id"] = np.array(eos)
    for policy in str(data["sampled"]).split(","):
        for where, m, r in (("mesh", mesh, rules), ("one", None, None)):
            out, _, _ = _mesh_run(model, model.init(torch.Generator().manual_seed(0), "cpu"),
                                  reqs, policy, m, r, weight_quant=True, eos_id=eos)
            res[f"eos/{policy}/{where}"] = stream_array(out, rids, new)
            res[f"eos/{policy}/{where}/flags"] = np.array([out[i].eos for i in rids])
    for where, m, r in (("mesh", mesh, rules), ("one", None, None)):
        eng = ServeEngine(model, model.init(torch.Generator().manual_seed(0), "cpu"),
                          max_len=MESH_MAX_LEN, batch_slots=MESH_SLOTS, quantized_kv=True,
                          weight_quant=True, temperature=0.7, device="cpu", mesh=m,
                          axis_rules=r)
        res[f"sampled/lockstep/{where}"] = eng.generate(data["req/prompts"][:MESH_SLOTS, :5],
                                                        6, seed=3).numpy()
    return res


# --------------------------------------------------------------------------
# The page pool's features and hardened serving under a mesh
# --------------------------------------------------------------------------

#: a paged engine (page size 4): the dense-parity pool (4 slots x 8 pages)
#: and half of it, 8 pages a data rank's block
POOL_FULL = {"paged_kv": True, "page_size": 4}
POOL_HALF = {"paged_kv": True, "page_size": 4, "kv_pool_pages": 16}
CHUNKED = {"chunk_size": 4, "prefix_sharing": False}
RAGGED = {"chunk_size": 4, "ragged": True, "prefill_lanes": 2, "prefix_sharing": False}


def oversub(policy: str) -> dict:
    return {"oversubscribe": True, "preempt_policy": policy}


#: name -> (requests, weight_quant, ServeEngine keywords, Scheduler keywords,
#: run keywords as JSON: ``preempts`` [[rid, tick], ...], ``fault_plan`` a
#: ``FaultPlan.to_json``); the reference takes them as they are
#: (``run_kwargs``).  ``grow``'s requests run each data rank's block dry;
#: ``light``'s fit every block; ``split``'s sharers of a 2-page prefix land
#: on both data ranks, ``local``'s on the prefix's rank alone.
POOL_CASES = {
    "oversub/chunked/recompute": ("grow", True, POOL_HALF, {**CHUNKED, **oversub("recompute")},
                                  {}),
    "oversub/chunked/swap": ("grow", False, POOL_HALF, {**CHUNKED, **oversub("swap")}, {}),
    "oversub/ragged/recompute": ("grow", False, POOL_HALF, {**RAGGED, **oversub("recompute")},
                                 {}),
    "oversub/ragged/swap": ("grow", True, POOL_HALF, {**RAGGED, **oversub("swap")}, {}),
    "oversub/light": ("light", True, POOL_HALF, {**CHUNKED, **oversub("swap")}, {}),
    "preempts/recompute": ("base", True, POOL_FULL, {**CHUNKED, **oversub("recompute")},
                           {"preempts": [[0, 6], [2, 9]]}),
    "preempts/swap": ("base", False, POOL_FULL, {**CHUNKED, **oversub("swap")},
                      {"preempts": [[0, 6], [2, 9]]}),
    "prefix/split": ("split", True, POOL_FULL, {"chunk_size": 4}, {}),
    "prefix/local": ("local", False, POOL_FULL, {"chunk_size": 4}, {}),
}

#: the audited runs (int8 weights): name -> (ServeEngine kw, Scheduler kw)
AUDIT_CASES = {"dense": ({}, {"chunk_size": 4}), "paged": (POOL_FULL, CHUNKED),
               "ragged": (POOL_FULL, RAGGED)}
#: the fault drill: an oversubscribed swap run at half the pool, audited,
#: its plan denying allocations and swaps and poisoning slot 2 (data rank 1)
FAULT_CASE = (POOL_HALF, {**CHUNKED, **oversub("swap"), "audit": True},
              {"fault_plan": {"alloc_fail": [8], "swap_fail": [8], "nan": [[12, 2]]}})
BREACH_TICK = 7         # the tick whose step corrupts a table row of data rank 1

#: the summary fields that are no wall time (every rank's must be equal)
COUNTERS = ("decode_steps", "tokens_out", "occupancy", "p50_latency_steps", "p99_latency_steps",
            "peak_cache_bytes", "prefill_chunks", "stalled_chunks", "admission_stalls",
            "page_stalls", "peak_pages_in_use", "peak_live_slots", "page_occupancy",
            "prefix_hits", "shared_pages_mapped", "cow_copies", "grown_pages", "preemptions",
            "resumes", "swapped_pages", "swap_peak_bytes", "resume_stalls", "swap_refusals",
            "truncations", "p50_ttft_steps", "p99_ttft_steps", "completed", "rejections",
            "timeouts", "cancellations", "failed", "completion_rate", "deadlock_failures",
            "nan_evictions", "fault_events", "audited_ticks", "audit_reads")


def run_kwargs(kw: dict) -> dict:
    """``run()`` keywords from their JSON form (:data:`POOL_CASES`)."""
    from repro_torch.serve.faults import FaultPlan

    out = {}
    if "preempts" in kw:
        out["preempts"] = {int(r): int(t) for r, t in kw["preempts"]}
    if "fault_plan" in kw:
        out["fault_plan"] = FaultPlan.from_json(kw["fault_plan"])
    return out


def counters(stats) -> np.ndarray:
    """The :data:`COUNTERS` of a run's summary, in order."""
    summary = stats.summary()
    return np.array([float(summary[k]) for k in COUNTERS])


def _record_run(res: dict, key: str, out, stats, counts, rids, width) -> None:
    res[f"{key}/streams"] = stream_array(out, rids, width)
    res[f"{key}/counters"] = counters(stats)
    for (axis, kind), (calls, nbytes) in counts.items():
        res[f"{key}/calls/{axis}/{kind}"] = np.array([calls, nbytes])


def _record_pages(res: dict, key: str, record: dict) -> None:
    """The page-table writes :func:`_page_recorder` saw, as arrays."""
    res[f"{key}/local_pages"] = np.array(record["local_pages"])
    rows = record.get("installs", [])
    grown = record.get("grown", [])
    res[f"{key}/page_slots"] = np.array([i[0] for i in rows] + [g[0] for g in grown], np.int64)
    width = MESH_MAX_LEN // POOL_FULL["page_size"]
    res[f"{key}/page_rows"] = np.stack(
        [i[1] for i in rows] + [np.r_[g[1], np.full(width - 1, -1)] for g in grown])
    res[f"{key}/page_local"] = np.stack(
        [i[2] for i in rows] + [np.r_[g[2], np.full(width - 1, -1)] for g in grown])
    res[f"{key}/dry_blocks"] = np.array(sorted(record.get("dry", ())), np.int64)


def _smoke(data):
    """smollm-135m-smoke with the reference's params (``params/*``)."""
    from repro_torch.models.registry import get_config

    model = get_config("smollm-135m-smoke").build()
    return model, from_flat(data, "params", model.init(torch.Generator().manual_seed(0), "cpu"))


def suite_mesh_pool(data, rank: int, world: int) -> dict:
    """smollm-135m-smoke on a (2, 2) mesh, int8 KV, every case of
    :data:`POOL_CASES` over the requests ``<requests>/*``: each run's
    streams and statuses, its counters, its collective calls by (axis,
    kind) and every page-table write this rank made (global and local
    ids)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model, params = _smoke(data)
    res = {"data_rank": np.array(rank // 2), "layers": np.array(model.stack.attention_layers)}
    for name, (rq, wq, eng_kw, sched_kw, run_kw) in POOL_CASES.items():
        reqs = mesh_requests(data, rq)
        record = {}
        undo = _page_recorder(record)
        try:
            out, stats, counts = _serve(model, params, reqs, eng_kw, sched_kw, mesh, rules,
                                        weight_quant=wq, run_kw=run_kw, record=record)
        finally:
            undo()
        _record_run(res, name, out, stats, counts, [r for r, *_ in reqs],
                    max(m for _, _, m, _ in reqs))
        _record_pages(res, name, record)
    return res


def _breach(box: dict):
    """A ``wrap`` that corrupts, on data rank 1 only, its first live
    slot's table entry 0 (moved one local page on) in the step of tick
    :data:`BREACH_TICK`, and records the ticks in ``box``."""
    from repro_torch.serve.slot_state import find_paged_kv

    def wrap(sched, eng):
        def corrupting(step):
            def wrapped(*a, **k):
                out = step(*a, **k)
                if eng.data_rank == 1 and not box.get("done") and box["t"] >= BREACH_TICK:
                    table = find_paged_kv(out[-1])["page_table"]
                    live = int((table[:, 0] >= 0).nonzero()[0, 0])
                    table[live, 0] = (table[live, 0] + 1) % eng.local_pages
                    box["done"] = True
                return out
            return wrapped
        for name in ("_masked_decode", "_masked_mixed"):
            setattr(sched, name, corrupting(getattr(sched, name)))
        real = sched.run

        def run(*a, **k):
            return real(*a, on_tick=lambda t: box.__setitem__("t", t), **k)
        sched.run = run
    return wrap


def suite_mesh_hardened(data, rank: int, world: int) -> dict:
    """smollm-135m-smoke on a (2, 2) mesh, int8 weights and KV, over the
    requests ``base/*``: each :data:`AUDIT_CASES` run audited and not;
    :data:`FAULT_CASE` greedy and at temperature 0.7 (seed 3), the latter
    beside the port's one device; and the audited paged run whose step
    corrupts a table row of data rank 1 at :data:`BREACH_TICK` (the tick
    and message of the ``AuditError`` each rank raised)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.audit import AuditError

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model, params = _smoke(data)
    reqs = mesh_requests(data, "base")
    rids, width = [r for r, *_ in reqs], max(m for _, _, m, _ in reqs)
    res = {"data_rank": np.array(rank // 2)}
    for name, (eng_kw, sched_kw) in AUDIT_CASES.items():
        for audited in (True, False):
            out, stats, counts = _serve(model, params, reqs, eng_kw,
                                        {**sched_kw, "audit": audited}, mesh, rules,
                                        weight_quant=True)
            _record_run(res, f"{name}/{'audit' if audited else 'plain'}", out, stats, counts,
                        rids, width)
    eng_kw, sched_kw, run_kw = FAULT_CASE
    out, stats, counts = _serve(model, params, reqs, eng_kw, sched_kw, mesh, rules,
                                weight_quant=True, run_kw=run_kw)
    _record_run(res, "fault", out, stats, counts, rids, width)
    for where, m, r in (("mesh", mesh, rules), ("one", None, None)):
        out, stats, counts = _serve(model, params, reqs, eng_kw, sched_kw, m, r,
                                    weight_quant=True, run_kw=run_kw, temperature=0.7, seed=3)
        _record_run(res, f"sampled/{where}", out, stats, counts, rids, width)
    box = {"t": -1}
    try:
        _serve(model, params, reqs, *AUDIT_CASES["paged"][:1],
               {**AUDIT_CASES["paged"][1], "audit": True}, mesh, rules, weight_quant=True,
               wrap=_breach(box))
        res["breach/message"] = np.array("")
    except AuditError as e:
        res["breach/message"] = np.array(str(e))
    res["breach/tick"] = np.array(box["t"])
    res["breach/corrupted"] = np.array(bool(box.get("done")))
    return res


def biased_model():
    """glm4-9b-smoke (QKV biases) and its parameters from seed 0, each bias
    drawn N(0, 0.1^2) from seed 1 (the init's are zeros)."""
    from repro_torch.models.registry import get_config

    model = get_config("glm4-9b-smoke").build()
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)

    def fill(node):
        for k, v in (node.items() if isinstance(node, dict) else enumerate(node)):
            if isinstance(v, (dict, list)):
                fill(v)
            elif k == "bias":
                node[k] = 0.1 * torch.randn(v.shape, generator=gen)
    fill(params)
    return model, params


def suite_bias(data, rank: int, world: int) -> dict:
    """glm4-9b-smoke with nonzero QKV biases on a (world / 2, 2) mesh: a
    stacked bias (L, N) is cut like a (D_in, D_out) kernel, its layers over
    ``data`` and its columns over ``model``.  Two float SGD steps over
    ``tokens``/``labels`` (the losses and the parameters gathered whole),
    then ``ServeEngine(mesh=).generate`` of ``prompts`` (int8 weights and
    KV)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import sgd
    from repro_torch.serve import ServeEngine
    from repro_torch.train import trainer

    mesh = make_host_mesh(world // 2, 2, "cpu")
    rules = sharding.make_axis_rules(mesh)
    model, params = biased_model()
    opt = sgd(momentum=0.9)
    state = trainer.shard_state({"params": params, "opt": opt.init(params),
                                 "step": torch.zeros((), dtype=torch.int32)}, mesh, rules)
    step_fn = trainer.make_train_step(model, opt, 0.05, mesh=mesh, axis_rules=rules)
    res = {}
    for s in range(len(data["tokens"])):
        state, mets = step_fn(state, {"tokens": data["tokens"][s], "labels": data["labels"][s]})
        res[f"loss/{s}"] = mets["loss"].numpy()
    res.update(as_numpy(_gather_params(state["params"], model, mesh, rules), "params"))
    engine = ServeEngine(model, biased_model()[1], max_len=24, batch_slots=4, device="cpu",
                         quantized_kv=True, weight_quant=True, mesh=mesh, axis_rules=rules)
    res["generate"] = engine.generate(torch.from_numpy(data["prompts"]), 6).numpy()
    return res


SUITES = {"compress": suite_compress, "dp": suite_dp, "ckpt_write": suite_ckpt_write,
          "launch": suite_launch, "shard": suite_shard, "shard_serve": suite_shard_serve,
          "mesh_serve": suite_mesh_serve, "mesh_moe": suite_mesh_moe, "bias": suite_bias,
          "mesh_pool": suite_mesh_pool, "mesh_hardened": suite_mesh_hardened}


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
