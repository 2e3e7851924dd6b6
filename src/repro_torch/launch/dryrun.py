"""The dry-run account: every (arch x shape x mesh x variant) cell's bytes a
device, FLOPs and collective schedule, with nothing allocated
(``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape decode_32k --wq --qkv --mesh 1,1 --out /tmp/acct
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--wq --qkv]

For each cell this builds the port's real step (the train step with SGD,
or the serving prefill or decode step) and runs it once on ``meta``
tensors: parameters, optimizer state, batch and cache have shapes and
dtypes and no storage, as the reference's ``ShapeDtypeStruct`` stand-ins.
The reference AOT-compiles against the 256-chip pod or the 512-chip pair
of pods and reads XLA's analyses; the port counts what its eager step does:

  * ``memory``: per-device argument, output and alias bytes (the leaves cut
    to rank 0's shard by ``dist.sharding``'s specs, the layout the port
    executes: serving parameters by ``param_pspecs(serve=True)`` and the
    cache by ``ServeEngine``'s rows), with the same trees' bytes under the
    reference's float casts (bf16 serving weights, ``--params-dtype``) and
    under the reference's layout (``param_pspecs(serve=decode)``,
    ``cache_pspecs``) beside them;
  * ``cost``: FLOPs from ``FlopCounterMode`` (``launch/analysis.py``);
  * ``collectives``: every ``torch.distributed`` collective of the step, as
    the reference's ``{op: {count, result_bytes, wire_bytes}}``, by mesh
    axis too (``collectives_by_axis``).

The production meshes are ``DeviceMesh``es over a ``"fake"`` process group
in this one process (``launch.mesh.make_production_mesh``): the step that
runs is rank 0's, its collectives move nothing and are counted.  ``--mesh
D,M`` takes a (D, M) mesh the same way; ``--mesh 1,1`` is the one-card
account, run without a mesh.  The port runs its layers unrolled and
eagerly, so its counts are whole: the reference's depth probes (XLA counts
a scanned body once) have no counterpart, ``--no-probe`` is accepted, and
``extrapolated`` holds the whole counts.  There is no temp or peak memory:
no compiler plans it; ``chip_smoke.py`` ``[account]`` measures it on the card.

A cell the port refuses (what a mesh does not execute yet: recurrent,
hybrid and EncDec models, a VLM prefix, a ``pod`` axis, bf16 parameters,
sequence-parallel or data-only rules) is written with its ``refused``
reason and its argument bytes; an error anywhere else fails the run.

Variants are the reference's levers:
  --params-dtype bf16      (refused: the port computes in float32)
  --wq                     int8 weight-only serving
  --wq-train               int8 weight-gather training
  --qkv                    int8 KV cache (paper grid)
  --remat {full,dots,none,off}
  --microbatch N           gradient-accumulation split
  --seq-shard              (refused: not executed)
  --dp-only                (refused: not executed)
  --no-decode-kv-shard     the reference's layout keeps the KV sequence whole
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.dist import sharding as shd
from repro_torch.launch import analysis
from repro_torch.launch.mesh import fake_mesh, hw_table, make_production_mesh
from repro_torch.models.registry import get_config, list_archs
from repro_torch.nn.module import tree_map
from repro_torch.optim import sgd
from repro_torch.serve.engine import ServeEngine, make_decode_step, make_prefill_step
from repro_torch.train.trainer import make_train_step, state_pspecs

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "account")


def _cast_float(tree, dtype):
    """Every float tensor leaf of a meta tree as ``dtype`` (quantized
    leaves and integers untouched)."""
    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(leaf, tree)


def _cut(tree, specs, sizes: Dict[str, int]):
    """A whole meta tree cut to rank 0's block of every leaf."""
    if not sizes:
        return tree
    return shd.shard_tree(tree, specs, sizes, coord=dict.fromkeys(sizes, 0))


@dataclasses.dataclass
class Cell:
    """One cell, built: ``run()`` calls the port's step on rank 0's trees;
    ``account`` holds the trees whose bytes a device holds, by name;
    ``reference_casts(account)`` gives them under the reference's float
    casts, and ``reference_layout`` is the same trees under its layout."""

    run: Optional[Callable[[], Any]]
    account: Dict[str, Any]
    reference_casts: Callable[[Dict[str, Any]], Dict[str, Any]]
    reference_layout: Dict[str, Any]


class Refused(Exception):
    """A cell the port does not execute; its argument bytes are still
    accounted."""

    def __init__(self, reason: str, cell: Cell):
        super().__init__(reason)
        self.cell = cell


def _sizes(mesh) -> Dict[str, int]:
    return shd.mesh_shape(mesh) if mesh is not None else {}


def _refusal(opts, mesh, kind: str) -> Optional[str]:
    """What the port's steps do not execute, whatever the arch."""
    if kind == "train" and opts.params_dtype != "float32":
        return (f"--params-dtype {opts.params_dtype}: the port computes in float32 "
                "(ROADMAP.md queue 1, item 4)")
    if opts.seq_shard:
        return "--seq-shard: sequence-parallel activations are not executed by the port"
    if opts.dp_only:
        return "--dp-only: data-only rules over every mesh axis are not executed by the port"
    if mesh is not None and "pod" in _sizes(mesh):
        return "the pod axis is not executed by the port's steps (specs only)"
    return None


def lower_cell(cfg, shape_name: str, mesh, opts) -> Cell:
    """The cell's step and its rank-0 meta trees.  ``mesh`` None is the
    one-card account.  Raises :class:`Refused` (with the cell's trees) for
    a cell the port does not execute."""
    sh = SHAPES[shape_name]
    sizes = _sizes(mesh)
    rules = shd.make_axis_rules(sizes, seq_shard=opts.seq_shard,
                                decode_kv_shard=not opts.no_decode_kv_shard,
                                dp_only=opts.dp_only) if mesh is not None else None
    refusal = _refusal(opts, mesh, sh.kind)
    model = cfg.build(remat=opts.remat)
    params = model.init(torch.Generator(), "meta")
    if sh.kind == "train":
        return _train_cell(cfg, model, params, shape_name, mesh, rules, sizes, opts, refusal)
    return _serve_cell(cfg, model, params, shape_name, mesh, rules, sizes, opts, refusal)


def _train_cell(cfg, model, params, shape_name, mesh, rules, sizes, opts, refusal) -> Cell:
    optimizer = sgd(momentum=0.9, weight_decay=5e-4)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = cfg.input_specs(shape_name)
    if rules is not None:
        sspecs = state_pspecs(state, sizes, rules)
        local_state = _cut(state, sspecs, sizes)
        local_batch = _cut(batch, shd.batch_pspecs(batch, sizes, rules), sizes)
    else:
        local_state, local_batch = state, batch
    account = {"state": local_state, "batch": local_batch}
    pdt = getattr(torch, opts.params_dtype)

    def casts(acc):
        st = acc["state"]
        return dict(acc, state=dict(st, params=_cast_float(st["params"], pdt),
                                    opt=_cast_float(st["opt"], pdt)))

    cell = Cell(run=None, account=account, reference_casts=casts, reference_layout=account)
    if refusal:
        raise Refused(refusal, cell)
    try:
        step = make_train_step(model, optimizer, 0.01, mesh=mesh, axis_rules=rules,
                               microbatch_split=opts.microbatch,
                               int8_weight_gather=opts.wq_train)
    except NotImplementedError as e:
        raise Refused(str(e), cell) from None
    # every rank passes the global batch and takes its rows (trainer._slices)
    cell.run = lambda: step(local_state, batch)
    return cell


def _serve_cell(cfg, model, params, shape_name, mesh, rules, sizes, opts, refusal) -> Cell:
    sh = SHAPES[shape_name]
    specs = cfg.input_specs(shape_name)
    whole = integerize_weights_only(params) if opts.wq else params
    whole_cache = model.init_cache(sh.global_batch, sh.seq_len, quantized_kv=opts.qkv,
                                   device="meta")
    tokens = specs["tokens"]
    extra = {k: v for k, v in specs.items() if k in ("embeds", "enc")}
    if rules is not None:
        ref_layout = {
            "params": _cut(whole, shd.param_pspecs(whole, sizes, rules,
                                                   serve=sh.kind == "decode"), sizes),
            "tokens": _cut(tokens, shd.batch_pspecs(tokens, sizes, rules), sizes),
            "cache": _cut(whole_cache, shd.cache_pspecs(whole_cache, sizes, rules), sizes),
            **{k: _cut(v, shd.batch_pspecs(v, sizes, rules), sizes) for k, v in extra.items()}}
    else:
        ref_layout = {"params": whole, "tokens": tokens, "cache": whole_cache, **extra}
    def casts(acc):
        # bf16 serving weights (an int8 tree keeps its float32 norms, as the
        # reference's does), a bf16 float cache and encoder inputs
        return {k: v if k == "params" and opts.wq else _cast_float(v, torch.bfloat16)
                for k, v in acc.items()}

    # until the engine cuts them, the port's trees are the reference's layout's
    account = dict(ref_layout)
    cell = Cell(run=None, account=account, reference_casts=casts, reference_layout=ref_layout)
    if refusal:
        raise Refused(refusal, cell)
    try:
        # the int8 leaves pass the engine's integerize as they are
        engine = ServeEngine(model, whole, max_len=sh.seq_len, batch_slots=sh.global_batch,
                             quantized_kv=opts.qkv, weight_quant=opts.wq, device="meta",
                             mesh=mesh, axis_rules=rules)
    except (NotImplementedError, ValueError) as e:
        raise Refused(str(e), cell) from None
    rows = slice(0, engine.local_slots)
    cache = engine.new_cache()
    account.update(params=engine.params, tokens=tokens[rows], cache=cache,
                   **{k: v[rows] for k, v in extra.items()})
    if mesh is not None and extra:
        raise Refused("a VLM prefix (embeds) or an EncDec encoder output under a mesh is not "
                      "served yet (ROADMAP.md queue 1, item 3b.7)", cell)
    if sh.kind == "prefill":
        step = make_prefill_step(model, mesh=mesh, axis_rules=rules)
        kw = {}
        if "embeds" in extra:
            kw["enc" if cfg.is_encdec else "embeds"] = account["embeds"]
        cell.run = lambda: step(engine.params, account["tokens"], cache, **kw)
    else:
        step = make_decode_step(model, mesh=mesh, axis_rules=rules)
        kw = {"enc": account["enc"]} if "enc" in extra else {}
        cell.run = lambda: step(engine.params, account["tokens"], cache, None, **kw)
    return cell


def _memory(cell: Cell, outputs) -> Dict[str, Any]:
    args = list(cell.account.values())
    mem = analysis.memory_stats(args, outputs if outputs is not None else [])
    mem["arguments"] = {k: analysis.tree_bytes(v) for k, v in cell.account.items()}
    mem["qtensor_scale_bytes"] = analysis.scale_bytes(args)
    # the reference's QTensor holds no scale: it computes 2^-n where used
    ref = list(cell.reference_casts(cell.account).values())
    mem["reference_casts_argument_bytes"] = analysis.tree_bytes(ref) - analysis.scale_bytes(ref)
    mem["reference_layout_argument_bytes"] = analysis.tree_bytes(
        list(cell.reference_layout.values()))
    return mem


def build_cell(arch: str, shape_name: str, mesh, opts, *, run: bool = True) -> dict:
    """Build and run one cell; the record (``refused`` set where the port
    does not execute it).  ``run=False`` builds the cell's trees alone: its
    argument bytes, without the step's outputs, FLOPs or collectives."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    sizes = _sizes(mesh)
    n_periods = (cfg.n_layers - cfg.first_k_dense) // len(cfg.layout)
    record = {
        "arch": arch, "shape": shape_name, "kind": sh.kind,
        "mesh": {"shape": sizes or {"data": 1, "model": 1},
                 "n_chips": math.prod(sizes.values())},
        "variant": opts.variant_name(),
        "seq_len": sh.seq_len, "global_batch": sh.global_batch,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "probes": {}, "hw": hw_table(),
    }
    t0 = time.time()
    try:
        cell = lower_cell(cfg, shape_name, mesh, opts)
    except Refused as r:
        record.update(refused=str(r), memory=_memory(r.cell, None), cost={},
                      collectives={}, collectives_by_axis={}, collective_wire_bytes=0.0,
                      extrapolated={}, build_s=round(time.time() - t0, 2))
        return record
    t_build = time.time() - t0
    if not run:
        record.update(memory=_memory(cell, None), build_s=round(t_build, 2))
        return record
    t0 = time.time()
    with analysis.counting_collectives(mesh) as coll, \
            torch.no_grad() if sh.kind != "train" else torch.enable_grad():
        outputs, flops, by_op = analysis.count_flops(cell.run)
    wire = analysis.total_wire_bytes(coll["total"])
    record.update(
        memory=_memory(cell, outputs), cost=analysis.cost_stats(flops, by_op),
        collectives=coll["total"], collectives_by_axis=coll["by_axis"],
        collective_wire_bytes=wire,
        extrapolated={"flops": float(flops), "wire_bytes": wire, "n_periods": n_periods,
                      "whole": "the port's counts are of every layer; no depth probe"},
        build_s=round(t_build, 2), step_s=round(time.time() - t0, 2))
    return record


def mesh_tag(multi_pod: bool, mesh_arg: Optional[str]) -> str:
    if mesh_arg:
        return "mesh" + "x".join(mesh_arg.split(","))
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_path(arch, shape_name, tag, variant, out_dir):
    v = f"__{variant}" if variant and variant != "baseline" else ""
    return os.path.join(out_dir, f"{arch}__{shape_name}__{tag}{v}.json")


class Opts(argparse.Namespace):
    def variant_name(self):
        parts = []
        if self.params_dtype != "float32":
            parts.append(self.params_dtype)
        if self.wq:
            parts.append("wq")
        if getattr(self, "wq_train", False):
            parts.append("wqt")
        if self.qkv:
            parts.append("qkv")
        if self.remat != "full":
            parts.append(f"remat-{self.remat}")
        if self.microbatch != 1:
            parts.append(f"mb{self.microbatch}")
        if self.seq_shard:
            parts.append("sp")
        if self.dp_only:
            parts.append("dponly")
        if self.no_decode_kv_shard:
            parts.append("nokvs")
        return "-".join(parts) or "baseline"


def all_cells():
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if cfg.supports(shape_name):
                yield arch, shape_name


def parse_args(argv=None) -> Opts:
    ap = argparse.ArgumentParser(description="the port's dry-run account")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="data,model: a host-sized mesh in place of the production one "
                         "(1,1: the one-card account)")
    ap.add_argument("--all", action="store_true", help="run every supported cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--params-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--wq", action="store_true")
    ap.add_argument("--wq-train", action="store_true",
                    help="int8 weight-gather training (STE, f32 master)")
    ap.add_argument("--qkv", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none", "off"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--no-decode-kv-shard", action="store_true")
    ap.add_argument("--no-probe", dest="probe", action="store_false",
                    help="accepted; the port's counts are whole without probes")
    return ap.parse_args(argv, namespace=Opts())


def run_cell(arch: str, shape_name: str, opts: Opts, *, multi_pod: bool = False) -> dict:
    """One cell's record on the mesh the options name (a fake group for the
    span of the run, destroyed after it)."""
    if opts.mesh:
        d, m = (int(x) for x in opts.mesh.split(","))
        if d * m == 1:
            return build_cell(arch, shape_name, None, opts)
        group = fake_mesh((d, m), ("data", "model"))
    else:
        group = make_production_mesh(multi_pod=multi_pod)
    with group as mesh:
        return build_cell(arch, shape_name, mesh, opts)


def _summary(path: str, record: dict) -> str:
    mem = record["memory"]
    head = f"{'REFUSED' if 'refused' in record else 'OK'} {path}\n   args/device=" \
           f"{mem['argument_size_in_bytes'] / 2**20:.1f}MiB"
    if "refused" in record:
        return f"{head} ({record['refused']})"
    return (f"{head} out/device={mem['output_size_in_bytes'] / 2**20:.1f}MiB "
            f"flops={record['cost']['flops']:.3e} "
            f"wire={record['collective_wire_bytes']:.3e}B step={record['step_s']}s")


def main(argv=None) -> int:
    opts = parse_args(argv)
    os.makedirs(opts.out, exist_ok=True)
    if opts.all:
        cells = [(a, s) for a, s in all_cells()]
        meshes = [False, True] if opts.both_meshes and not opts.mesh else [opts.multi_pod]
    else:
        if not (opts.arch and opts.shape):
            raise SystemExit("--arch and --shape required (or --all)")
        cells, meshes = [(opts.arch, opts.shape)], [opts.multi_pod]
    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            path = cell_path(arch, shape_name, mesh_tag(mp, opts.mesh), opts.variant_name(),
                             opts.out)
            if opts.skip_existing and os.path.exists(path):
                print(f"skip {path}")
                continue
            try:
                record = run_cell(arch, shape_name, opts, multi_pod=mp)
            except Exception:
                record = {"arch": arch, "shape": shape_name, "variant": opts.variant_name(),
                          "mesh": {"multi_pod": mp, "mesh": opts.mesh},
                          "error": traceback.format_exc()}
                failures.append((arch, shape_name, mp))
                print(record["error"], file=sys.stderr)
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
            if "error" not in record:
                print(_summary(path, record), flush=True)
    if opts.all:
        print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
