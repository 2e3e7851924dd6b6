"""The dry-run account (``repro_torch.launch.{dryrun,analysis}``, the cell
shapes of ``configs/base.py``) against the reference.

* (a) ``SHAPES``, ``supports`` and ``input_specs`` equal the reference's for
  every arch and cell: every input's shape and dtype (the reference's built
  at float32, the port's one dtype), and every tensor leaf of the decode
  cache; the reference's int32 ``len``/``k_n``/``v_n`` leaves are host ints
  in the port.
* (b) At both production meshes, (16, 16) and (2, 16, 16), every leaf the
  account cuts to rank 0's shard has the reference's ``shard_shape`` under
  the reference's specs, for every arch at its published width: float and
  int8 parameters (serving orientation and training), SGD's momentum, the
  training batch, the prefill tokens and the decode cache.  The reference's
  specs come from ``jax.eval_shape`` trees on an abstract mesh.
* (c) The ring wire-byte rules (``analysis.wire_bytes``) equal the
  reference's ``parse_collectives`` on one HLO line per op, iota and
  explicit ``replica_groups`` at group sizes 1, 2, 16 and 256; and
  ``counting_collectives`` reads the result bytes of the calls made over a
  fake (4, 2) mesh.
* (d) The reference's one-device smoke cells (its ``lower_cell`` and
  ``_compile_and_analyze`` on a (1, 1) mesh, in a subprocess: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices) against the
  account at ``--mesh 1,1``: ``decode_32k --wq --qkv``'s per-device argument
  bytes equal XLA's ``argument_size_in_bytes`` (536,983,576) once the port's
  QTensor ``scale`` leaves come out and the reference's int32 cache scalars
  go in; its 8-byte PRNG key is an argument XLA prunes (unused at
  temperature 0); ``decode_32k`` float and ``prefill_32k`` leaf by leaf,
  equal but where the reference's leaf is bf16 and the port's float32.
  XLA's FLOPs and the port's are printed side by side: no tolerance holds
  between them (XLA counts elementwise work and a loop body once).
* (e) ``main`` at the 16 x 16 production mesh, in a subprocess, on a train
  cell of a dense, an MoE, a recurrent and an EncDec smoke arch: the dense
  and MoE records' collectives are non-empty on both axes; the recurrent
  and EncDec cells, which a sharded train step refuses, are written as
  refused with their argument bytes; no process group is left behind.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core.integerize import integerize_weights_only as j_integerize
from repro.dist import sharding as j_shd
from repro.dist.compat import abstract_mesh
from repro.launch.analysis import parse_collectives
from repro.models.registry import get_config as j_get_config
from repro.models.registry import list_archs
from repro.optim import sgd as j_sgd
from repro_torch.configs import SHAPES, ShapeSpec
from repro_torch.core.qformat import QTensor
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import PRODUCTION_MESHES, fake_mesh
from repro_torch.models.registry import get_config

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, path=""):
    """{path: leaf} of a dict/list tree; a QTensor's codes and exponents
    apart (``#q``, ``#n``), a port QTensor's ``scale`` as ``#scale``."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}" if path else str(key)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}" if path else str(i)).items()}
    if hasattr(tree, "q") and hasattr(tree, "n"):
        out = {path + "#q": tree.q, path + "#n": tree.n}
        if isinstance(tree, QTensor):
            out[path + "#scale"] = tree.scale
        return out
    return {path: tree}


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# (a) the cells and their inputs
# --------------------------------------------------------------------------

def test_shapes_are_the_references():
    assert list(SHAPES) == list(j_base.SHAPES)
    for name, spec in SHAPES.items():
        want = j_base.SHAPES[name]
        assert spec == ShapeSpec(want.name, want.seq_len, want.global_batch, want.kind)


def _cache_matches(got, want):
    """Every tensor leaf of the port's cache is the reference's at its path
    (shape and dtype); a reference leaf the port lacks is one of its int32
    scalars (per layer when stacked), a host int in the port."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(g, torch.Tensor):
            assert (tuple(g.shape), _dtype(g)) == (tuple(w.shape), str(w.dtype)), path
        else:
            assert isinstance(g, int) and path.rsplit("/", 1)[-1] in ("len", "k_n", "v_n")
            assert str(w.dtype) == "int32" and len(w.shape) <= 1, path


@pytest.mark.parametrize("arch", list_archs())
def test_supports_and_input_specs_are_the_references(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        assert cfg.supports(name) == jcfg.supports(name)
        if not cfg.supports(name):
            with pytest.raises(ValueError):
                cfg.input_specs(name)
            continue
        got = cfg.input_specs(name)
        want = jcfg.input_specs(name, dtype=jnp.float32)
        assert got.keys() == want.keys()
        for k in got:
            if k == "cache":
                _cache_matches(got[k], want[k])
                continue
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dtype(got[k])) == (want[k].shape, str(want[k].dtype))


# --------------------------------------------------------------------------
# (b) rank 0's shard of every leaf at the production meshes
# --------------------------------------------------------------------------

def _shard_shape(shape, spec, sizes):
    out = list(shape)
    for d, e in enumerate(tuple(spec)):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            assert out[d] % sizes[a] == 0
            out[d] //= sizes[a]
    return tuple(out)


def _j_shards(tree, specs, sizes):
    """{path: rank 0's shape} of a reference tree under its spec tree."""
    leaves, spec_leaves = _flat(tree), _flat(specs)
    out = {}
    for path, leaf in leaves.items():
        spec = spec_leaves[path]
        out[path] = _shard_shape(leaf.shape, getattr(spec, "spec", spec), sizes)
    return out


def _t_shapes(tree):
    return {p: tuple(t.shape) for p, t in _flat(tree).items()
            if isinstance(t, torch.Tensor) and not p.endswith("#scale")}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_leaf_is_the_references_shard(arch, multi_pod):
    shape, axes = PRODUCTION_MESHES[multi_pod]
    sizes = dict(zip(axes, shape))
    jmesh = abstract_mesh(shape, axes)
    j_rules = j_shd.make_axis_rules(jmesh)
    rules = dryrun.shd.make_axis_rules(sizes)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jm = jcfg.build(dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    jf = jax.eval_shape(jm.init, key)
    ji = jax.eval_shape(lambda k: j_integerize(jm.init(k)), key)
    jm_opt = jax.eval_shape(j_sgd(momentum=0.9).init, jf)["m"]
    model = cfg.build()
    tf = model.init(torch.Generator(), "meta")
    ti = dryrun.integerize_weights_only(tf)
    checked = 0
    for jt, tt in ((jf, tf), (ji, ti)):
        for serve in (False, True):
            want = _j_shards(jt, j_shd.param_pspecs(jt, jmesh, j_rules, serve=serve), sizes)
            got = _t_shapes(dryrun._cut(tt, dryrun.shd.param_pspecs(tt, sizes, rules,
                                                                    serve=serve), sizes))
            assert got == want
            checked += len(want)
    # SGD's momentum, cut as the train state is (trainer.state_pspecs)
    state = {"params": tf, "opt": {"m": tf}, "step": torch.zeros((), device="meta")}
    local = dryrun._cut(state, dryrun.state_pspecs(state, sizes, rules), sizes)
    want = _j_shards(jm_opt, j_shd.param_pspecs(jm_opt, jmesh, j_rules), sizes)
    assert _t_shapes(local["opt"]["m"]) == want
    for name in SHAPES:
        if not cfg.supports(name):
            continue
        jspecs, tspecs = jcfg.input_specs(name, dtype=jnp.float32), cfg.input_specs(name)
        for k in ("tokens", "labels", "embeds", "enc"):
            if k in jspecs:
                want = _shard_shape(jspecs[k].shape, j_shd.batch_pspecs(
                    jspecs[k], jmesh, j_rules).spec, sizes)
                got = dryrun._cut(tspecs[k], dryrun.shd.batch_pspecs(tspecs[k], sizes, rules),
                                  sizes)
                assert tuple(got.shape) == want, (name, k)
        if SHAPES[name].kind == "decode":
            jc, tc = jspecs["cache"], tspecs["cache"]
            want = _j_shards(jc, j_shd.cache_pspecs(jc, jmesh, j_rules), sizes)
            got = _t_shapes(dryrun._cut(tc, dryrun.shd.cache_pspecs(tc, sizes, rules), sizes))
            assert got == {p: s for p, s in want.items() if p in got}
            assert all(p.rsplit("/", 1)[-1] in ("len", "k_n", "v_n") for p in set(want) - set(got))
            checked += len(got)
    assert checked > 0


# --------------------------------------------------------------------------
# (c) the collectives' wire bytes
# --------------------------------------------------------------------------

def _hlo_line(op, group, form):
    shape = "f32[16,64]{1,0}"
    if group == 1 and form == "iota":
        groups = ""
    elif form == "iota":
        groups = f", replica_groups=[{512 // group},{group}]<=[512]"
    else:
        groups = ", replica_groups={{" + ",".join(str(i) for i in range(group)) + "},{" + \
            ",".join(str(group + i) for i in range(group)) + "}}"
    return f"  %c.1 = {shape} {op}(f32[16,64]{{1,0}} %p.0){groups}, dimensions={{0}}"


@pytest.mark.parametrize("form", ["iota", "explicit"])
@pytest.mark.parametrize("group", [1, 2, 16, 256])
@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_wire_bytes_are_the_references(op, group, form):
    want = parse_collectives(_hlo_line(op, group, form))[op]
    assert want["count"] == 1 and want["result_bytes"] == 16 * 64 * 4
    assert analysis.wire_bytes(op, want["result_bytes"], group) == want["wire_bytes"]


def test_counting_collectives_reads_each_calls_result():
    import torch.distributed as dist

    with fake_mesh((4, 2), ("data", "model")) as mesh:
        x = torch.empty(8, 3, device="meta")
        with analysis.counting_collectives(mesh) as coll:
            out = torch.empty(32, 3, device="meta")
            dist.all_gather_into_tensor(out, x, group=mesh.get_group("data"))
            dist.all_reduce(x, group=mesh.get_group("model"))
            part = torch.empty(4, 3, device="meta")
            dist.reduce_scatter_tensor(part, x, group=mesh.get_group("model"))
        # restored on exit: a later call is not counted
        dist.all_reduce(x, group=mesh.get_group("model"))
    assert not dist.is_initialized()
    ag, ar, rs = (coll["by_axis"][a][op] for a, op in (("data", "all-gather"),
                                                       ("model", "all-reduce"),
                                                       ("model", "reduce-scatter")))
    assert ag == {"count": 1, "result_bytes": 32 * 3 * 4,
                  "wire_bytes": analysis.wire_bytes("all-gather", 32 * 3 * 4, 4)}
    assert ar == {"count": 1, "result_bytes": 96, "wire_bytes": 2 * 96 * 1 / 2}
    assert rs == {"count": 1, "result_bytes": 48, "wire_bytes": 48 * 1}
    assert analysis.total_wire_bytes(coll["total"]) == ag["wire_bytes"] + 96 + 48


# --------------------------------------------------------------------------
# (d) the reference's one-device smoke cells
# --------------------------------------------------------------------------

REF_CELLS = [("decode_32k", True, True), ("decode_32k", False, False),
             ("prefill_32k", False, False)]

REF_SCRIPT = """
import json
from repro.launch import dryrun as d          # sets XLA_FLAGS first
import jax
from repro.models.registry import get_config
mesh = jax.make_mesh((1, 1), ("data", "model"))
out = {}
for shape, wq, qkv in %r:
    opts = d.Opts(params_dtype="float32", wq=wq, wq_train=False, qkv=qkv, remat="full",
                  microbatch=1, seq_shard=False, dp_only=False, no_decode_kv_shard=False,
                  probe=False)
    lowered = d.lower_cell(get_config("smollm-135m-smoke"), shape, mesh, opts)
    leaves = [[jax.tree_util.keystr(p), list(a.shape), str(a.dtype)]
              for p, a in jax.tree_util.tree_flatten_with_path(lowered.args_info)[0]]
    r = d._compile_and_analyze(lowered)
    out["%%s %%s %%s" %% (shape, wq, qkv)] = {"memory": r["memory"],
                                           "flops": r["cost"].get("flops"), "leaves": leaves}
print(json.dumps(out))
""" % (REF_CELLS,)


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _opts(*flags):
    return dryrun.parse_args(["--mesh", "1,1", *flags])


def _port_cell(shape, wq, qkv):
    flags = (["--wq"] if wq else []) + (["--qkv"] if qkv else [])
    cell = dryrun.lower_cell(get_config("smollm-135m-smoke"), shape, None, _opts(*flags))
    return cell, dryrun.build_cell("smollm-135m-smoke", shape, None, _opts(*flags))


_ARG = {"0": "params", "1": "tokens", "2": "cache", "3": "key"}


def _ref_leaves(leaves):
    """{(argument, path): (shape, dtype)} of the reference's argument
    leaves, paths in the port's form."""
    out = {}
    for key, shape, dtype in leaves:
        parts = [p.strip("[]'") for p in key.replace("][", "]|[").split("|")]
        arg, rest = _ARG[parts[1]], parts[2:]
        if rest and rest[-1].startswith("<flat index"):
            rest[-1] = "#q" if rest[-1].endswith("0>") else "#n"
            path = "/".join(rest[:-1]) + rest[-1]
        else:
            path = "/".join(rest)
        out[(arg, path)] = (tuple(shape), dtype)
    return out


def _port_leaves(cell):
    out = {}
    for arg, tree in cell.account.items():
        for path, t in _flat(tree).items():
            if isinstance(t, torch.Tensor) and not path.endswith("#scale"):
                out[(arg, path)] = (tuple(t.shape), _dtype(t))
    return out


def _nbytes(shape, dtype):
    return int(np.prod(shape)) * np.dtype(jnp.dtype(dtype)).itemsize


def test_decode_wq_qkv_bytes_equal_xlas_argument_size(ref_cells):
    ref = ref_cells["decode_32k True True"]
    cell, record = _port_cell("decode_32k", True, True)
    ref_leaves, port_leaves = _ref_leaves(ref["leaves"]), _port_leaves(cell)
    # leaf by leaf: every port tensor is the reference's leaf
    for k, v in port_leaves.items():
        assert ref_leaves[k] == v, k
    extra = {k: v for k, v in ref_leaves.items() if k not in port_leaves}
    key = extra.pop(("key", ""))
    assert key == ((2,), "uint32")
    assert all(k[0] == "cache" and k[1].rsplit("/", 1)[-1] in ("len", "k_n", "v_n")
               and v[1] == "int32" for k, v in extra.items())
    scalars = sum(_nbytes(*v) for v in extra.values())
    mem = record["memory"]
    xla = ref["memory"]["argument_size_in_bytes"]
    assert xla == 536_983_576
    # the PRNG key (8 bytes) is an argument XLA prunes: the step never draws from it
    assert sum(_nbytes(*v) for v in ref_leaves.values()) - _nbytes(*key) == xla
    assert mem["argument_size_in_bytes"] - mem["qtensor_scale_bytes"] + scalars == xla
    print(f"decode_32k --wq --qkv: argument bytes port {mem['argument_size_in_bytes']:,} "
          f"(scale {mem['qtensor_scale_bytes']:,}, host scalars {scalars}) vs XLA {xla:,}; "
          f"FLOPs port {record['cost']['flops']:.4g} vs XLA {ref['flops']:.4g}")


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_float_cells_equal_leaf_by_leaf_but_the_dtype(ref_cells, shape):
    ref = ref_cells[f"{shape} False False"]
    cell, record = _port_cell(shape, False, False)
    ref_leaves, port_leaves = _ref_leaves(ref["leaves"]), _port_leaves(cell)
    for k, (shp, dt) in port_leaves.items():
        want_shape, want_dt = ref_leaves[k]
        assert shp == want_shape, k
        assert dt == want_dt or (dt, want_dt) == ("float32", "bfloat16"), k
    extra = set(ref_leaves) - set(port_leaves)
    assert all(k == ("key", "") or k[1].rsplit("/", 1)[-1] == "len" for k in extra)
    # the reference's casts applied to the port's trees give its bf16 bytes
    scalars = sum(_nbytes(*ref_leaves[k]) for k in extra if k[0] == "cache")
    want = ref["memory"]["argument_size_in_bytes"]
    assert record["memory"]["reference_casts_argument_bytes"] + scalars == want
    print(f"{shape} float: argument bytes port {record['memory']['argument_size_in_bytes']:,} "
          f"(float32) vs XLA {want:,} (bf16); FLOPs port {record['cost']['flops']:.4g} vs "
          f"XLA {ref['flops']:.4g}")


# --------------------------------------------------------------------------
# (e) main at the production mesh
# --------------------------------------------------------------------------

MAIN_SCRIPT = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import dryrun
out = sys.argv[1]
for arch in ("smollm-135m-smoke", "phi3.5-moe-42b-a6.6b-smoke", "mamba-130m-smoke",
             "whisper-tiny-smoke"):
    assert dryrun.main(["--arch", arch, "--shape", "train_4k", "--out", out]) == 0
print(json.dumps({"group_left": dist.is_initialized()}))
"""


def test_main_at_the_production_mesh_records_both_axes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-W", "ignore", "-c", MAIN_SCRIPT, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == {"group_left": False}
    for arch in ("smollm-135m-smoke", "phi3.5-moe-42b-a6.6b-smoke"):
        rec = json.loads((tmp_path / f"{arch}__train_4k__pod16x16.json").read_text())
        assert rec["mesh"] == {"shape": {"data": 16, "model": 16}, "n_chips": 256}
        assert "refused" not in rec
        for axis in ("data", "model"):
            assert any(d["count"] > 0 for d in rec["collectives_by_axis"][axis].values())
        assert rec["collective_wire_bytes"] == pytest.approx(
            sum(d["wire_bytes"] for d in rec["collectives"].values()))
        assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["cost"]["flops"] > 0
    for arch in ("mamba-130m-smoke", "whisper-tiny-smoke"):
        rec = json.loads((tmp_path / f"{arch}__train_4k__pod16x16.json").read_text())
        assert "causal attention family only" in rec["refused"]
        assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["collectives"] == {}
