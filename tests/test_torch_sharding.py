"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), and the MoE routing groups, in one
process (no process group).

* The eight cases of ``tests/test_sharding.py`` under the same names, with
  a ``{axis: size}`` mapping for the reference's abstract mesh and tuples
  for its ``PartitionSpec``s.
* Every leaf of every registry arch's smoke tree, float and after
  ``integerize_weights_only`` (a QTensor's codes and exponents apart), at
  meshes (16, 16), (2, 16, 16) with ``pod``, (4, 2), (2, 2) and (1, 2),
  with ``dp_only`` off and on and ``serve`` off and on: the reference's
  specs come from ``jax.eval_shape`` (no compute), the port's from its own
  tree.
* ``placements``, ``local_slice`` / ``shard_tree`` blocks against the
  reference's data-major layout, ``batch_pspecs`` and ``cache_pspecs``.
* The MoE layer at routing groups G = 1, 2, 4 (phi3.5-moe-smoke's
  widths) against the reference's ``MoE.apply(num_groups=G)``: the
  routing identical, the output and the auxiliary loss at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.dist import sharding as j_shd
from repro.dist.compat import abstract_mesh
from repro.models.registry import get_config as j_get_config
from repro.models.registry import list_archs
from repro.nn.module import Context as JContext
from repro.nn.moe import MoE as JMoE
from repro_torch.convert import params_from_numpy
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.core.qformat import QTensor
from repro_torch.dist import sharding as shd
from repro_torch.models.registry import get_config
from repro_torch.nn import moe as t_moe
from repro_torch.nn.module import Context

MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}, "2x2": {"data": 2, "model": 2},
          "1x2": {"data": 1, "model": 2}}


def fake_mesh(shape=(16, 16), axes=("data", "model")):
    return dict(zip(axes, shape))


def j_mesh(mesh):
    return abstract_mesh(tuple(mesh.values()), tuple(mesh))


# --------------------------------------------------------------------------
# tests/test_sharding.py's cases, on the port
# --------------------------------------------------------------------------

def test_divisibility_drops_axis():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    assert shd._spec_for_path("attn/wq/kernel", (576, 576), rules, mesh) == ("data", "model")
    assert shd._spec_for_path("attn/wq/kernel", (576, 9), rules, mesh) == ("data", None)


def test_scan_stacked_leading_dims_replicate():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    spec = shd._spec_for_path("stack/body/0/ffn/w_gate/kernel", (30, 576, 1536), rules, mesh)
    assert spec == (None, "data", "model")


def test_expert_orientation_train_vs_serve():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    shape = (60, 384, 7168, 2048)
    train = shd._spec_for_path("ffn/experts/w_gate/kernel", shape, rules, mesh, serve=False)
    serve = shd._spec_for_path("ffn/experts/w_gate/kernel", shape, rules, mesh, serve=True)
    assert train == (None, "model", None, "data")
    assert serve == (None, "model", "data", None)


def test_router_replicated():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    assert shd._spec_for_path("moe/router/kernel", (7168, 384), rules, mesh) == ()


def test_batch_prefix_fallback():
    mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
    rules = shd.make_axis_rules(mesh, dp_only=True)
    assert shd._fit(mesh, rules["batch"], 256) == ("data", "model")
    assert shd._fit(mesh, rules["batch"], 512) == ("data", "model", "pod")
    assert shd._fit(mesh, rules["batch"], 7) is None


def test_dedupe_drops_second_use():
    assert shd._dedupe(("model", "model", None)) == ("model", None, None)
    assert shd._dedupe((("data", "model"), "model")) == (("data", "model"), None)
    assert shd._dedupe((None, "data", "model")) == (None, "data", "model")


def test_cache_specs_kv_seq_sharded():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    cache = {"kv": {"k": torch.empty((64, 128, 32768, 8, 128), dtype=torch.bfloat16,
                                     device="meta"),
                    "len": torch.zeros((), dtype=torch.int32)}}
    specs = shd.cache_pspecs(cache, mesh, rules)
    assert specs["kv"]["k"] == (None, "data", "model", None, None)
    assert specs["kv"]["len"] == ()


def test_qtensor_param_specs():
    mesh = fake_mesh()
    rules = shd.make_axis_rules(mesh)
    qt = QTensor(q=torch.empty((7168, 2048), dtype=torch.int8, device="meta"),
                 n=torch.zeros((2048,), dtype=torch.int32), width=8, channel_axis=1)
    out = shd.param_pspecs({"ffn": {"w_gate": {"kernel": qt}}}, mesh, rules)["ffn"]["w_gate"]
    assert out["kernel"].q == ("data", "model")
    assert out["kernel"].n == ("model",)


# --------------------------------------------------------------------------
# Every leaf of every arch, every mesh and orientation
# --------------------------------------------------------------------------

_trees = {}


def _trees_of(arch):
    """(reference float shapes, reference int8 shapes, port float tree,
    port int8 tree) of ``arch``-smoke, memoized."""
    if arch not in _trees:
        jm = j_get_config(arch + "-smoke").build(dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        jf = jax.eval_shape(jm.init, key)
        ji = jax.eval_shape(lambda k: j_integerize(jm.init(k)), key)
        tf = get_config(arch + "-smoke").build().init(torch.Generator().manual_seed(0), "cpu")
        _trees[arch] = (jf, ji, tf, integerize_weights_only(tf))
    return _trees[arch]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}" if path else str(key)).items()}
    if isinstance(tree, list):      # a spec is a tuple: a leaf
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}" if path else str(i)).items()}
    return {path: tree}


def _j_specs(tree):
    """{path: spec tuple} of a reference spec tree (a QTensor's q and n apart)."""
    out = {}
    for k, v in _flat(tree).items():
        if hasattr(v, "q") and hasattr(v, "n"):
            out[k + "#q"], out[k + "#n"] = tuple(v.q.spec), tuple(v.n.spec)
        else:
            out[k] = tuple(v.spec)
    return out


def _t_specs(tree):
    out = {}
    for k, v in _flat(tree).items():
        if isinstance(v, QTensor):
            out[k + "#q"], out[k + "#n"] = v.q, v.n
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_every_leaf_has_the_references_spec(arch, mesh_id):
    mesh = MESHES[mesh_id]
    jf, ji, tf, ti = _trees_of(arch)
    jmesh = j_mesh(mesh)
    checked = 0
    for dp_only in (False, True):
        rules = shd.make_axis_rules(mesh, dp_only=dp_only)
        j_rules = j_shd.make_axis_rules(jmesh, dp_only=dp_only)
        assert rules == j_rules
        for serve in (False, True):
            for jt, tt in ((jf, tf), (ji, ti)):
                want = _j_specs(j_shd.param_pspecs(jt, jmesh, j_rules, serve=serve))
                got = _t_specs(shd.param_pspecs(tt, mesh, rules, serve=serve))
                assert got == want
                checked += len(want)
    assert checked > 0


@pytest.mark.parametrize("mesh_id", ["2x2", "4x2", "1x2", "pod2x16x16"])
def test_axis_rules_and_batch_and_cache_specs(mesh_id):
    mesh = MESHES[mesh_id]
    jmesh = j_mesh(mesh)
    for kw in ({}, {"seq_shard": True}, {"decode_kv_shard": False}, {"dp_only": True}):
        rules = shd.make_axis_rules(mesh, **kw)
        assert rules == j_shd.make_axis_rules(jmesh, **kw)
        for b in (1, 4, 6, 32, 512):
            batch = {"tokens": torch.zeros((b, 8), dtype=torch.int32),
                     "n": torch.zeros((), dtype=torch.int32)}
            got = shd.batch_pspecs(batch, mesh, rules)
            want = j_shd.batch_pspecs({"tokens": jax.ShapeDtypeStruct((b, 8), jnp.int32),
                                       "n": jax.ShapeDtypeStruct((), jnp.int32)}, jmesh, rules)
            assert got == {k: tuple(v.spec) for k, v in want.items()}
        for shape in ((2, 8, 64, 4, 16), (4, 32, 9, 64), (3, 6, 64, 1, 8)):
            cache = {"kv": {"k": torch.empty(shape, device="meta"),
                            "v": torch.empty(shape, device="meta")}, "pos": torch.zeros(())}
            got = shd.cache_pspecs(cache, mesh, rules)
            want = j_shd.cache_pspecs({"kv": {"k": jax.ShapeDtypeStruct(shape, jnp.float32),
                                              "v": jax.ShapeDtypeStruct(shape, jnp.float32)},
                                       "pos": jax.ShapeDtypeStruct((), jnp.float32)},
                                      jmesh, rules)
            assert _t_specs(got) == _j_specs(want)


def test_placements_name_the_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh((2, 2))
    assert shd.placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert shd.placements((None, "data"), mesh) == (Shard(1), Replicate())
    assert shd.placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert shd.placements((), mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("spec", [("data", "model"), (None, "model"), (("data", "model"), None),
                                  ("model", "data"), ()])
def test_local_blocks_tile_the_leaf_data_major(spec):
    """Each rank's block of a (8, 12) leaf: the (d, m) coordinate's block,
    a dim on both axes data-major (block d * M + m), and the blocks of
    all ranks tile the leaf; shard_tree cuts a whole tree so."""
    mesh = fake_mesh((2, 2))
    t = torch.arange(96.0).reshape(8, 12)
    whole = torch.full_like(t, float("nan"))
    for d in range(2):
        for m in range(2):
            coord = {"data": d, "model": m}
            block = shd.local_slice(t, spec, mesh, coord)
            rows = slice(None)
            cols = slice(None)
            for dim, e in enumerate(spec):
                idx, n = shd.block_index(e, mesh, coord)
                size = t.shape[dim] // n
                sl = slice(idx * size, (idx + 1) * size)
                rows, cols = (sl, cols) if dim == 0 else (rows, sl)
            assert torch.equal(block, t[rows, cols])
            whole[rows, cols] = block
            tree = shd.shard_tree({"w": t, "s": 3}, {"w": spec, "s": ()}, mesh, coord)
            assert torch.equal(tree["w"], block) and tree["s"] == 3
    assert torch.equal(whole, t)
    if spec == (("data", "model"), None):
        assert torch.equal(shd.local_slice(t, spec, mesh, {"data": 1, "model": 0}), t[4:6])


# --------------------------------------------------------------------------
# MoE routing groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_routing_groups_match_the_reference(groups, monkeypatch):
    """phi3.5-moe-smoke's MoE widths (D 64, F 128, E 4, top-2) over a
    (4, 8) batch split into ``groups`` routing groups of contiguous rows:
    each group's routing identical to the reference's
    ``MoE.apply(num_groups=G)``, the output and the load-balance loss (the
    mean over groups) at rtol 1e-5."""
    cfg = get_config("phi3.5-moe-42b-a6.6b-smoke")
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    jmod = JMoE(d, f, e, k, dtype=jnp.float32)
    jp = jmod.init(jax.random.PRNGKey(groups))
    x = np.random.default_rng(groups).normal(0, 1, (4, 8, d)).astype(np.float32)
    calls = []
    real_top_k = jax.lax.top_k

    def recording_top_k(a, kk):
        out = real_top_k(a, kk)
        calls.append(out[1])
        return out

    @jax.jit
    def j_apply(p, xj):
        jctx = JContext()
        out = jmod.apply(p, xj, jctx, num_groups=groups)
        return out, jctx.losses["moe_load_balance"], calls[0], calls[1]

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jout, jaux, j_top, j_sel = j_apply(jp, jnp.asarray(x))
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)

    routed = []
    real_route = t_moe.MoE.route
    monkeypatch.setattr(t_moe.MoE, "route", lambda self, p, c: routed.append(
        real_route(self, p, c)) or routed[-1])
    tmod = t_moe.MoE(d, f, e, k)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ctx = Context()
    tout = tmod.apply(tp, torch.from_numpy(x), ctx, num_groups=groups)
    assert len(routed) == groups
    np.testing.assert_array_equal(np.stack([r[0].numpy() for r in routed]), np.asarray(j_top))
    np.testing.assert_array_equal(np.stack([r[1].numpy() for r in routed]), np.asarray(j_sel))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ctx.losses["moe_load_balance"].numpy(), np.asarray(jaux),
                               rtol=1e-5)


def test_a_mesh_without_the_rules_axes_raises():
    ctx = Context(mesh={"data": 2, "model": 1},
                  axis_rules=dict(shd.make_axis_rules({"data": 2}), batch=("data", "pod")))
    with pytest.raises(KeyError):
        ctx.dp_size
