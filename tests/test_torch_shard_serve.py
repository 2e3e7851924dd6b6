"""The port's sharded serving steps over four gloo ranks on the CPU, mesh
(2, 2), against the reference's one-device decode.

The reference's own test of its weight-stationary MoE decode
(``tests/test_dist.py::test_moe_weight_stationary_decode_matches_single_device``)
is red under the installed jax 0.9.0 (``ShardingTypeError`` in
``Embedding.apply``'s ``jnp.take``, ``src/repro/nn/layers.py:352``), so
the target it names is the yardstick: its set-up, run here once in a
subprocess on one device (phi3.5-moe-smoke from ``PRNGKey(0)``, b 4,
s_max 16, an 8-token prefill into a float32 cache, one decode step of the
prefill's argmax tokens).

Each rank prefills the same cache on one device, then decodes with the
parameters cut by ``param_pspecs(serve=True)`` (experts: E over
``model``, the contracting dims over ``data``) and its own rows of the
cache: the MoE takes the weight-stationary dispatch (the whole batch's
tokens gathered, one routing group, two sums over ``data``).  Its logits
are held to the reference's at rtol/atol 2e-4 and ``make_decode_step``'s
tokens to the argmax; with int8 weights and an int8 cache, to the port's
own one-device decode at the same tolerance.  A sharded prefill (each
data rank's rows one routing group) is held to the port's one-device
prefill with two groups.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist_ranks import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.registry import get_config
from repro.nn.module import Context

def flat(tree, prefix, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {f"{prefix}/{path}": np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix, f"{path}.{k}" if path else str(k)))
    return out

cfg = get_config("phi3.5-moe-42b-a6.6b-smoke")
model = cfg.build(dtype=jnp.float32, remat="off")
params = model.init(jax.random.PRNGKey(0))
b, s_max = 4, 16
toks = jnp.arange(b * 8, dtype=jnp.int32).reshape(b, 8) % cfg.vocab
cache0 = model.init_cache(b, s_max, quantized_kv=False, kv_dtype=jnp.float32)
ctx = Context(train=False)
lg, cache = model.apply(params, toks, ctx, cache=cache0, decode=True)
nxt = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
ref, _ = model.apply(params, nxt, ctx, cache=cache, decode=True)
out = flat(params, "params")
out.update(toks=np.asarray(toks), nxt=np.asarray(nxt), ref=np.asarray(ref))
np.savez(sys.argv[1], **out)
print("reference ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(d / "reference.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = dict(np.load(d / "reference.npz"))
    return ref, launch(4, "shard_serve", d / "reference.npz", d)


def _rows(rank):
    return slice((rank // 2) * 2, (rank // 2 + 1) * 2)


@pytest.mark.parametrize("rank", range(4))
def test_weight_stationary_decode_follows_the_single_device_decode(runs, rank):
    ref, ranks = runs
    want = ref["ref"][_rows(rank)]
    got = ranks[rank]["float/logits"]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the step's tokens are the whole batch's on every rank (one gather over data)
    np.testing.assert_array_equal(ranks[rank]["float/next"][:, 0], ref["ref"][:, -1].argmax(-1))


@pytest.mark.parametrize("rank", range(4))
def test_int8_weight_decode_follows_the_ports_one_device(runs, rank):
    _, ranks = runs
    r = ranks[rank]
    np.testing.assert_allclose(r["int8/logits"], r["int8/one"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(r["int8/next"][:, 0], r["int8/one_next"])


def test_the_decode_sums_activations_over_data(runs):
    """The weight-stationary dispatch moves activations, not expert
    weights: two sums over ``data`` a layer, equal on every rank."""
    _, ranks = runs
    sums = {int(r["float/psum_bytes"]) for r in ranks}
    assert len(sums) == 1 and sums.pop() > 0


@pytest.mark.parametrize("rank", range(4))
def test_sharded_prefill_routes_each_data_ranks_rows(runs, rank):
    _, ranks = runs
    r = ranks[rank]
    np.testing.assert_allclose(r["prefill/logits"], r["prefill/one"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", range(4))
def test_the_all_reduce_form_equals_the_native_collectives(runs, rank):
    """gloo on a card carries only all-reduce: a gather there is an
    all-reduce of a zero-filled buffer (as int32 words where its bytes
    allow) and a reduce-scatter an all-reduce and a slice.  Forced on the
    CPU, both give the native collectives' bits: -0.0 and NaN kept in
    float32, an odd int8 block summed in its own type."""
    _, ranks = runs
    r = ranks[rank]
    keys = sorted(k[len("forms/native/"):] for k in r if k.startswith("forms/native/"))
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_array_equal(r[f"forms/all_reduce/{k}"], r[f"forms/native/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("refused", ["whisper-tiny-smoke", "mamba-130m-smoke", "rwkv6-7b-smoke",
                                     "jamba-v0.1-52b-smoke", "int4", "int2-block", "embeds",
                                     "merge"])
def test_the_engine_under_a_mesh_is_the_next_slice(refused):
    """``ServeEngine(mesh=...)`` serves the causal attention family (the
    ``mesh_serve`` suites); what it does not serve yet raises, naming the
    next item: recurrent, hybrid and EncDec archs, packed sub-int8
    weights, a VLM prefix, and a mixed step's recurrent-state merge (audit
    mode's health flags serve there since the page pool's slice:
    ``test_torch_mesh_serve_hardened.py``)."""
    import torch

    from repro_torch.dist.sharding import make_axis_rules
    from repro_torch.models.registry import get_config
    from repro_torch.serve.engine import ServeEngine, make_mixed_step, make_prefill_step
    from repro_torch.serve.slot_state import merge_inactive

    mesh = {"data": 2, "model": 2}
    rules = make_axis_rules(mesh)
    arch = refused if refused.endswith("-smoke") else "smollm-135m-smoke"
    model = get_config(arch).build()
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item 3b\.7"):
        if refused == "embeds":
            make_prefill_step(model, mesh=mesh, axis_rules=rules)(
                {}, torch.zeros(1, 2, dtype=torch.int32), None, embeds=torch.zeros(1, 1, 64))
        elif refused == "merge":
            make_mixed_step(model, mesh=mesh, axis_rules=rules, merge=merge_inactive)
        else:
            ServeEngine(model, {}, max_len=16, batch_slots=2, device="cpu", mesh=mesh,
                        axis_rules=rules, weight_quant=False if arch == refused else refused)
