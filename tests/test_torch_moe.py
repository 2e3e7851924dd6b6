"""Port parity for the MoE and hybrid slice's modules: ``nn/moe.py``'s
``MoE`` and its routing, and the cases ``tests/test_archs.py`` runs for
phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b (a dense prelude layer and a shared
expert) and jamba-v0.1-52b (Mamba and attention, MoE every other layer),
each on the reference's parameters carried over by ``repro_torch.convert``
and the same numpy inputs:

* ``exp_f32`` and ``softmax_f32`` equal to ``jnp.exp`` and
  ``jax.nn.softmax`` bit for bit (XLA's CPU exponential fuses its
  multiply-adds; ``torch.exp`` differs from it in one value in ten);
* ``MoE.apply`` at rtol 1e-5 (atol 1e-5), float and on int8 experts, with
  and without the shared expert (one routing group, as on one card); its
  auxiliary loss at rtol 1e-5;
* the routing: each token's experts (``top_idx``) and each expert's tokens
  (``sel_idx``) equal to what the reference's ``jax.lax.top_k`` calls
  return inside its own ``MoE.apply``, on random inputs at E = 4 and 16
  and on constructed bf16 ties (duplicated router columns, duplicated
  tokens, a zero router), and capacity filled with tokens dropped;
* ``integerize_weights_only`` on the 3-D (jamba) and 4-D (stacked phi,
  kimi) expert leaves: codes and exponents bit for bit, the router float,
  and the slab quantizer equal to the whole-leaf one;
* the archs: forward logits (float and int8 weights) at rtol 1e-5 (atol
  1e-5), the load-balance loss at rtol 1e-5, a prefill and three greedy
  decode steps, ``test_smoke_qat_grads`` for phi and jamba (finite
  gradients, the loss at rtol 1e-5), every quant site's scoped name
  (kimi's prelude ``stack/pre0``), ``param_count`` and
  ``active_param_count`` at full and smoke size, the parameter tree shape
  for shape and the reference's tree carried across and back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models.registry import get_config as j_get_config
from repro.nn.module import Context as JContext
from repro.nn.module import train_context as j_train_context
from repro.nn.moe import MoE as JMoE
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import integerize as t_integerize
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.registry import get_config
from repro_torch.nn import moe as t_moe
from repro_torch.nn.module import Context, train_context, tree_leaves, tree_map
from repro_torch.serve.engine import make_prefill_step
from test_torch_archs import leaves, smoke, to_numpy, tokens

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


_int8 = {}


def j_int8(arch):
    """The reference's int8 weight-only tree of ``arch``-smoke, memoized and
    jitted (op by op it takes seconds an arch; the codes are the same)."""
    if arch not in _int8:
        _int8[arch] = jax.jit(j_integerize)(smoke(arch)[1])
    return _int8[arch]


# ---------------------------------------------------------------------------
# the softmax the routing compares
# ---------------------------------------------------------------------------

def test_exp_f32_is_xla_exp_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.exponential(4.0, 400_000), rng.uniform(-90, 89, 100_000),
                        np.array([0.0, -0.0, -87.8, 88.0, -1e-30, 1e-30, -0.34657359])])
    x = x.astype(np.float32)
    got = t_moe.exp_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    mid = x > -87.0          # XLA flushes what would be subnormal; softmax never meets it
    np.testing.assert_array_equal(got[mid], want[mid])
    assert np.mean(torch.exp(torch.from_numpy(x)).numpy() != want) > 0.05


@pytest.mark.parametrize("e", [4, 16])
def test_softmax_f32_is_jax_softmax_bit_for_bit(e):
    logits = np.random.default_rng(e).normal(0, 2, (4000, e)).astype(np.float32)
    got = t_moe.softmax_f32(torch.from_numpy(logits))
    want = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


def test_top_k_stable_takes_the_lower_index_on_ties():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (500, 12)).astype(np.float32)      # ties everywhere
    for k in (1, 2, 5):
        idx = t_moe.top_k_indices(torch.from_numpy(x).to(torch.bfloat16), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(
            jnp.asarray(x, jnp.bfloat16), k)[1]))


# ---------------------------------------------------------------------------
# the module and its routing
# ---------------------------------------------------------------------------

def _moe_pair(e, k, shared, seed):
    jmod = JMoE(64, 32, e, k, n_shared_experts=shared, dtype=jnp.float32)
    jp = jmod.init(jax.random.PRNGKey(seed))
    tmod = t_moe.MoE(64, 32, e, k, n_shared_experts=shared)
    return jmod, jp, tmod


def _run_both(jmod, jp, tmod, x, monkeypatch, int8=False):
    """Each package's MoE on ``x``: (out, aux, (top_idx, sel_idx)) per
    package, the reference's (jitted, as its engine runs it) routing read
    from its own ``jax.lax.top_k`` calls (one routing group: its leading
    axis dropped) and the port's from ``MoE.route``."""
    if int8:
        jp = jax.jit(j_integerize)({"moe": jp})["moe"]
    tp = params_from_numpy(to_numpy(jp), "cpu")
    calls = []
    real_top_k = jax.lax.top_k

    def recording_top_k(a, k):
        out = real_top_k(a, k)
        calls.append(out[1])
        return out

    @jax.jit
    def j_apply(p, xj):
        jctx = JContext()
        out = jmod.apply(p, xj, jctx)
        return out, jctx.losses["moe_load_balance"], calls[0], calls[1]

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jout, jaux, j_top, j_sel = j_apply(jp, jnp.asarray(x))
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    routed = []
    real_route = t_moe.MoE.route

    def recording_route(self, probs_sel, cap):
        out = real_route(self, probs_sel, cap)
        routed.append(out)
        return out

    monkeypatch.setattr(t_moe.MoE, "route", recording_route)
    tctx = Context()
    tout = tmod.apply(tp, torch.from_numpy(x), tctx)
    return ((tout, tctx.losses["moe_load_balance"], routed[0]),
            (jout, jaux, (np.asarray(j_top)[0], np.asarray(j_sel)[0])))


def _check(got, want):
    (tout, taux, (t_top, t_sel)), (jout, jaux, (j_top, j_sel)) = got, want
    np.testing.assert_array_equal(t_top.numpy(), j_top)
    np.testing.assert_array_equal(t_sel.numpy(), j_sel)
    close(tout.detach().numpy(), jout)
    close(taux.detach().numpy(), jaux)
    return t_top.numpy()


@pytest.mark.parametrize("e,k,shared,b,s", [
    (4, 2, 0, 2, 16), (4, 2, 1, 4, 8), (16, 2, 0, 4, 64), (16, 2, 0, 8, 1), (8, 3, 1, 1, 72)],
    ids=["e4", "e4-shared", "e16-256tok", "e16-decode", "e8-top3-ragged"])
def test_moe_matches_reference(e, k, shared, b, s, monkeypatch):
    jmod, jp, tmod = _moe_pair(e, k, shared, seed=e + s)
    x = np.random.default_rng(e * s).normal(0, 1, (b, s, 64)).astype(np.float32)
    _check(*_run_both(jmod, jp, tmod, x, monkeypatch))


def test_moe_int8_experts_match_reference(monkeypatch):
    jmod, jp, tmod = _moe_pair(4, 2, 1, seed=5)
    x = np.random.default_rng(5).normal(0, 1, (4, 8, 64)).astype(np.float32)
    _check(*_run_both(jmod, jp, tmod, x, monkeypatch, int8=True))


@pytest.mark.parametrize("tie", ["duplicate-columns", "duplicate-tokens", "zero-router"])
def test_routing_ties_match_reference(tie, monkeypatch):
    """bf16 ties broken as ``jax.lax.top_k`` breaks them: the lower expert
    index first (duplicated router columns give equal probabilities, a zero
    router equal ones everywhere), and the lower token index first for an
    expert's capacity (duplicated tokens give equal gates)."""
    jmod, jp, tmod = _moe_pair(8, 2, 0, seed=9)
    x = np.random.default_rng(9).normal(0, 1, (4, 8, 64)).astype(np.float32)
    kern = np.asarray(jp["router"]["kernel"]).copy()
    if tie == "duplicate-columns":
        kern[:, 1], kern[:, 5], kern[:, 6] = kern[:, 0], kern[:, 4], kern[:, 4]
    elif tie == "zero-router":
        kern[:] = 0.0
    else:
        x[:, 4:] = x[:, :4]
        x[2:] = x[:2]
    jp = dict(jp, router={"kernel": jnp.asarray(kern)})
    got, want = _run_both(jmod, jp, tmod, x, monkeypatch)
    top = _check(got, want)
    if tie == "zero-router":
        assert (top == np.array([0, 1])).all()      # every token: experts 0 and 1
    if tie == "duplicate-columns":
        pairs = {tuple(r) for r in top}
        assert not any(p in pairs for p in ((1, 0), (5, 4), (6, 4), (6, 5)))


def test_routing_fills_capacity_and_drops_the_rest(monkeypatch):
    """A decode step of 4 tokens at E = 4, top-2: capacity ceil(4*2/4*1.25)
    = 3, so an expert that 4 tokens choose keeps 3 of them by gate and the
    fourth loses that expert's output; the port drops the reference's."""
    jmod, jp, tmod = _moe_pair(4, 2, 0, seed=2)
    kern = np.asarray(jp["router"]["kernel"]).copy()
    kern[:, 0] += 3.0                  # every token wants expert 0
    jp = dict(jp, router={"kernel": jnp.asarray(kern)})
    x = np.abs(np.random.default_rng(2).normal(0, 1, (4, 1, 64))).astype(np.float32)
    assert tmod.capacity(4) == 3
    got, want = _run_both(jmod, jp, tmod, x, monkeypatch)
    top = _check(got, want)
    assert (top[:, 0] == 0).all()
    sel = got[2][1].numpy()
    assert sel.shape == (4, 3) and len(set(sel[0].tolist())) == 3


# ---------------------------------------------------------------------------
# int8 expert codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_integerize_expert_leaves_bit_for_bit(arch, monkeypatch):
    """Every leaf of ``integerize_weights_only`` equal to the reference's:
    the expert stacks (4-D under phi's and kimi's stacked body, 3-D in
    jamba's single period) with one exponent per (layer, expert, column),
    the router float; then the slab quantizer at a slab of one expert
    gives the same codes and exponents."""
    jm, jp, tm, tp, cfg = smoke(arch)
    want = to_numpy(j_int8(arch))
    got = params_to_numpy(integerize_weights_only(tp))
    ffn = [p["ffn"] for p in got["stack"]["body"] if "experts" in p["ffn"]]
    assert ffn and isinstance(ffn[0]["router"]["kernel"], np.ndarray)
    nd = ffn[0]["experts"]["w_gate"]["kernel"]["q"].ndim
    assert nd == (3 if arch.startswith("jamba") else 4)
    assert ffn[0]["experts"]["w_gate"]["kernel"]["n"].shape[-2] == 1
    _same_tree(got, want)
    monkeypatch.setattr(t_integerize, "_SLAB_ELEMENTS", 64 * 128)
    _same_tree(params_to_numpy(integerize_weights_only(tp)), want)


def _same_tree(got, want, path=""):
    if isinstance(want, dict) and "q" in want:
        np.testing.assert_array_equal(got["q"], want["q"], err_msg=path)
        np.testing.assert_array_equal(np.broadcast_to(got["n"], want["n"].shape),
                                      want["n"], err_msg=path)
        assert got["q"].dtype == want["q"].dtype and got["width"] == want["width"], path
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


# ---------------------------------------------------------------------------
# the archs (tests/test_archs.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_quant", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_loss_match_reference(arch, weight_quant):
    jm, jp, tm, tp, cfg = smoke(arch)
    if weight_quant:
        jp, tp = j_int8(arch), integerize_weights_only(tp)
    toks = tokens(cfg, 2, 16)

    @jax.jit
    def j_forward(p, x):
        jctx = JContext()
        return jm.apply(p, x, jctx)[0], jctx.losses

    want, jlosses = j_forward(jp, jnp.asarray(toks))
    tctx = Context()
    got, _ = tm.apply(tp, torch.from_numpy(toks), tctx)
    assert got.shape == (2, 16, cfg.vocab_padded)
    close(got, want)
    assert sorted(tctx.losses) == sorted(jlosses) == ["moe_load_balance"]
    close(tctx.losses["moe_load_balance"], jlosses["moe_load_balance"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """The port's ``make_prefill_step`` into a KV (and, for jamba,
    recurrent) cache against the reference's model over the same cache
    (its prefill step is the same apply, jitted), then three greedy decode
    steps: logits and tokens equal to the reference's."""
    jm, jp, tm, tp, cfg = smoke(arch)
    b, s, max_len = 2, 8, 24
    toks = tokens(cfg, b, s, seed=4)
    jcache = jm.init_cache(b, max_len, quantized_kv=False, kv_dtype=jnp.float32)
    tcache = tm.init_cache(b, max_len, quantized_kv=False, device="cpu")
    assert sorted(tcache) == sorted(jcache)
    j_step = jax.jit(lambda p, x, c: jm.apply(p, x, JContext(), cache=c, decode=True))
    jl, jcache = j_step(jp, jnp.asarray(toks), jcache)
    jl = jl[:, -1]
    tl, tcache = make_prefill_step(tm)(tp, torch.from_numpy(toks), tcache)
    close(tl, jl)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
        jl, jcache = j_step(jp, jnp.asarray(nxt), jcache)
        tl, tcache = tm.apply(tp, torch.from_numpy(nxt), Context(), cache=tcache, decode=True)
        jl, tl = jl[:, -1], tl[:, -1]
        close(tl, jl)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"])
def test_smoke_qat_grads(arch):
    """An int8 QAT loss (the expert stacks fake-quantized per column, the
    ``experts/in`` and ``experts/out`` sites on the grid) and its straight-
    through gradients: finite, the embedding's nonzero, and the loss at
    rtol 1e-5 of the reference's."""
    jm, jp, tm, tp, cfg = smoke(arch)
    toks = np.arange(32, dtype=np.int32).reshape(2, 16) % cfg.vocab
    jloss = jax.jit(lambda p, t: jm.loss(p, {"tokens": t, "labels": t}, j_train_context(
        JQuantPolicy.int8_qat(), rng=jax.random.PRNGKey(1)))[0])(jp, jnp.asarray(toks))
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tt = torch.from_numpy(toks)
    ctx = train_context(QuantPolicy.int8_qat(), rng=torch.Generator().manual_seed(1))
    loss, _ = tm.loss(tp, {"tokens": tt, "labels": tt}, ctx)
    loss.backward()
    grads = [t.grad for t in tree_leaves(tp)]
    assert bool(torch.isfinite(loss)) and all(g is not None for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(tp["embed"]["table"].grad.abs().max()) > 0
    assert any(k.endswith("experts/in") for k in ctx.stats)
    close(loss.detach().numpy(), jloss)


@pytest.mark.parametrize("arch", ARCHS)
def test_site_names_match_reference(arch):
    """Every quant site's scoped name under an int8 QAT loss equal to the
    reference's (traced, not run): kimi's prelude layer is ``stack/pre0``,
    the body's stacked positions ``stack/p{i}``."""
    jm, jp, tm, tp, cfg = smoke(arch)
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % cfg.vocab
    names = []

    def j_loss(p, t):
        jctx = j_train_context(JQuantPolicy.int8_qat(), rng=jax.random.PRNGKey(1))
        loss = jm.loss(p, {"tokens": t, "labels": t}, jctx)[0]
        names.extend(jctx.stats)
        return loss

    jax.eval_shape(j_loss, jp, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    ctx = train_context(QuantPolicy.int8_qat(), rng=torch.Generator().manual_seed(1))
    tm.loss(tp, {"tokens": tt, "labels": tt}, ctx)
    assert sorted(ctx.stats) == sorted(names)
    assert any("/stack/pre0/" in k for k in names) == (cfg.first_k_dense > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_tree_match_reference(arch):
    for size in ("", "-smoke"):
        got, want = get_config(arch + size), j_get_config(arch + size)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    jm, jp, tm, _, cfg = smoke(arch)
    tree = tm.init(torch.Generator().manual_seed(0), "cpu")
    got = [tuple(x.shape) for x in leaves(params_to_numpy(tree))]
    assert got == [tuple(x.shape) for x in leaves(to_numpy(jp))]
    real = sum(int(np.prod(s)) for s in got)
    assert abs(real - cfg.param_count()) / real < 0.15
    assert ("prelude" in tree["stack"]) == (cfg.first_k_dense > 0)
    back = params_to_numpy(params_from_numpy(to_numpy(jp), "cpu"))
    for g, w in zip(leaves(back), leaves(to_numpy(jp))):
        np.testing.assert_array_equal(g, w)


def test_block_placement_follows_the_reference():
    """MoE at i >= first_k_dense with i = moe_offset (mod moe_every), dense
    layers at ``d_ff_dense``; kimi's first layer is the prelude."""
    for arch in ARCHS:
        cfg = get_config(arch)
        jstack = j_get_config(arch).build(dtype=jnp.float32).stack
        tstack = cfg.build().stack
        tpre = tstack.prelude.body if tstack.prelude else ()
        assert len(tpre) == len(jstack.prelude) == cfg.first_k_dense
        assert tstack.n_periods == jstack.n_periods and tstack.n_layers == cfg.n_layers
        for tb, jb in zip(tpre + tstack.body, jstack.prelude + jstack.body):
            assert (tb.mixer, tb.ffn, tb.d_ff, tb.n_experts, tb.top_k, tb.n_shared_experts) \
                == (jb.mixer, jb.ffn, jb.d_ff, jb.n_experts, jb.top_k, jb.n_shared_experts)
    jamba = get_config("jamba-v0.1-52b").build().stack
    assert [b.ffn for b in jamba.body] == ["gated", "moe"] * 4
    assert [b.mixer for b in jamba.body] == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    kimi = get_config("kimi-k2-1t-a32b").build().stack
    assert kimi.prelude.body[0].ffn == "gated" and kimi.prelude.body[0].d_ff == 18432
    assert get_config("kimi-k2-1t-a32b-smoke").d_ff_dense == 128
