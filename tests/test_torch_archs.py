"""Port parity for the dense-family archs: glm4-9b (QKV bias), qwen2.5-14b
(an untied LM head), command-r-plus-104b (LayerNorm and the parallel
attention + FFN block) and internvl2-2b (a stub vision prefix), with
smollm-135m beside them where ``tests/test_archs.py`` parametrizes every
arch.  Each ``-smoke`` config runs the reference's and the port's model on
the reference's parameters carried over by ``repro_torch.convert``:

* the forward's logits at rtol 1e-5, float and at int8 weights (internvl
  with 8 prefix embeddings: logits (B, S + 8, V));
* a prefill through each package's ``make_prefill_step`` (the prefix
  included) and three greedy decode steps over the cache;
* one SGD (momentum 0.9) train step: the loss at rtol 1e-5 and the updated
  parameters at the train tests' tolerance (internvl's prefix unscored);
* ``integerize_weights_only``: every leaf equal to the reference's (the
  untied head's kernel quantized, QKV biases and LayerNorm's bias float),
  and the slab-by-slab quantizer equal to the whole-leaf one bit for bit;
* ``param_count()`` and the real parameter tree, and ``get_config`` field
  for field at full and smoke size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.integerize import integerize_weights_only as j_integerize
from repro.core.qformat import QTensor as JQ
from repro.models.registry import get_config as j_get_config
from repro.nn.module import Context as JContext
from repro.optim import sgd as j_sgd
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro.train import trainer as j_trainer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import integerize as t_integerize
from repro_torch.core import qformat
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.core.qformat import QTensor
from repro_torch.models.registry import get_config
from repro_torch.nn.module import Context
from repro_torch.optim import sgd
from repro_torch.serve.engine import make_prefill_step
from repro_torch.train import trainer

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
NEW_ARCHS = ["glm4-9b", "qwen2.5-14b", "command-r-plus-104b", "internvl2-2b"]
ARCHS = ["smollm-135m"] + NEW_ARCHS


def to_numpy(tree):
    """The reference's tree as numpy leaves; QTensors become q/n/width dicts."""
    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def leaves(tree):
    """Leaves in sorted-key order (jax's trees sort their dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


_made = {}


def smoke(arch):
    """(jax model, jax params, port model, port params, config) of
    ``arch``-smoke, memoized: the reference's init, converted."""
    if arch not in _made:
        jcfg = j_get_config(arch + "-smoke")
        jm = jcfg.build(dtype=jnp.float32, remat="off")
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = get_config(arch + "-smoke")
        _made[arch] = (jm, jp, cfg.build(), params_from_numpy(to_numpy(jp), "cpu"), cfg)
    return _made[arch]


def prefix(cfg, b, seed=7):
    """The vision prefix of a vlm (None for the others), seeded."""
    if not cfg.vis_seq:
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, cfg.vis_seq, cfg.d_model)).astype(np.float32)


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def opt(x, fn):
    return None if x is None else fn(x)


@pytest.mark.parametrize("weight_quant", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, weight_quant):
    jm, jp, tm, tp, cfg = smoke(arch)
    if weight_quant:
        jp, tp = j_integerize(jp), integerize_weights_only(tp)
    b, s = 2, 16
    toks, emb = tokens(cfg, b, s), prefix(cfg, b)
    want, _ = jm.apply(jp, jnp.asarray(toks), JContext(), embeds=opt(emb, jnp.asarray))
    got, _ = tm.apply(tp, torch.from_numpy(toks), Context(), embeds=opt(emb, torch.from_numpy))
    assert got.shape == (b, s + cfg.vis_seq, cfg.vocab_padded)
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_match_reference(arch):
    """The prompt (after internvl's prefix) through each package's prefill
    step into a float cache, then three greedy steps: logits at rtol 1e-5,
    the same tokens, the same cache contents."""
    jm, jp, tm, tp, cfg = smoke(arch)
    b, s, max_len = 2, 8, 24
    toks, emb = tokens(cfg, b, s, seed=2), prefix(cfg, b, seed=3)
    jc = jm.init_cache(b, max_len, quantized_kv=False, kv_dtype=jnp.float32)
    tc = tm.init_cache(b, max_len, quantized_kv=False, device="cpu")
    jl, jc = j_make_prefill_step(jm)(jp, jnp.asarray(toks), jc, embeds=opt(emb, jnp.asarray))
    tl, tc = make_prefill_step(tm)(tp, torch.from_numpy(toks), tc,
                                   embeds=opt(emb, torch.from_numpy))
    assert tl.shape == (b, cfg.vocab_padded)
    close(tl, jl)
    for c in (np.asarray(tc["body"][0]["kv"]["len"]), np.asarray(jc["body"][0]["kv"]["len"])):
        assert set(c.reshape(-1).tolist()) == {s + cfg.vis_seq}
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc = jm.apply(jp, jnp.asarray(nxt), JContext(), cache=jc, decode=True)
        tl, tc = tm.apply(tp, torch.from_numpy(nxt), Context(), cache=tc, decode=True)
        jl, tl = jl[:, -1], tl[:, -1]
        close(tl, jl)
    for name in ("k", "v"):
        close(tc["body"][0]["kv"][name], jc["body"][0]["kv"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_train_step_matches_reference(arch):
    """One step of SGD at momentum 0.9 from the same parameters and batch:
    the loss at rtol 1e-5, the momentum (the gradient itself after one step
    from zero) and the parameters at the train tests' tolerances."""
    jm, jp, tm, _, cfg = smoke(arch)
    b, s, lr = 2, 16, 0.01
    toks = tokens(cfg, b, s, seed=4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    batch["labels"][:, -1] = -1
    emb = prefix(cfg, b, seed=5)
    if emb is not None:
        batch["embeds"] = emb
    jopt, topt = j_sgd(momentum=0.9), sgd(momentum=0.9)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jnew, jmet = jax.jit(j_trainer.make_train_step(jm, jopt, lr))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_numpy(to_numpy(jp), "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    tnew, tmet = trainer.make_train_step(tm, topt, lr)(tstate, batch)
    assert int(tnew["step"]) == 1
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    assert tmet["accuracy"].item() == float(jmet["accuracy"])
    got_m, want_m = leaves(params_to_numpy(tnew["opt"]["m"])), leaves(jnew["opt"]["m"])
    assert len(got_m) == len(want_m)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max())
    for a, w, g in zip(leaves(params_to_numpy(tnew["params"])), leaves(jnew["params"]),
                       want_m):
        tol = 1e-5 * np.abs(w) + lr * (1e-4 * np.abs(g) + 1e-6 * np.abs(g).max())
        assert (np.abs(a - w) <= tol).all()


def _walk(tree, path=""):
    if isinstance(tree, dict) and not {"q", "n", "width"} <= set(tree):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_integerize_weights_only_matches_reference(arch):
    """Leaf for leaf: every GEMM kernel (the untied ``lm_head`` included) and
    the embedding table quantized to the reference's codes and exponents;
    norms, LayerNorm's ``bias`` and the QKV biases left float."""
    _, jp, _, tp, cfg = smoke(arch)
    want = dict(_walk(to_numpy(j_integerize(jp))))
    got = dict(_walk(params_to_numpy(integerize_weights_only(tp))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            assert isinstance(g, dict), path
            np.testing.assert_array_equal(g["q"], w["q"], err_msg=path)
            np.testing.assert_array_equal(g["n"], w["n"], err_msg=path)
            assert (g["width"], g["channel_axis"]) == (w["width"], w["channel_axis"]), path
        else:
            assert not isinstance(g, dict), path
            np.testing.assert_array_equal(g, w, err_msg=path)
    quantized = {p for p, w in want.items() if isinstance(w, dict)}
    assert all(p.endswith(("/kernel", "/table")) for p in quantized)
    if not cfg.tie_embeddings:
        assert "lm_head/kernel" in quantized
    if cfg.qkv_bias:
        assert {"stack/body/0/mixer/wq/bias", "stack/body/0/mixer/wk/bias"} <= set(want) \
            - quantized
    if cfg.norm == "ln":
        assert {"stack/body/0/norm1/bias", "final_norm/bias"} <= set(want) - quantized
        assert not any("norm2" in p for p in want)        # the parallel block


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(5, 37, 11), (3, 2, 9, 7), (61, 13)])
def test_slab_quantizer_equals_the_whole_leaf(monkeypatch, shape, per_channel):
    """A leaf quantized a few rows (or layers) at a time gives the codes and
    exponents of ``quantize_tensor`` over the whole leaf, bit for bit."""
    rng = np.random.default_rng(sum(shape))
    v = torch.from_numpy((rng.standard_normal(shape) * rng.uniform(
        0.01, 40, shape[:-2] + (1, shape[-1]))).astype(np.float32))
    if per_channel:
        ca = tuple(range(v.ndim - 2)) + (v.ndim - 1,) if v.ndim > 2 else v.ndim - 1
    else:
        ca = None
    want = qformat.quantize_tensor(v, 8, channel_axis=ca)
    monkeypatch.setattr(t_integerize, "_SLAB_ELEMENTS", 40)    # slabs of 1-3 rows
    got = t_integerize._quantize_by_slabs(v, 8, per_channel)
    assert torch.equal(got.q, want.q) and torch.equal(got.n, want.n)
    assert got.channel_axis == want.channel_axis and got.q.dtype == want.q.dtype


def test_release_frees_the_float_leaves_it_quantizes():
    """``release=True`` puts each leaf's codes in the input tree in place of
    its float leaf and leaves the rest (norms, biases) as they were."""
    _, _, _, tp, _ = smoke("qwen2.5-14b")
    tree = params_from_numpy(params_to_numpy(tp), "cpu")
    scale = tree["final_norm"]["scale"]
    out = integerize_weights_only(tree, release=True)
    assert isinstance(tree["lm_head"]["kernel"], QTensor)
    assert tree["lm_head"]["kernel"] is out["lm_head"]["kernel"]
    assert isinstance(tree["stack"]["body"][0]["mixer"]["wq"]["kernel"], QTensor)
    assert tree["final_norm"]["scale"] is scale
    assert not isinstance(tree["stack"]["body"][0]["mixer"]["wq"]["bias"], QTensor)


def test_engine_own_params_converts_the_callers_tree_in_place():
    """``ServeEngine(own_params=True)`` integerizes the tree it is handed in
    place (the caller's containers then hold the codes) and serves the same
    codes as an engine that copies the tree."""
    from repro_torch.serve import ServeEngine

    _, _, tm, tp, _ = smoke("qwen2.5-14b")
    tree = params_from_numpy(params_to_numpy(tp), "cpu")
    own = ServeEngine(model=tm, params=tree, max_len=16, batch_slots=2, weight_quant=True,
                      device="cpu", own_params=True)
    kept = ServeEngine(model=tm, params=tp, max_len=16, batch_slots=2, weight_quant=True,
                       device="cpu")
    assert isinstance(tree["lm_head"]["kernel"], QTensor)
    assert not isinstance(tp["lm_head"]["kernel"], QTensor)
    for a, b in zip(leaves(params_to_numpy(own.params)), leaves(params_to_numpy(kept.params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_tree_match_reference(arch):
    """``param_count()`` equals the reference's at full and smoke size, and
    the port's tree holds the reference's leaves, shape for shape."""
    for size in ("", "-smoke"):
        assert get_config(arch + size).param_count() == j_get_config(arch + size).param_count()
    jm, jp, tm, _, cfg = smoke(arch)
    tree = tm.init(torch.Generator().manual_seed(0), "cpu")
    got = [tuple(x.shape) for x in leaves(params_to_numpy(tree))]
    want = [tuple(x.shape) for x in leaves(to_numpy(jp))]
    assert got == want
    real = sum(int(np.prod(s)) for s in got)
    assert abs(real - cfg.param_count()) / real < 0.15


@pytest.mark.parametrize("arch", ARCHS + ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_get_config_field_for_field(arch):
    """Every field of the port's config equals the reference's, at full and
    smoke size (the MoE fields compared, not defaulted); the reference's
    fields the port has no use for (EncDec's ``enc_seq`` aside) hold their
    defaults for these archs."""
    defaults = {f.name: f.default for f in dataclasses.fields(JArchConfig)}
    for size in ("", "-smoke"):
        got, want = get_config(arch + size), j_get_config(arch + size)
        names = {f.name for f in dataclasses.fields(got)}
        for name in names:
            assert getattr(got, name) == getattr(want, name), (arch + size, name)
        for f in dataclasses.fields(want):
            if f.name not in names and f.name != "enc_seq":
                assert getattr(want, f.name) == defaults[f.name], (arch + size, f.name)
        assert got.vocab_padded == want.vocab_padded
