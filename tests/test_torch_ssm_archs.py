"""Port parity for the recurrent archs, mamba-130m (Mamba mixers, gated FFN)
and rwkv6-7b (RWKV-6 time-mix and channel-mix, LayerNorm): the cases
``tests/test_archs.py`` runs for them, each ``-smoke`` config on the
reference's parameters carried over by ``repro_torch.convert``:

* the forward's logits, float and at int8 weights;
* a prefill through each package's ``make_prefill_step`` into a recurrent
  cache, then three greedy decode steps: logits, tokens and every state
  leaf;
* one SGD (momentum 0.9) train step (plain autograd through the scans):
  the loss at rtol 1e-5, the momentum and parameters at ``GRAD_TOL``;
* ``test_smoke_qat_grads[rwkv6-7b]``: an int8 QAT loss and its gradients,
  finite, with the loss at rtol 1e-5 of the reference's;
* ``integerize_weights_only`` leaf for leaf (the conv kernel included),
  ``param_count()`` at full and smoke size, the parameter tree shape for
  shape, and ``get_config`` field for field.

Logits are held at rtol 1e-5 with an atol of 1e-5 for mamba and 1e-4 for
rwkv6-7b.  RWKV-6's per-head group norm (16 channels at smoke size, eps
1e-5) divides by the head's standard deviation, up to 1/sqrt(1e-5) = 316
where a head's output is nearly constant, and the reference's scan body is
compiled with its multiply-adds contracted into FMAs while PyTorch rounds
each product: the modules agree at 1e-5 (``test_torch_ssm.py``), and two
layers of that gain carry a difference of an ulp to about 5e-5 in the
logits.  Greedy tokens are held equal.  For the same reason the train
step's gradients are held at rtol 1e-4 and an atol of 1e-6 of the leaf's
largest for mamba (the train tests' tolerance), and at 1e-3 and 1e-5 for
rwkv6-7b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.integerize import integerize_weights_only as j_integerize
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models.registry import get_config as j_get_config
from repro.nn.module import Context as JContext
from repro.nn.module import train_context as j_train_context
from repro.optim import sgd as j_sgd
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro.train import trainer as j_trainer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.registry import get_config
from repro_torch.nn.module import Context, train_context
from repro_torch.optim import sgd
from repro_torch.serve.engine import make_prefill_step
from repro_torch.train import trainer
from test_torch_archs import _walk, leaves, smoke, to_numpy, tokens

torch.set_num_threads(2)
ARCHS = ["mamba-130m", "rwkv6-7b"]
LOGIT_ATOL = {"mamba-130m": 1e-5, "rwkv6-7b": 1e-4}
# (rtol, atol as a share of the leaf's largest |gradient|)
GRAD_TOL = {"mamba-130m": (1e-4, 1e-6), "rwkv6-7b": (1e-3, 1e-5)}
STATE_KEYS = {"mamba-130m": {"ssm": ("h", "conv")},
              "rwkv6-7b": {"ssm": ("s", "shift"), "cm": ("shift",)}}


def close_logits(arch, got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=LOGIT_ATOL[arch])


@pytest.mark.parametrize("weight_quant", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, weight_quant):
    jm, jp, tm, tp, cfg = smoke(arch)
    if weight_quant:
        jp, tp = j_integerize(jp), integerize_weights_only(tp)
    toks = tokens(cfg, 2, 16)
    want, _ = jm.apply(jp, jnp.asarray(toks), JContext())
    got, _ = tm.apply(tp, torch.from_numpy(toks), Context())
    assert got.shape == (2, 16, cfg.vocab_padded)
    assert bool(torch.isfinite(got).all())
    close_logits(arch, got, want)
    np.testing.assert_array_equal(torch.argmax(got, -1).numpy(),
                                  np.asarray(jnp.argmax(want, -1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_match_reference(arch):
    """The prompt through each package's prefill step into a recurrent cache
    (``quantized_kv`` has nothing to quantize there), then three greedy
    steps: logits, the same tokens, every state leaf at rtol 1e-5."""
    jm, jp, tm, tp, cfg = smoke(arch)
    b, s, max_len = 2, 8, 24
    toks = tokens(cfg, b, s, seed=2)
    jc = jm.init_cache(b, max_len, quantized_kv=True, kv_dtype=jnp.float32)
    tc = tm.init_cache(b, max_len, quantized_kv=True, device="cpu")
    jl, jc = j_make_prefill_step(jm)(jp, jnp.asarray(toks), jc)
    tl, tc = make_prefill_step(tm)(tp, torch.from_numpy(toks), tc)
    assert tl.shape == (b, cfg.vocab_padded)
    close_logits(arch, tl, jl)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc = jm.apply(jp, jnp.asarray(nxt), JContext(), cache=jc, decode=True)
        tl, tc = tm.apply(tp, torch.from_numpy(nxt), Context(), cache=tc, decode=True)
        jl, tl = jl[:, -1], tl[:, -1]
        close_logits(arch, tl, jl)
    assert list(tc) == ["body"] and sorted(tc["body"][0]) == sorted(STATE_KEYS[arch])
    for node, keys in STATE_KEYS[arch].items():
        for k in keys:
            got, want = tc["body"][0][node][k], jc["body"][0][node][k]
            assert tuple(got.shape) == want.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                       atol=LOGIT_ATOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_train_step_matches_reference(arch):
    """One step of SGD at momentum 0.9 from the same parameters and batch:
    the loss at rtol 1e-5, the momentum (the gradient itself after one step
    from zero) at ``GRAD_TOL`` and the parameters accordingly."""
    jm, jp, tm, _, cfg = smoke(arch)
    b, s, lr = 2, 16, 0.01
    toks = tokens(cfg, b, s, seed=4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    batch["labels"][:, -1] = -1
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
    got_m, want_m = leaves(params_to_numpy(tnew["opt"]["m"])), leaves(jnew["opt"]["m"])
    assert len(got_m) == len(want_m)
    rtol, share = GRAD_TOL[arch]
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=share * np.abs(w).max())
    for a, w, g in zip(leaves(params_to_numpy(tnew["params"])), leaves(jnew["params"]),
                       want_m):
        tol = 1e-5 * np.abs(w) + lr * (rtol * np.abs(g) + share * np.abs(g).max())
        assert (np.abs(a - w) <= tol).all()


def test_smoke_qat_grads_rwkv():
    """``test_smoke_qat_grads[rwkv6-7b]``: int8 QAT fake-quant forward and
    the straight-through backward through the scans give a finite loss
    (equal to the reference's at rtol 1e-5) and finite gradients, the
    embedding's nonzero."""
    jm, jp, tm, tp, cfg = smoke("rwkv6-7b")
    toks = np.arange(2 * 16, dtype=np.int32).reshape(2, 16) % cfg.vocab
    batch = {"tokens": toks, "labels": toks}
    jloss = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          j_train_context(JQuantPolicy.int8_qat(),
                                          rng=jax.random.PRNGKey(1)))[0])
    params = params_from_numpy(to_numpy(jp), "cpu")
    for leaf in leaves_t(params):
        leaf.requires_grad_(True)
    loss = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   train_context(QuantPolicy.int8_qat(), rng=torch.Generator().manual_seed(1)))[0]
    loss.backward()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    grads = [leaf.grad for leaf in leaves_t(params)]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert float(params["embed"]["table"].grad.abs().max()) > 0


def leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_t(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_t(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_integerize_weights_only_matches_reference(arch):
    """Leaf for leaf: every projection kernel and the embedding table to the
    reference's codes and exponents, the stacked conv kernel (L, K, 1,
    d_inner) with one exponent per (layer, tap, channel); ``dt_proj``, the
    norms and the recurrent mixers' small leaves float."""
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
    mixer = "stack/body/0/mixer"
    if arch == "mamba-130m":
        assert f"{mixer}/conv/kernel" in quantized
        assert got[f"{mixer}/conv/kernel"]["n"].shape == (2, 4, 1, 128)
        assert {f"{mixer}/dt_proj/kernel", f"{mixer}/ssm/a_log"} <= set(want) - quantized
        assert len(quantized) == 8    # in/x/out_proj, conv, the gated FFN's three, the table
    else:
        assert {f"{mixer}/decay/a", f"{mixer}/bonus_u", f"{mixer}/mix/x"} <= set(want) - quantized
        assert len(quantized) == 9           # wr/wk/wv/wg/wo, the channel-mix's three, the table


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_tree_match_reference(arch):
    """``param_count()`` equals the reference's at full and smoke size (about
    7.25 B for rwkv6-7b), and the port's tree holds the reference's leaves,
    shape for shape."""
    for size in ("", "-smoke"):
        assert get_config(arch + size).param_count() == j_get_config(arch + size).param_count()
    if arch == "rwkv6-7b":
        assert 7.2e9 < get_config(arch).param_count() < 7.3e9
    jm, jp, tm, _, cfg = smoke(arch)
    tree = tm.init(torch.Generator().manual_seed(0), "cpu")
    got = [tuple(x.shape) for x in leaves(params_to_numpy(tree))]
    want = [tuple(x.shape) for x in leaves(to_numpy(jp))]
    assert got == want
    real = sum(int(np.prod(s)) for s in got)
    assert abs(real - cfg.param_count()) / real < 0.15


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_field_for_field(arch):
    """Every field of the port's config equals the reference's at full and
    smoke size; the reference's MoE and EncDec fields hold their defaults."""
    defaults = {f.name: f.default for f in dataclasses.fields(JArchConfig)}
    for size in ("", "-smoke"):
        got, want = get_config(arch + size), j_get_config(arch + size)
        names = {f.name for f in dataclasses.fields(got)}
        for name in names:
            assert getattr(got, name) == getattr(want, name), (arch + size, name)
        for f in dataclasses.fields(want):
            if f.name not in names and f.name != "enc_seq":
                assert getattr(want, f.name) == defaults[f.name], (arch + size, f.name)
    full = get_config(arch).build()
    assert full.stack.n_layers == get_config(arch).n_layers
    assert {b.mixer for b in full.stack.body} == {"mamba" if arch == "mamba-130m" else "rwkv"}
