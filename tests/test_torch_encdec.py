"""Port parity for the EncDec model (whisper-tiny): ``configs/whisper_tiny.py``,
the GELU ``MLP``, cross-attention (``Attention(kv_source=)``,
``Attention(cross_cache=)``, ``project_kv``, ``init_cross_cache``),
``Block(cross=True)`` and ``EncDecLM``, each held to the reference on the
reference's ``whisper-tiny-smoke`` parameters carried over by
``repro_torch.convert`` and the same numpy inputs:

* the sinusoidal encoder positions over the full (1500, 384) table: the
  angles bit for bit, sin/cos within 2e-7 (an ulp or two of values near 1);
* modules, encode (1500 frames), the forward's logits, prefill and decode:
  rtol 1e-5 (``RTOL``, ``ATOL``);
* ``init_cache`` leaf for leaf (per-slot or lockstep, dense or paged, int8 or
  float KV, with and without the cross-attention cache), and
  ``write_cross_kv`` equal to the reference's, also when a slot is reused
  by a shorter encoder output (the rows past it keep the old ones);
* decode logits with the cached cross-attention rows equal to re-projecting
  ``enc`` (rtol 1e-5, as ``tests/test_slot_state.py``);
* the whisper cases of ``tests/test_archs.py``: one SGD train step (loss at
  rtol 1e-5, momentum and parameters at the train tests' tolerances),
  forward shapes, prefill + decode;
* ``get_config`` field for field and ``param_count()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as j_get_config
from repro.nn import attention as j_attention
from repro.nn.mlp import MLP as JMLP
from repro.nn.module import Context as JContext
from repro.optim import sgd as j_sgd
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro.train import trainer as j_trainer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import sinusoid_positions
from repro_torch.models.registry import get_config
from repro_torch.nn.attention import Attention, KVChunk
from repro_torch.nn.mlp import MLP
from repro_torch.nn.module import Context
from repro_torch.optim import sgd
from repro_torch.serve.engine import make_prefill_step
from repro_torch.train import trainer
from test_torch_archs import close, leaves, to_numpy

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
_made = {}


def whisper():
    """(reference model, its params, port model, port params, config) of
    whisper-tiny-smoke: 2 + 2 layers, d 64, 4 heads over 4 KV heads."""
    if not _made:
        jm = j_get_config("whisper-tiny-smoke").build(dtype=jnp.float32, remat="off")
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = get_config("whisper-tiny-smoke")
        _made["w"] = (jm, jp, cfg.build(), params_from_numpy(to_numpy(jp), "cpu"), cfg)
    return _made["w"]


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def j_encode(jm, jp, emb):
    return jm.encode(jp, jnp.asarray(emb), JContext())


def t_encode(tm, tp, emb):
    return tm.encode(tp, torch.from_numpy(emb), Context())


def test_sinusoid_table_matches_reference():
    """The full whisper-tiny table (1500 frames, d 384), computed as the
    reference's ``EncDecLM.encode`` computes it (``lm.py:243-250``)."""
    s, d = 1500, 384
    pos = jnp.arange(s)[:, None]
    dim = jnp.arange(d // 2)[None, :]
    ang = pos / jnp.power(10000.0, 2 * dim / d)
    want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1))
    got = sinusoid_positions(s, d, "cpu").numpy()
    assert got.shape == (s, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    tang = torch.arange(s, dtype=torch.float32)[:, None]
    expo = (2 * np.arange(d // 2, dtype=np.int32)).astype(np.float32) / np.float32(d)
    div = np.power(10000.0, expo.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal((tang / torch.from_numpy(div)).numpy(), np.asarray(ang))


def test_gelu_mlp_matches_reference():
    """The MLP with biases and tanh-approximate GELU (``jax.nn.gelu``'s default)."""
    jmlp, tmlp = JMLP(64, 128, activation="gelu"), MLP(64, 128, activation="gelu")
    p = jmlp.init(jax.random.PRNGKey(3))
    p = {k: dict(v, bias=0.1 * jax.random.normal(jax.random.PRNGKey(i), v["bias"].shape))
         for i, (k, v) in enumerate(p.items())}
    x = normal((2, 5, 64), 4, 2.0)
    want = jmlp.apply(p, jnp.asarray(x), JContext())
    got = tmlp.apply(params_from_numpy(to_numpy(p), "cpu"), torch.from_numpy(x), Context())
    close(got, want)


def test_cross_attention_paths_match_reference():
    """``kv_source`` (projected per call), ``cross_cache`` for decode rows
    (per-row ``xlen``: full, short, 0 for an evicted slot) and for a chunk
    (its slot's rows up to its ``xlen``), and ``project_kv``."""
    d, h, hd, s_enc = 64, 4, 16, 12
    ja = j_attention.Attention(d, h, h, hd, use_rope=False, causal=False, name="xattn")
    ta = Attention(d, h, h, hd, use_rope=False, causal=False, name="xattn")
    jp = ja.init(jax.random.PRNGKey(5))
    tp = params_from_numpy(to_numpy(jp), "cpu")
    x, src = normal((3, 1, d), 6), normal((3, s_enc, d), 7)
    want, _ = ja.apply(jp, jnp.asarray(x), JContext(), kv_source=jnp.asarray(src))
    got, none = ta.apply(tp, torch.from_numpy(x), Context(), kv_source=torch.from_numpy(src))
    assert none is None
    close(got, want)
    jk, jv = ja.project_kv(jp, jnp.asarray(src), JContext())
    tk, tv = ta.project_kv(tp, torch.from_numpy(src), Context())
    close(tk, jk)
    close(tv, jv)
    xlen = np.array([s_enc, 5, 0], np.int32)
    jc = {"xk": jk, "xv": jv, "xlen": jnp.asarray(xlen)}
    tc = {"xk": tk, "xv": tv, "xlen": torch.from_numpy(xlen)}
    want, _ = ja.apply(jp, jnp.asarray(x), JContext(), cross_cache=jc)
    got, _ = ta.apply(tp, torch.from_numpy(x), Context(), cross_cache=tc)
    close(got, want)
    xc = normal((1, 4, d), 8)
    chunk = KVChunk(slot=1, start=0, length=4)
    want, _ = ja.apply(jp, jnp.asarray(xc), JContext(), cross_cache=jc, chunk=chunk)
    got, _ = ta.apply(tp, torch.from_numpy(xc), Context(), cross_cache=tc, chunk=chunk)
    close(got, want)
    with pytest.raises(NotImplementedError, match="single-token rows"):
        ta.apply(tp, torch.from_numpy(normal((3, 2, d), 9)), Context(), cross_cache=tc)


def test_encode_1500_frames_matches_reference():
    """The encoder over a full 1500-frame input, and at the config's 16."""
    jm, jp, tm, tp, _ = whisper()
    for frames, seed in ((1500, 10), (16, 11)):
        emb = normal((1, frames, 64), seed)
        close(t_encode(tm, tp, emb), j_encode(jm, jp, emb))


def test_forward_logits_match_reference():
    """``apply`` with ``embeds`` (it encodes) and with ``enc``: (B, S, V)."""
    jm, jp, tm, tp, cfg = whisper()
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    emb = normal((2, cfg.enc_seq, 64), 13)
    want, _ = jm.apply(jp, jnp.asarray(toks), JContext(), embeds=jnp.asarray(emb))
    got, _ = tm.apply(tp, torch.from_numpy(toks), Context(), embeds=torch.from_numpy(emb))
    assert got.shape == (2, 9, cfg.vocab_padded)
    close(got, want)
    enc = t_encode(tm, tp, emb)
    again, _ = tm.apply(tp, torch.from_numpy(toks), Context(), enc=enc)
    close(again, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="embeds.*or its output"):
        tm.apply(tp, torch.from_numpy(toks), Context())


def _sig(t):
    """(shape, dtype name) of a torch tensor or a jax shape struct."""
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("kw", [
    dict(per_slot_len=True), dict(per_slot_len=True, cross_attn_cache=False),
    dict(per_slot_len=True, quantized_kv=True), dict(per_slot_len=False),
    dict(per_slot_len=True, page_size=4, num_pages=9)],
    ids=["per-slot", "no-cross-cache", "int8", "lockstep", "paged"])
def test_init_cache_leaf_for_leaf(kw):
    """Every leaf of the reference's cache, shape and dtype, and none more,
    but the one ``len`` (and page table) the port keeps for all layers
    where the reference keeps one per layer."""
    jm, _, tm, _, _ = whisper()
    want = jax.eval_shape(lambda: jm.init_cache(3, 12, kv_dtype=jnp.float32, **kw))
    got = tm.init_cache(3, 12, device="meta", **kw)
    jnode, tnode = want["body"][0], got["body"][0]
    assert sorted(tnode) == sorted(jnode) == (["kv", "xkv"] if kw.get("per_slot_len") and
                                             kw.get("cross_attn_cache", True) else ["kv"])
    for name in ("k", "v"):
        assert _sig(tnode["kv"][name]) == _sig(jnode["kv"][name]), name
    if "xkv" in jnode:
        assert sorted(tnode["xkv"]) == ["xk", "xlen", "xv"]
        for name in ("xk", "xv", "xlen"):
            assert _sig(tnode["xkv"][name]) == _sig(jnode["xkv"][name]), name
        assert tuple(tnode["xkv"]["xlen"].shape) == (2, 3)      # (L, slots), stacked


def test_write_cross_kv_matches_reference_and_reuses_a_slot():
    """Two slots written, then slot 1 rewritten by a shorter encoder output
    (5 of 16 rows): ``xk``/``xv``/``xlen`` equal the reference's after each
    write, rows 5.. of slot 1 still hold the first request's, and decode
    logits over the reused slot equal re-projecting the short ``enc``."""
    jm, jp, tm, tp, cfg = whisper()
    kw = dict(quantized_kv=False, per_slot_len=True)
    jc = jm.init_cache(2, 12, kv_dtype=jnp.float32, **kw)
    tc = tm.init_cache(2, 12, device="cpu", **kw)
    rows = [normal((1, cfg.enc_seq, 64), 20), normal((1, cfg.enc_seq, 64), 21),
            normal((1, 5, 64), 22)]
    for slot, row in ((0, rows[0]), (1, rows[1]), (1, rows[2])):
        jc = jm.write_cross_kv(jp, jc, jnp.asarray(row), jnp.int32(slot), JContext())
        tc = tm.write_cross_kv(tp, tc, torch.from_numpy(row), slot, Context())
        for name in ("xk", "xv", "xlen"):
            close(tc["body"][0]["xkv"][name], jc["body"][0]["xkv"][name])
    xkv = tc["body"][0]["xkv"]
    assert xkv["xlen"].tolist() == [[16, 5], [16, 5]]
    first = tm.init_cache(2, 12, device="cpu", **kw)
    first = tm.write_cross_kv(tp, first, torch.from_numpy(rows[1]), 1, Context())
    assert torch.equal(xkv["xk"][:, 1, 5:], first["body"][0]["xkv"]["xk"][:, 1, 5:])
    enc = torch.zeros(2, 16, 64)
    enc[0], enc[1, :5] = torch.from_numpy(rows[0][0]), torch.from_numpy(rows[2][0])
    plain = tm.init_cache(2, 12, device="cpu", cross_attn_cache=False, **kw)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    got, _ = tm.apply(tp, tok, Context(), cache=tc, decode=True)
    want0, _ = tm.apply(tp, tok[:1], Context(), cache=tm.init_cache(
        1, 12, device="cpu", cross_attn_cache=False, **kw), decode=True, enc=enc[:1])
    want1, _ = tm.apply(tp, tok[1:], Context(), cache=tm.init_cache(
        1, 12, device="cpu", cross_attn_cache=False, **kw), decode=True, enc=enc[1:, :5])
    close(got, torch.cat([want0, want1]), rtol=RTOL, atol=ATOL)
    assert plain["body"][0].keys() == {"kv"}


def test_cached_cross_logits_equal_recomputed_and_reference():
    """``tests/test_slot_state.py::test_encdec_cached_cross_logits_identical``:
    five decode steps over two slots with the admission-time ``xkv`` rows
    and with ``enc`` re-projected every step, both at rtol 1e-5 of each
    other and of the reference's cached steps."""
    jm, jp, tm, tp, cfg = whisper()
    encs = [j_encode(jm, jp, normal((1, 6, 64), seed, 0.1)) for seed in (11, 22)]
    enc = jnp.concatenate(encs, axis=0)
    tenc = torch.from_numpy(np.array(enc))
    kw = dict(quantized_kv=False, per_slot_len=True)
    jc = jm.init_cache(2, 16, kv_dtype=jnp.float32, cross_attn_cache=True, **kw)
    cached = tm.init_cache(2, 16, device="cpu", cross_attn_cache=True, **kw)
    plain = tm.init_cache(2, 16, device="cpu", cross_attn_cache=False, **kw)
    for slot in range(2):
        jc = jm.write_cross_kv(jp, jc, encs[slot], jnp.int32(slot), JContext())
        cached = tm.write_cross_kv(tp, cached, tenc[slot:slot + 1], slot, Context())
    toks = (np.arange(2 * 5, dtype=np.int32).reshape(2, 5) * 3) % cfg.vocab
    for i in range(5):
        step = toks[:, i:i + 1]
        jl, jc = jm.apply(jp, jnp.asarray(step), JContext(), cache=jc, decode=True, enc=enc)
        lc, cached = tm.apply(tp, torch.from_numpy(step), Context(), cache=cached, decode=True,
                              enc=tenc)
        lp, plain = tm.apply(tp, torch.from_numpy(step), Context(), cache=plain, decode=True,
                             enc=tenc)
        close(lc, lp)
        close(lc, jl)


def _archs_batch(cfg, b=2, s=16):
    """``tests/test_archs.py::_batch`` for an EncDec config."""
    toks = (np.arange(b * s, dtype=np.int32).reshape(b, s) % cfg.vocab)
    return {"tokens": toks, "labels": toks,
            "embeds": np.ones((b, cfg.enc_seq, cfg.d_model), np.float32)}


def test_smoke_train_step_matches_reference():
    """``test_archs.py::test_smoke_train_step[whisper-tiny]`` held to the
    reference: one SGD step at momentum 0.9; the loss at rtol 1e-5, the
    momentum (the gradient) at rtol 1e-4 plus 1e-6 of the largest gradient,
    the parameters at rtol 1e-5 plus the learning rate times that."""
    jm, jp, tm, _, cfg = whisper()
    batch, lr = _archs_batch(cfg), 0.01
    jopt, topt = j_sgd(momentum=0.9), sgd(momentum=0.9)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jnew, jmet = jax.jit(j_trainer.make_train_step(jm, jopt, lr))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_numpy(to_numpy(jp), "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    tnew, tmet = trainer.make_train_step(tm, topt, lr)(tstate, batch)
    assert int(tnew["step"]) == 1 and np.isfinite(tmet["loss"].item())
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    got_m, want_m = leaves(params_to_numpy(tnew["opt"]["m"])), leaves(jnew["opt"]["m"])
    assert len(got_m) == len(want_m)
    # the cross-attention over constant frames has gradients 100x below the
    # rest (norm_x: max 2e-3), so the sums-in-another-order slack is taken at
    # the whole gradient's scale, not each leaf's
    scale = max(np.abs(w).max() for w in want_m)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * scale)
    changed = 0
    for a, w, g, old in zip(leaves(params_to_numpy(tnew["params"])), leaves(jnew["params"]),
                            want_m, leaves(jp)):
        tol = 1e-5 * np.abs(w) + lr * (1e-4 * np.abs(g) + 1e-6 * scale)
        assert (np.abs(a - w) <= tol).all()
        changed += not np.allclose(a, old)
    assert changed > 0


def test_smoke_forward_shapes_and_prefill_decode_match_reference():
    """``test_archs.py::test_smoke_forward_shapes`` and
    ``test_smoke_prefill_decode`` for whisper: the forward over ones frames,
    then a lockstep prefill of 8 tokens through each package's prefill
    step and three greedy decode steps, enc from 16 ones frames; logits at
    rtol 1e-5, the same greedy tokens, the same cache."""
    jm, jp, tm, tp, cfg = whisper()
    batch = _archs_batch(cfg)
    want, _ = jm.apply(jp, jnp.asarray(batch["tokens"]), JContext(),
                       embeds=jnp.asarray(batch["embeds"]))
    got, _ = tm.apply(tp, torch.from_numpy(batch["tokens"]), Context(),
                      embeds=torch.from_numpy(batch["embeds"]))
    assert got.shape == (2, 16, cfg.vocab_padded) and not got.isnan().any()
    close(got, want)
    b, s, max_len = 2, 8, 24
    toks = batch["tokens"][:, :s]
    ones = np.ones((b, 16, cfg.d_model), np.float32)
    jenc, tenc = j_encode(jm, jp, ones), t_encode(tm, tp, ones)
    jc = jm.init_cache(b, max_len, quantized_kv=False, kv_dtype=jnp.float32)
    tc = tm.init_cache(b, max_len, quantized_kv=False, device="cpu")
    jl, jc = j_make_prefill_step(jm)(jp, jnp.asarray(toks), jc, enc=jenc)
    tl, tc = make_prefill_step(tm)(tp, torch.from_numpy(toks), tc, enc=tenc)
    close(tl, jl)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), nxt[:, 0])
        jl, jc = jm.apply(jp, jnp.asarray(nxt), JContext(), cache=jc, decode=True, enc=jenc)
        tl, tc = tm.apply(tp, torch.from_numpy(nxt), Context(), cache=tc, decode=True,
                          enc=tenc)
        assert tl.shape == (b, 1, cfg.vocab_padded) and not tl.isnan().any()
        jl, tl = jl[:, -1], tl[:, -1]
        close(tl, jl)
    assert tc["body"][0]["kv"]["len"] == s + 3
    for name in ("k", "v"):
        close(tc["body"][0]["kv"][name], jc["body"][0]["kv"][name])


def test_decode_positions_advance():
    """``tests/test_encdec_serve.py::test_encdec_decode_positions_advance``:
    seven incremental decode steps equal one forward (the learned positions
    follow the cache's live length), and equal the reference's forward."""
    jm, jp, tm, tp, _ = whisper()
    toks = (np.arange(7, dtype=np.int32) + 1)[None]
    emb = normal((1, 6, 64), 42, 0.1)
    enc = t_encode(tm, tp, emb)
    full, _ = tm.apply(tp, torch.from_numpy(toks), Context(), enc=enc)
    cache = tm.init_cache(1, 8, quantized_kv=False, device="cpu")
    steps = []
    for i in range(7):
        lg, cache = tm.apply(tp, torch.from_numpy(toks[:, i:i + 1]), Context(), cache=cache,
                             decode=True, enc=enc)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    want, _ = jm.apply(jp, jnp.asarray(toks), JContext(), enc=j_encode(jm, jp, emb))
    close(full, want)


def test_positions_clip_to_the_table():
    """A decode position past the learned table reads its last row, as the
    reference's ``jnp.clip`` does (per slot, on the device)."""
    _, _, tm, tp, _ = whisper()
    cache = tm.init_cache(2, 8, quantized_kv=False, device="cpu", per_slot_len=True,
                          cross_attn_cache=False)
    cache["body"][0]["kv"]["len"] = torch.tensor([3, 40000], dtype=torch.int32)
    pos = tm._positions(1, "cpu", cache, True, None, None)
    assert pos.tolist() == [[3], [tm.max_target_len - 1]]


@pytest.mark.parametrize("size", ["", "-smoke"])
def test_config_field_for_field_and_param_count(size):
    """Every field of the port's whisper config equals the reference's (the
    MoE fields at their defaults in both); the reference's fields the port
    lacks hold their defaults;
    ``param_count()`` is the reference's (the encoder term included) and
    the tree holds the reference's leaves, shape for shape."""
    from repro.configs.base import ArchConfig as JArchConfig

    got, want = get_config("whisper-tiny" + size), j_get_config("whisper-tiny" + size)
    names = {f.name for f in dataclasses.fields(got)}
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    defaults = {f.name: f.default for f in dataclasses.fields(JArchConfig)}
    for f in dataclasses.fields(want):
        if f.name not in names:
            assert getattr(want, f.name) == defaults[f.name], f.name
    assert got.is_encdec and got.param_count() == want.param_count()
    model = got.build()
    assert type(model).__name__ == "EncDecLM" and model.max_target_len == 32768
    assert (model.encoder.n_layers, model.decoder.n_layers, model.enc_len) == \
        (want.enc_layers, want.n_layers, want.enc_seq)
    if size:
        jm, jp, tm, _, _ = whisper()
        tree = tm.init(torch.Generator().manual_seed(0), "cpu")
        assert [tuple(x.shape) for x in leaves(params_to_numpy(tree))] == \
            [tuple(x.shape) for x in leaves(to_numpy(jp))]
        assert sorted(tree) == sorted(jp) == ["decoder", "embed", "enc_norm", "encoder",
                                              "final_norm", "pos_embed"]
        assert {"norm_x", "xattn"} <= set(tree["decoder"]["body"][0])
        # the reference's tree carried across and back, leaf for leaf
        back = params_to_numpy(params_from_numpy(to_numpy(jp), "cpu"))
        for got, want in zip(leaves(back), leaves(jp)):
            np.testing.assert_array_equal(got, np.asarray(want))
