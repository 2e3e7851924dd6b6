"""Port parity for the recurrent mixers (``repro_torch/nn/ssm.py``): Mamba,
the RWKV-6 time-mix and the RWKV-6 channel-mix against the reference's on
the reference's parameters carried over by ``repro_torch.convert``, float
and with int8 weights (``integerize_weights_only``: every projection but
Mamba's ``dt_proj`` a ``QTensor``, the conv kernel one with a scale per
(tap, channel)):

* a forward from zero state over 12 positions with ``chunk=5`` (so the
  reference pads its last RWKV chunk) at rtol 1e-5;
* a prefill into carried state, then a decode step: outputs and every state
  leaf at rtol 1e-5;
* a 6-position chunk with 4 live positions into slot 1 of a 3-slot state:
  outputs at rtol 1e-5, slot 1's rows at rtol 1e-5, slots 0 and 2 bit for
  bit unchanged (and the input state left as it was);
* ``softplus`` against ``jax.nn.softplus`` past 20, where ``F.softplus``
  turns into the identity.

The reference's Mamba scan raises when a scan's length is not a multiple
of its chunk (it pads ``xc`` and then adds the padded skip term to the
unpadded output, ``src/repro/nn/ssm.py:150-153``), so its Mamba runs here
with its default chunk (one chunk per call) beside the port's at
``chunk=5``: the chunks only bound the port's temporaries, the recurrence
is the same.  ``test_reference_mamba_scan_raises_on_a_partial_chunk`` pins
the fault; the port does not copy it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.integerize import integerize_weights_only as j_integerize
from repro.core.qformat import QTensor as JQ
from repro.nn.attention import KVChunk as JChunk
from repro.nn.module import Context as JContext
from repro.nn.ssm import Mamba as JMamba
from repro.nn.ssm import RWKV6ChannelMix as JChannelMix
from repro.nn.ssm import RWKV6TimeMix as JTimeMix
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.integerize import integerize_weights_only
from repro_torch.core.qformat import QTensor
from repro_torch.nn.attention import KVChunk
from repro_torch.nn.module import Context
from repro_torch.nn.ssm import Mamba, RWKV6ChannelMix, RWKV6TimeMix, softplus

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
D = 32

MODULES = {
    "mamba": (lambda: JMamba(D), lambda: Mamba(D, chunk=5)),
    "timemix": (lambda: JTimeMix(D, head_dim=8, decay_lora=16, chunk=5),
                lambda: RWKV6TimeMix(D, head_dim=8, decay_lora=16, chunk=5)),
    "chanmix": (lambda: JChannelMix(D, 48), lambda: RWKV6ChannelMix(D, 48)),
}
STATE_KEYS = {"mamba": ("h", "conv"), "timemix": ("s", "shift"), "chanmix": ("shift",)}


def to_numpy(tree):
    if isinstance(tree, JQ):
        return {"q": np.asarray(tree.q), "n": np.asarray(tree.n), "width": tree.width,
                "channel_axis": tree.channel_axis}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def pair(name, int8):
    """(jax module, jax params, port module, port params); with ``int8``
    both sides' weights integerized by their own package.  Memoized: one
    reference module per case keeps its compiled scans across the tests."""
    jmake, tmake = MODULES[name]
    jm, tm = jmake(), tmake()
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(to_numpy(jp), "cpu")
    if int8:
        jp, tp = j_integerize(jp), integerize_weights_only(tp)
    return jm, jp, tm, tp


def inputs(b, s, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, s, D)).astype(np.float32)


def j_state(st):
    return {k: jnp.asarray(v.numpy()) for k, v in st.items()}


def apply_both(name, jm, jp, tm, tp, x, jst=None, tst=None, jchunk=None, tchunk=None):
    jy, jnew = jm.apply(jp, jnp.asarray(x), JContext(), state=jst, chunk=jchunk)
    ty, tnew = tm.apply(tp, torch.from_numpy(x), Context(), state=tst, chunk=tchunk)
    return jy, jnew, ty, tnew


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("name", list(MODULES))
def test_forward_from_zero_state_matches_reference(name, int8):
    """12 positions through a module built with ``chunk=5``: two whole
    chunks and a padded one in the reference's scan."""
    jm, jp, tm, tp = pair(name, int8)
    x = inputs(2, 12, seed=1)
    jy, jnew, ty, tnew = apply_both(name, jm, jp, tm, tp, x)
    assert jnew is None and tnew is None and ty.shape == (2, 12, D)
    close(ty, jy)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("name", list(MODULES))
def test_prefill_then_decode_step_against_carried_state(name, int8):
    jm, jp, tm, tp = pair(name, int8)
    x = inputs(2, 7, seed=2)
    tst = tm.init_state(2, "cpu")
    jy, jst, ty, tst = apply_both(name, jm, jp, tm, tp, x, j_state(tst), tst)
    close(ty, jy)
    for step in range(2):
        x1 = inputs(2, 1, seed=10 + step)
        jy, jst, ty, tst = apply_both(name, jm, jp, tm, tp, x1, jst, tst)
        close(ty, jy)
        assert sorted(tst) == sorted(STATE_KEYS[name])
        for k in STATE_KEYS[name]:
            assert tst[k].dtype == torch.float32
            close(tst[k], jst[k])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8-weights"])
@pytest.mark.parametrize("name", list(MODULES))
def test_chunk_into_one_slot_leaves_the_others_bit_identical(name, int8):
    """A 6-position chunk with 4 live positions into slot 1 of a 3-slot
    state that already holds state in every row: the pad tail is an
    identity update, the carries come from the live length, and rows 0 and
    2 are the input's bit for bit."""
    jm, jp, tm, tp = pair(name, int8)
    tst = tm.init_state(3, "cpu")
    _, jst, _, tst = apply_both(name, jm, jp, tm, tp, inputs(3, 5, seed=4), j_state(tst), tst)
    before = {k: v.clone() for k, v in tst.items()}
    x = inputs(1, 6, seed=5)
    jy, jnew, ty, tnew = apply_both(name, jm, jp, tm, tp, x, jst, tst,
                                    JChunk(slot=jnp.int32(1), start=jnp.int32(5),
                                           length=jnp.int32(4)),
                                    KVChunk(slot=1, start=5, length=4))
    close(ty, jy)
    for k in STATE_KEYS[name]:
        assert torch.equal(tst[k], before[k]), k          # the input state is untouched
        assert torch.equal(tnew[k][0], before[k][0]) and torch.equal(tnew[k][2], before[k][2])
        close(tnew[k], jnew[k])
        assert not torch.equal(tnew[k][1], before[k][1]), k


def test_int8_weights_and_the_conv_kernel_convert_leaf_for_leaf():
    """``integerize_weights_only`` on each module: the reference's codes and
    exponents bit for bit; Mamba's conv kernel a (K, 1, d_inner) QTensor
    with one exponent per (tap, channel), ``dt_proj`` and the ``ssm``,
    ``decay``, ``mix``, ``bonus_u`` and ``ln_out`` leaves float."""
    for name in MODULES:
        jmake, _ = MODULES[name]
        jp = jmake().init(jax.random.PRNGKey(3))
        want = to_numpy(j_integerize(jp))
        got = params_to_numpy(integerize_weights_only(params_from_numpy(to_numpy(jp), "cpu")))

        def walk(w, g, path):
            if isinstance(w, dict) and not {"q", "n", "width"} <= set(w):
                assert sorted(g) == sorted(w), path
                for k in w:
                    walk(w[k], g[k], f"{path}/{k}")
            elif isinstance(w, dict):
                for k in ("q", "n"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=path)
                assert (g["width"], g["channel_axis"]) == (w["width"], w["channel_axis"])
            else:
                assert not isinstance(g, dict), path
                np.testing.assert_array_equal(g, w, err_msg=path)

        walk(want, got, name)
    tp = integerize_weights_only(Mamba(D).init(torch.Generator().manual_seed(0), "cpu"))
    conv = tp["conv"]["kernel"]
    assert isinstance(conv, QTensor) and conv.q.shape == (4, 1, 2 * D)
    assert conv.n.shape == (4, 1, 2 * D) and conv.q.dtype == torch.int8
    assert not isinstance(tp["dt_proj"]["kernel"], QTensor)
    assert isinstance(tp["x_proj"]["kernel"], QTensor)
    tp = integerize_weights_only(RWKV6TimeMix(D, head_dim=8).init(
        torch.Generator().manual_seed(0), "cpu"))
    assert all(not isinstance(v, QTensor) for v in tp["decay"].values())
    assert all(isinstance(tp[k]["kernel"], QTensor) for k in ("wr", "wk", "wv", "wg", "wo"))


def test_softplus_is_the_references_past_twenty():
    x = np.array([-30.0, -5.0, 0.0, 1e-3, 5.0, 19.9, 20.0, 20.5, 30.0, 88.0], np.float32)
    got = softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[x >= 20], want[x >= 20])      # log1p(e^-x) > 0 there


def test_reference_mamba_scan_raises_on_a_partial_chunk():
    """The reference's fault, which the port does not copy: 12 positions
    through ``Mamba(chunk=5)`` fail to broadcast the padded skip term in the
    reference and run in the port, equal to one 12-position chunk."""
    jm, jp, _, tp = pair("mamba", False)
    x = inputs(2, 12, seed=1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        JMamba(D, chunk=5).apply(jp, jnp.asarray(x), JContext())
    want, _ = Mamba(D, chunk=12).apply(tp, torch.from_numpy(x), Context())
    got, _ = Mamba(D, chunk=5).apply(tp, torch.from_numpy(x), Context())
    assert torch.equal(got, want)
