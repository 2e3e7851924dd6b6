"""``flash_attention``'s backward (``repro_torch.nn.attention``) against the
reference's custom VJP, on the five cases of tests/test_attention.py:29-35
(GQA and MQA, a length that is no block multiple, a prefill into a cache
at q_offset 100 with kv_len 164, a non-causal kv_len of 200):

* the gradients of sum(out^2) in q, k and v at rtol 1e-4 and atol 1e-5
  (f32 sums in another order), with the backward's query block smaller
  than the sequence so the block walk is exercised;
* ``q_offset``/``kv_len`` as 0-d tensors give what Python ints give;
* what the forward saves for the backward, seen through
  ``torch.autograd.graph.saved_tensors_hooks``, holds nothing (S, S)-sized
  at S=512 (tests/test_attention.py:93 checks the reference's jaxpr);
* the forward is unchanged under ``torch.inference_mode`` and saves nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.attention import flash_attention as j_flash
from repro_torch.nn.attention import flash_attention

torch.set_num_threads(2)

CASES = [
    # sq, skv, hq, hkv, causal, q_offset, kv_len
    (128, 128, 8, 2, True, 0, None),
    (100, 100, 4, 4, True, 0, None),
    (64, 200, 8, 4, True, 100, 164),
    (37, 256, 6, 3, False, 0, 200),
    (256, 64, 4, 1, True, 0, None),
]


def _inputs(sq, skv, hq, hkv, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, shape).astype(np.float32)
                 for shape in ((2, sq, hq, 64), (2, skv, hkv, 64), (2, skv, hkv, 64)))


def _port_grads(q, k, v, qoff, kvl, causal, block_q):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*t, qoff, kvl, causal, block_q=block_q)
    torch.sum(torch.square(out)).backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


@pytest.mark.parametrize("sq,skv,hq,hkv,causal,qoff,kvlen", CASES)
def test_flash_gradients_match_reference(sq, skv, hq, hkv, causal, qoff, kvlen):
    q, k, v = _inputs(sq, skv, hq, hkv)
    kvl = kvlen if kvlen is not None else skv

    def f(a, b, c):
        return jnp.sum(jnp.square(j_flash(a, b, c, jnp.int32(qoff), jnp.int32(kvl), causal,
                                          32, 64)))

    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, got = _port_grads(q, k, v, qoff, kvl, causal, block_q=48)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)
    # device-tensor offsets and lengths (masked, not sliced) give the same
    out_t, got_t = _port_grads(q, k, v, torch.tensor(qoff, dtype=torch.int32),
                               torch.tensor(kvl, dtype=torch.int32), causal, block_q=48)
    out_i, _ = _port_grads(q, k, v, qoff, kvl, causal, block_q=sq)
    np.testing.assert_allclose(out_t, out_i, rtol=1e-6, atol=1e-6)
    for g, w in zip(got_t, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_flash_backward_saves_nothing_sequence_squared():
    b, hq, hkv, d, s = 2, 4, 2, 64, 512
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(s, s, hq, hkv, seed=3))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention(q, k, v, 0, s, True, block_q=128)
    assert saved and all(shape.count(s) < 2 for shape in saved), saved
    assert max(int(np.prod(shape)) for shape in saved) <= b * s * hq * d
    torch.sum(out).backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(k.grad).all())


def test_flash_forward_under_inference_mode_saves_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(37, 256, 6, 3, seed=4))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with torch.inference_mode():
            out = flash_attention(q, k, v, 0, 200, False)
    assert saved == []
    want = j_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                   jnp.int32(0), jnp.int32(200), False, 32, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
