"""``qdecode_attn`` on the split walk of ``csrc/attn_split.cuh``: a dense
(B, S, Hkv, D) cache is a pool of B pages of page size S, slot b reading
pool page b under the one-entry table row {b}.

The walk is emulated by ``test_torch_attn_split.emulate_paged_decode`` (the
kernel's partition and folds, written out in torch) on the layout that
``kernels/qdecode_attn.py::plan`` gives, and held to repro's
``qdecode_attn_pallas`` in interpret mode, to repro's ``qdecode_attn_ref``
and to the port's, at rtol 1e-5 / atol 1e-5.  Under that layout the paged
decode's visited range is the dense one: [0, min(kv_len, S)), and the whole
row at kv_len <= 0, where all three give the mean of V over the row.
Inputs are drawn with numpy from seeds, K/V codes with the spread of
post-norm K/V on the Q4.3 grid.  The walk's ranks are R = 1, 2, 4, 8 at
every D and G bucket, over walks of more than 8 tiles.
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.qdecode_attn import qdecode_attn_pallas
from repro_torch.kernels import attn_split, qdecode_attn, ref
from test_torch_attn_split import K_N, V_N, _post_norm_codes, emulate_paged_decode

RTOL, ATOL = 1e-5, 1e-5
B, HKV = 6, 2


def _s(d):
    """Eight and a half tiles of the walk at D, so every rank of 8 has one."""
    return attn_split.tile(d) * 17 // 2


def _lens(s):
    """kv_len <= 0 (twice), past S, 1, S - 1 and a partial last tile."""
    return np.asarray([0, s + 7, 1, -3, s - 1, s // 2 + 5], np.int32)


@functools.lru_cache(maxsize=None)
def _case(d, g, form, n=None):
    """Inputs and the three references' outputs.  ``form``: "per-slot"
    (a (B,) int32 vector), "int" or "0-d" (one length ``n``, as an int or
    a 0-d int32 tensor)."""
    s = _s(d)
    rng = np.random.default_rng(1000 * d + 10 * g + len(form) + (n or 0) % 7)
    q = rng.normal(0, 1, (B, g * HKV, d)).astype(np.float32)
    k, v = (_post_norm_codes(rng, (B, s, HKV, d)) for _ in range(2))
    lens = _lens(s) if form == "per-slot" else np.full(B, n, np.int32)
    if form == "per-slot":
        j_len, t_len = jnp.asarray(lens), torch.from_numpy(lens)
    elif form == "int":
        j_len, t_len = n, n
    else:
        j_len, t_len = jnp.asarray(n, jnp.int32), torch.tensor(n, dtype=torch.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = np.asarray(qdecode_attn_pallas(jq, jk, jv, jnp.int32(K_N), jnp.int32(V_N),
                                            jnp.asarray(j_len, jnp.int32), bs=s // 17,
                                            interpret=True))
    oracle = np.asarray(j_ref.qdecode_attn_ref(jq, jk, jv, K_N, V_N, j_len))
    plain = ref.qdecode_attn_ref(*(torch.from_numpy(x) for x in (q, k, v)), K_N, V_N,
                                 t_len).numpy()
    return q, k, v, lens, pallas, oracle, plain


def _emulate(q, k, v, lens, ranks):
    """The split walk over the dense cache laid out as :func:`plan` says."""
    b, s, hkv, d = k.shape
    p = qdecode_attn.plan(b, s, hkv, d)
    pages = b * s // p.ps
    table = torch.arange(pages, dtype=torch.int32).reshape(b, p.max_pages)
    pool = [torch.from_numpy(x).reshape(pages, p.ps, hkv, d) for x in (k, v)]
    return emulate_paged_decode(torch.from_numpy(q), *pool, table, torch.from_numpy(lens),
                                ranks).numpy()


def _held(got, case):
    *_, pallas, oracle, plain = case
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("g", [1, 3, 16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_dense_split_decode_matches_pallas_and_both_references(d, g, ranks):
    case = _case(d, g, "per-slot")
    q, k, v, lens = case[:4]
    got = _emulate(q, k, v, lens, ranks)
    _held(got, case)
    # kv_len <= 0: the mean of V over the whole row, not its first tile
    mean = np.repeat(v[[0, 3]].astype(np.float64) * 2.0 ** -V_N, g, axis=2).mean(axis=1)
    np.testing.assert_allclose(got[[0, 3]], mean, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("form,where", [("int", "inside"), ("int", "past"), ("int", "empty"),
                                        ("0-d", "inside"), ("0-d", "past"), ("0-d", "empty")])
def test_dense_split_decode_with_one_shared_length(form, where, ranks):
    """One length for every slot, as ``Attention.apply`` passes it (an int)
    or a 0-d int32 tensor: inside the cache, past S, and 0."""
    s = _s(64)
    n = {"inside": s // 3 + 1, "past": s + 5, "empty": 0}[where]
    case = _case(64, 3, form, n)
    q, k, v, lens = case[:4]
    _held(_emulate(q, k, v, lens, ranks), case)


def test_dense_plan_depends_on_shapes_alone():
    """ps = S and one page a slot (a smaller page would make a row with
    kv_len <= 0 average its first page only); R from split_ranks(S, B, Hkv,
    D); inputs are the launch's shapes (ints), never kv_len."""
    assert list(inspect.signature(qdecode_attn.plan).parameters) == ["b", "s", "hkv", "d"]
    for s in (1, 37, 192, 256, 1000, 2048, 32768):
        for b, hkv, d in ((1, 1, 16), (8, 3, 64), (16, 8, 128), (160, 3, 32)):
            p = qdecode_attn.plan(b, s, hkv, d)
            assert (p.ps, p.max_pages) == (s, 1)
            assert p.ranks == attn_split.split_ranks(s, b, hkv, d) in (1, 2, 4, 8)
    with pytest.raises(ValueError):
        qdecode_attn.plan(8, 0, 3, 64)


@pytest.mark.parametrize("s,want", [(192, 2), (256, 4), (2048, 8)])
def test_dense_plan_at_the_smoke_run_shapes(s, want):
    """B=8 slots, Hkv=3, D=64: the smoke run's cache (192), 256 and 2048."""
    assert qdecode_attn.plan(8, s, 3, 64) == (s, 1, want)


@pytest.mark.cuda
def test_cuda_dense_decode_refuses_a_cache_off_16_bytes():
    """The split walk stages rows with 16-byte copies: a 4-byte-aligned
    cache (which the one-block kernel took) is refused, never run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from repro_torch.kernels.qdecode_attn import qdecode_attn_cuda

    b, s, hkv, d = 2, 64, 1, 16
    q = torch.zeros(b, 2, d, device="cuda")
    good = torch.zeros(b, s, hkv, d, dtype=torch.int8, device="cuda")
    flat = torch.zeros(b * s * hkv * d + 16, dtype=torch.int8, device="cuda")
    off = flat[4:4 + good.numel()].view(b, s, hkv, d)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    for k, v in ((off, good), (good, off)):
        with pytest.raises(ValueError, match="16-byte"):
            qdecode_attn_cuda(q, k, v, 3, 3, 5)
    torch.testing.assert_close(qdecode_attn_cuda(q, good, good, 3, 3, 5),
                               ref.qdecode_attn_ref(q, good, good, 3, 3, 5))
