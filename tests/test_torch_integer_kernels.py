"""Port parity for the integer engine's kernels: the plain versions of
``qmm``, ``qmm_requant``, ``qconv1d`` and ``fake_quant`` against repro's
Pallas kernels (interpret mode) and jnp oracles, bit for bit, including
int32 wrap, shifts of 32 or more and exponents with |n| >= 13; the ``ops``
entry points' routing and launch counters.

The CUDA kernels run only on the card: ``test_cuda_kernel_*`` carry the
``cuda`` marker and skip without one (``chip_smoke.py`` holds the kernels
to their plain versions there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.fake_quant import fake_quant_pallas
from repro.kernels.qconv1d import qconv1d_pallas
from repro.kernels.qmm import qmm_pallas, qmm_requant_pallas
from repro_torch.core import qformat
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

_NP = {"int8": np.int8, "int16": np.int16}


def _codes(rng, shape, dtype):
    info = np.iinfo(_NP[dtype])
    return rng.integers(info.min, info.max + 1, shape).astype(_NP[dtype])


# ---- qmm ---------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (128, 256, 128), (100, 300, 50), (1, 512, 64)])
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_plain_qmm_matches_pallas_and_oracle(m, k, n, dtype):
    """Full-range codes: the int16 cases at K >= 256 overflow int32, and the
    plain version wraps where the reference's int32 dot wraps."""
    rng = np.random.default_rng(m + k + n)
    x, w = _codes(rng, (m, k), dtype), _codes(rng, (k, n), dtype)
    got = ref.qmm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    want = np.asarray(j_ref.qmm_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(qmm_pallas(jnp.asarray(x), jnp.asarray(w), bm=32, bk=64, bn=32,
                                   interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    if dtype == "int16" and k >= 256:
        exact = x.astype(np.int64) @ w.astype(np.int64)
        assert (exact != got.numpy()).any(), "no sum passed int32: the wrap is untested"


def test_plain_qmm_refuses_inexact_operands():
    with pytest.raises(TypeError, match="int8 or int16"):
        ref.qmm_ref(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(3, 2, dtype=torch.int32))


# ---- qmm_requant -----------------------------------------------------------------

@pytest.mark.parametrize("shift", [-33, -3, 0, 5, 11, 31, 32, 40])
@pytest.mark.parametrize("width", [8, 16])
def test_plain_qmm_requant_matches_pallas_and_oracle(shift, width):
    """XLA's shifts: >> 32 or more gives the sign fill, << 32 or more gives
    0, a smaller << wraps; then the clip to ``width`` bits."""
    rng = np.random.default_rng(1)
    x, w = _codes(rng, (64, 96), "int8"), _codes(rng, (96, 48), "int8")
    got = ref.qmm_requant_ref(torch.from_numpy(x), torch.from_numpy(w), shift, width=width)
    assert got.dtype == qformat.storage_dtype(width)
    want = np.asarray(j_ref.qmm_requant_ref(jnp.asarray(x), jnp.asarray(w), shift, width=width))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(qmm_requant_pallas(jnp.asarray(x), jnp.asarray(w), jnp.int32(shift),
                                           width=width, bm=32, bk=32, bn=32, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("shift", [-20, -1, 3, 33])
def test_plain_qmm_requant_int16_wraps_then_shifts(shift):
    """int16 operands whose sums wrap, a left shift that wraps again, and a
    device-scalar shift given as a tensor."""
    rng = np.random.default_rng(2)
    x, w = _codes(rng, (16, 512), "int16"), _codes(rng, (512, 24), "int16")
    got = ref.qmm_requant_ref(torch.from_numpy(x), torch.from_numpy(w),
                              torch.tensor(shift, dtype=torch.int32), width=16)
    want = np.asarray(j_ref.qmm_requant_ref(jnp.asarray(x), jnp.asarray(w), shift, width=16))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- qconv1d -------------------------------------------------------------------

_CONV_CASES = [(2, 128, 9, 16, 3, 1, "SAME"), (1, 64, 8, 32, 5, 1, "SAME"),
               (3, 128, 16, 24, 3, 2, "SAME"), (2, 50, 4, 8, 3, 1, "VALID"),
               (1, 33, 3, 130, 7, 2, "VALID"), (2, 31, 5, 7, 4, 3, "SAME"),
               (2, 65, 12, 40, 1, 2, "SAME"), (3, 70, 9, 16, 2, 3, "VALID")]   # stride > K


@pytest.mark.parametrize("b,w,c,f,ksize,stride,padding", _CONV_CASES)
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_plain_qconv1d_matches_pallas_and_oracle(b, w, c, f, ksize, stride, padding, dtype):
    rng = np.random.default_rng(b * w + f)
    x, wgt = _codes(rng, (b, w, c), dtype), _codes(rng, (ksize, c, f), dtype)
    got = ref.qconv1d_ref(torch.from_numpy(x), torch.from_numpy(wgt), stride=stride,
                          padding=padding)
    assert got.dtype == torch.int32
    want = np.asarray(j_ref.qconv1d_ref(jnp.asarray(x), jnp.asarray(wgt), stride=stride,
                                        padding=padding))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(qconv1d_pallas(jnp.asarray(x), jnp.asarray(wgt), stride=stride,
                                       padding=padding, bf=64, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_plain_qconv1d_matches_pallas_past_one_block_of_shared_memory():
    """C=1024 int16 at K=7, the shape the CUDA kernel walks in channel
    chunks: the plain version against interpret-mode Pallas, bit for bit."""
    rng = np.random.default_rng(11)
    x, wgt = _codes(rng, (1, 64, 1024), "int16"), _codes(rng, (7, 1024, 8), "int16")
    got = ref.qconv1d_ref(torch.from_numpy(x), torch.from_numpy(wgt))
    pallas = np.asarray(qconv1d_pallas(jnp.asarray(x), jnp.asarray(wgt), interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_plain_qconv1d_int16_sums_wrap():
    """int16 codes at full range over K * C = 2048 taps: the sums pass int32."""
    rng = np.random.default_rng(3)
    x, wgt = _codes(rng, (2, 16, 256), "int16"), _codes(rng, (8, 256, 4), "int16")
    got = ref.qconv1d_ref(torch.from_numpy(x), torch.from_numpy(wgt), padding="VALID")
    want = np.asarray(j_ref.qconv1d_ref(jnp.asarray(x), jnp.asarray(wgt), padding="VALID"))
    np.testing.assert_array_equal(got.numpy(), want)
    taps = np.lib.stride_tricks.sliding_window_view(x.astype(np.int64), 8, axis=1)
    exact = np.einsum("bwck,kcf->bwf", taps, wgt.astype(np.int64))
    assert (exact != got.numpy()).any()


def test_conv_pads_follow_xla_same_split():
    assert ref.conv_pads(128, 3, 1, "SAME") == (1, 1, 128)
    assert ref.conv_pads(128, 4, 1, "SAME") == (1, 2, 128)
    assert ref.conv_pads(31, 4, 3, "SAME") == (1, 2, 11)
    assert ref.conv_pads(50, 3, 1, "VALID") == (0, 0, 48)
    with pytest.raises(ValueError, match="SAME' or 'VALID"):
        ref.conv_pads(8, 3, 1, "CIRCULAR")


# ---- fake_quant ----------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 16])
def test_plain_fake_quant_matches_pallas_at_every_n(width):
    """n in [-20, 20]: |n| >= 13 is where XLA's exp2 misses 2^n, and the
    port's factors must be the reference's, bit for bit."""
    rng = np.random.default_rng(width)
    x = (rng.normal(0, 1, (4, 33, 5)) * 4.0).astype(np.float32)
    for n in range(-20, 21):
        xs = (x * np.float32(2.0 ** -n)).astype(np.float32)
        got = ref.fake_quant_ref(torch.from_numpy(xs), n, width=width).numpy()
        pallas = np.asarray(fake_quant_pallas(jnp.asarray(xs), jnp.int32(n), width=width,
                                              block_rows=8, interpret=True))
        np.testing.assert_array_equal(got, pallas, err_msg=f"n={n}")
        want = np.asarray(j_ref.fake_quant_ref(jnp.asarray(xs), n, width=width))
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_plain_fake_quant_takes_a_tensor_exponent():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, (7, 9)).astype(np.float32))
    for n in (-14, 5, 15):
        np.testing.assert_array_equal(
            ref.fake_quant_ref(x, torch.tensor(n, dtype=torch.int32)).numpy(),
            ref.fake_quant_ref(x, n).numpy())


# ---- the ops entry points ---------------------------------------------------------

def test_ops_integer_entry_points_take_the_plain_versions_on_cpu():
    """CPU tensors go to the plain versions and count no launch; shapes with
    leading dims collapse to GEMM rows and come back."""
    rng = np.random.default_rng(4)
    x, w = _codes(rng, (2, 3, 40), "int8"), _codes(rng, (40, 6), "int8")
    ops.reset_launch_counts()
    got = ops.qmm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 3, 6)
    np.testing.assert_array_equal(got.reshape(6, 6).numpy(),
                                  ref.qmm_ref(torch.from_numpy(x.reshape(6, 40)),
                                              torch.from_numpy(w)).numpy())
    rq = ops.qmm_requant(torch.from_numpy(x), torch.from_numpy(w), 7, width=8)
    assert rq.shape == (2, 3, 6) and rq.dtype == torch.int8
    xc, wc = _codes(rng, (2, 20, 5), "int16"), _codes(rng, (3, 5, 4), "int16")
    conv = ops.qconv1d(torch.from_numpy(xc), torch.from_numpy(wc), strides=2, padding="SAME")
    np.testing.assert_array_equal(conv.numpy(), np.asarray(j_ref.qconv1d_ref(
        jnp.asarray(xc), jnp.asarray(wc), stride=2, padding="SAME")))
    xf = torch.from_numpy(rng.normal(0, 2, (3, 17)).astype(np.float32))
    np.testing.assert_array_equal(ops.fake_quant_fused(xf, 13, width=8).numpy(),
                                  ref.fake_quant_ref(xf, 13, width=8).numpy())
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("qmm", "qmm_requant", "qconv1d", "fake_quant")} == \
        {"qmm": 0, "qmm_requant": 0, "qconv1d": 0, "fake_quant": 0}


def test_integer_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.kernels.qconv1d import qconv1d_cuda
    from repro_torch.kernels.qmm import qmm_cuda, qmm_requant_cuda

    i8 = torch.zeros(4, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_cuda(i8, i8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_requant_cuda(i8, i8, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        qconv1d_cuda(torch.zeros(1, 8, 4, dtype=torch.int8), torch.zeros(3, 4, 2, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        fake_quant_cuda(torch.zeros(8), 3)


def test_integer_kernel_wrappers_check_dtypes_first():
    """Mixed operand types and non-f32 fake-quant inputs are refused before
    any device is touched."""
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.kernels.qconv1d import qconv1d_cuda
    from repro_torch.kernels.qmm import qmm_cuda

    with pytest.raises(ValueError, match="both int8 or both int16"):
        qmm_cuda(torch.zeros(4, 4, dtype=torch.int8), torch.zeros(4, 4, dtype=torch.int16))
    with pytest.raises(ValueError, match="both int8 or both int16"):
        qconv1d_cuda(torch.zeros(1, 8, 4, dtype=torch.int32),
                     torch.zeros(3, 4, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        fake_quant_cuda(torch.zeros(8, dtype=torch.float64), 3)


def test_qconv1d_wrapper_refuses_shapes_with_no_output_position():
    """A VALID convolution shorter than its kernel has no output: refused
    with the sizes, before any device is touched."""
    from repro_torch.kernels.qconv1d import qconv1d_cuda

    with pytest.raises(ValueError, match="no output position"):
        qconv1d_cuda(torch.zeros(1, 2, 4, dtype=torch.int8), torch.zeros(3, 4, 8, dtype=torch.int8),
                     padding="VALID")
    with pytest.raises(ValueError, match="stride 0 < 1"):
        qconv1d_cuda(torch.zeros(1, 8, 4, dtype=torch.int8), torch.zeros(3, 4, 8, dtype=torch.int8),
                     stride=0)


# ---- on the card -------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
def test_qconv1d_wrapper_refuses_what_one_block_cannot_stage():
    """Shapes past one block's shared memory run: a block walks C in
    chunks, carrying its sums.  C=1024 int16 at K=7 (about 1.2 MB of
    weights per filter tile in one chunk) equals the plain
    version; so does a sum that wraps int32 across channel chunks (all
    codes -128 at C=65536, K=3: the plain float64 sums are exact, K*C <
    2^23).  ResNetv1-6's int16 convolutions (one chunk) too."""
    _need_card()
    from repro_torch.kernels.qconv1d import qconv1d_cuda

    rng = np.random.default_rng(0)
    x = torch.from_numpy(_codes(rng, (1, 64, 1024), "int16")).cuda()
    w = torch.from_numpy(_codes(rng, (7, 1024, 8), "int16")).cuda()
    assert torch.equal(qconv1d_cuda(x, w), ref.qconv1d_ref(x, w))
    x = torch.full((1, 4, 65536), -128, dtype=torch.int8, device="cuda")
    w = torch.full((3, 65536, 8), -128, dtype=torch.int8, device="cuda")
    want = ref.qconv1d_ref(x, w)
    assert torch.equal(qconv1d_cuda(x, w), want)
    assert want[0, 1, 0].item() == 3 * 65536 * 16384 - 2 ** 32   # the sum wrapped
    x = torch.from_numpy(_codes(rng, (2, 128, 80), "int16")).cuda()
    w = torch.from_numpy(_codes(rng, (3, 80, 80), "int16")).cuda()
    assert torch.equal(qconv1d_cuda(x, w), ref.qconv1d_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2947, 80, 6), (100, 300, 50), (1, 512, 64),
                                   (128, 512, 128)])
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_cuda_kernel_qmm_matches_plain(m, k, n, dtype):
    _need_card()
    from repro_torch.kernels.qmm import qmm_cuda, qmm_requant_cuda

    rng = np.random.default_rng(m)
    x = torch.from_numpy(_codes(rng, (m, k), dtype)).cuda()
    w = torch.from_numpy(_codes(rng, (k, n), dtype)).cuda()
    assert torch.equal(qmm_cuda(x, w), ref.qmm_ref(x, w))
    for shift in (-33, -3, 0, 11, 32):
        s = torch.tensor(shift, dtype=torch.int32, device="cuda")
        assert torch.equal(qmm_requant_cuda(x, w, s, width=8), ref.qmm_requant_ref(x, w, s))


@pytest.mark.cuda
def test_cuda_kernel_qmm_wraps_at_the_extreme_codes():
    """int8 codes all -128 at (16, 196608) @ (196608, 8): every sum is
    3 * 2^30 and wraps to -2^30 (K split over 8 cluster ranks); int16 codes
    at both ends of the range and next to them, where the byte split's
    high bytes are -128 and 127 and the sums pass int32."""
    _need_card()
    from repro_torch.kernels.qmm import qmm_cuda, qmm_requant_cuda

    x = torch.full((16, 196608), -128, dtype=torch.int8, device="cuda")
    w = torch.full((196608, 8), -128, dtype=torch.int8, device="cuda")
    got = qmm_cuda(x, w)
    assert torch.equal(got, ref.qmm_ref(x, w)) and bool((got == -(1 << 30)).all())
    rng = np.random.default_rng(9)
    extreme = np.array([-32768, -32767, -256, -1, 0, 1, 255, 256, 32767], dtype=np.int16)
    for m, k, n in ((128, 512, 128), (100, 300, 50), (2947, 80, 6)):
        x = torch.from_numpy(rng.choice(extreme, (m, k))).cuda()
        w = torch.from_numpy(rng.choice(extreme, (k, n))).cuda()
        assert torch.equal(qmm_cuda(x, w), ref.qmm_ref(x, w))
        s = torch.tensor(13, dtype=torch.int32, device="cuda")
        assert torch.equal(qmm_requant_cuda(x, w, s, width=16),
                           ref.qmm_requant_ref(x, w, s, width=16))


# ResNetv1-6's conv1 (C=9, padded to 16 channels) and conv4/5 (W'=32: several
# batch rows a block) at a small batch, beside the edge cases
_CARD_CONV_CASES = _CONV_CASES + [(64, 128, 9, 80, 3, 1, "SAME"), (64, 32, 80, 80, 3, 1, "SAME")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,c,f,ksize,stride,padding", _CARD_CONV_CASES)
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_cuda_kernel_qconv1d_matches_plain(b, w, c, f, ksize, stride, padding, dtype):
    _need_card()
    from repro_torch.kernels.qconv1d import qconv1d_cuda

    rng = np.random.default_rng(b + w)
    x = torch.from_numpy(_codes(rng, (b, w, c), dtype)).cuda()
    wgt = torch.from_numpy(_codes(rng, (ksize, c, f), dtype)).cuda()
    assert torch.equal(qconv1d_cuda(x, wgt, stride=stride, padding=padding),
                       ref.qconv1d_ref(x, wgt, stride=stride, padding=padding))


@pytest.mark.cuda
def test_cuda_kernel_fake_quant_matches_plain():
    _need_card()
    from repro_torch.kernels.fake_quant import fake_quant_cuda

    x = torch.randn(3, 1001, device="cuda") * 4
    for n in range(-20, 21):
        assert torch.equal(fake_quant_cuda(x, n), ref.fake_quant_ref(x, n))
