"""The MAC plain versions where an int32 sum leaves the int32 range, on
the CPU, against the JAX reference.

The reference accumulates in int32 (``jnp.matmul`` and ``lax.conv`` on
int32 operands), so a sum past 2**31 - 1 wraps to its low 32 bits.  The
port's plain versions sum exactly in float64 and must give the same
wrapped value, not a saturated one.  A uint8 sum can first leave the
range at K = 33025 (33025 * 255**2 > 2**31); the cases fill the operands
with 255 or -128 so that every output does.  Compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mac_conv import mac_conv2d_ref as j_mac_conv2d_ref
from repro.kernels.mac_gemm import mac_gemm as j_mac_gemm
from repro.kernels.mac_gemm import mac_gemm_dequant_ref as j_dequant_ref
from repro.kernels.mac_gemm import mac_gemm_ref as j_mac_gemm_ref

from repro_torch.kernels import mac_conv2d, mac_gemm
from repro_torch.kernels.mac_gemm import mac_gemm_dequant_ref, mac_gemm_ref


def _wrapped(total: int) -> int:
    return (total + 2**31) % 2**32 - 2**31


GEMM_CASES = [  # (a fill, a shape, b fill, b shape, numpy dtype)
    (255, (2, 40000), 255, (40000, 3), np.uint8),
    (-128, (1, 140000), -128, (140000, 1), np.int8),
]


@pytest.mark.parametrize("fa,a_shape,fb,b_shape,dt", GEMM_CASES)
def test_mac_gemm_wraps_as_the_reference(fa, a_shape, fb, b_shape, dt):
    a, b = np.full(a_shape, fa, dt), np.full(b_shape, fb, dt)
    got = mac_gemm(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(j_mac_gemm_ref(jnp.asarray(a), jnp.asarray(b)))
    assert want.dtype == np.int32
    assert (want == _wrapped(a_shape[1] * fa * fb)).all()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mac_gemm_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)


def test_mac_gemm_wraps_as_the_pallas_kernel():
    """The reference's Pallas kernel, interpret mode, at K = 40000."""
    a = np.full((2, 40000), 255, np.uint8)
    b = np.full((40000, 3), 255, np.uint8)
    want = np.asarray(j_mac_gemm(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        mac_gemm(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    assert (want == -1693967296).all()


def test_mac_gemm_dequant_inherits_the_wrap():
    a = np.full((2, 40000), 255, np.uint8)
    b = np.full((40000, 3), 255, np.uint8)
    sa = np.array([0.5, 2.0], np.float32)
    sb = np.array([1.0, 0.25, 3.0], np.float32)
    got = mac_gemm_dequant_ref(*(torch.from_numpy(t) for t in (a, b, sa,
                                                                sb)))
    want = j_dequant_ref(*(jnp.asarray(t) for t in (a, b, sa, sb)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CONV_CASES = [  # (x shape, w shape, padding): 1x1 over 40000 channels,
    # 3x3 over 3700 (9 * 3700 = 33300 taps); SAME leaves the border
    # outputs fewer taps, so some sums wrap and some do not
    ((1, 2, 3, 40000), (1, 1, 40000, 2), "VALID"),
    ((1, 4, 4, 3700), (3, 3, 3700, 2), "SAME"),
]


@pytest.mark.parametrize("xs,ws,pad", CONV_CASES)
def test_mac_conv2d_wraps_as_the_reference(xs, ws, pad):
    x, w = np.full(xs, 255, np.uint8), np.full(ws, 255, np.uint8)
    got = mac_conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=pad)
    want = np.asarray(j_mac_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                       padding=pad))
    assert want.dtype == np.int32
    assert (want == _wrapped(ws[0] * ws[1] * ws[2] * 255 * 255)).any()
    np.testing.assert_array_equal(got.numpy(), want)
