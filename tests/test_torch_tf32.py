"""Why the float32 flash kernel multiplies in 3xTF32, on the CPU.

The card's float32 attention kernel (``csrc/flash_attn.cu``,
``flash_attn_tf32_kernel``) runs both products on TF32 tensor cores,
which keep 10 of float32's 23 mantissa bits.  Each operand x is split
into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and each product is taken
as a_hi b_hi + a_hi b_lo + a_lo b_hi with float32 sums.  Here the split is
written out in torch as the kernel does it: TF32 rounding is
round-to-nearest (ties away from zero) on the float32 bit pattern, the
rounding of ``cvt.rna.tf32.f32``, and the products of two TF32 values are
exact in float32.  On seeded attention the three-product result stays
within the card's float32 tolerance of the plain version (atol 2e-5,
rtol 1e-4) and one TF32 product does not.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import flash_attention_ref

TOL = dict(atol=2e-5, rtol=1e-4)     # chip_smoke.py's float32 ATTN_TOL
SHAPES = [((1, 256, 4, 128), True), ((1, 256, 4, 128), False),
          ((2, 100, 2, 64), True)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32: the low 13 mantissa bits cleared after adding
    half of their range to the magnitude (round to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, three: bool):
    """a @ b on TF32 operands: a_hi b_hi + a_hi b_lo + a_lo b_hi, or one
    product of the rounded operands."""
    (ah, al), (bh, bl) = split(a), split(b)
    if not three:
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def attention_tf32(q, k, v, causal, three: bool):
    """Softmax attention on (BH, S, D) float32 with both products in
    TF32, the online softmax's arithmetic left in float32."""
    S, D = q.shape[1], q.shape[2]
    s = product(q, k.transpose(1, 2), three) / np.float32(np.sqrt(D))
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p, v, three) / p.sum(-1, keepdim=True)


def _inputs(shape):
    B, S, H, D = shape
    rng = np.random.default_rng(sum(shape))
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .transpose(1, 2).reshape(B * H, S, D) for _ in range(3)]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11),
                      1 + 2**-10 + 2**-11, 3.0e-20], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-10, -(1 + 2**-10),
                         1 + 2**-9, 3.0e-20], dtype=torch.float32)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x)
    assert (hi + lo - x).abs().max() <= 2**-21 * x.abs().max()


def test_tf32_split_keeps_each_operand():
    """hi + lo holds each value to float32's own rounding near 2^-22, and
    hi is a TF32 value (13 low mantissa bits clear)."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float((hi + lo - x).abs().max()) <= 2.0 ** -21 * float(
        x.abs().max())


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_three_tf32_products_stay_in_the_float32_tolerance(shape, causal):
    q, k, v = _inputs(shape)
    want = flash_attention_ref(q, k, v, causal=causal)
    got = attention_tf32(q, k, v, causal, three=True)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_one_tf32_product_misses_the_float32_tolerance(shape, causal):
    q, k, v = _inputs(shape)
    want = flash_attention_ref(q, k, v, causal=causal)
    got = attention_tf32(q, k, v, causal, three=False)
    limit = TOL["atol"] + TOL["rtol"] * want.abs()
    assert ((got - want).abs() > limit).any()
