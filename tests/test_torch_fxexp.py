"""Why ``csrc/explog.cu``'s fx_exp is bitwise equal to the reference, on the
CPU.

The card computes fx_exp by other steps than the reference: a floor
division by LN2 as a multiply-high and a shift, and then either the
ladder's mantissa as floor(2^15 exp(r 2^-15)) from the card's float32
exp plus an int8 correction looked up in a table of LN2 entries (the
table route), or the ladder with its take bit from a sign shift feeding
multiply-adds (the ladder route), with no first-order remainder term,
and a saturating 2^n shift as one clamped uint32 right shift.  Here each
step is written out in torch (int64; the float32 exp from torch, moved
by a few ulp to stand for the card's ex2.approx, whose bits the table's
build on the card pairs with its own corrections) and held against the
reference's steps and against ``repro``'s ``fx_exp_ref`` over every
input of the clamped domain, the int32 ends and a seeded sample.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.explog.explog import fx_exp_pallas
from repro.kernels.explog.ref import FX_ONE as J_FX_ONE
from repro.kernels.explog.ref import LN2 as J_LN2
from repro.kernels.explog.ref import LOG_TABLE as J_LOG_TABLE
from repro.kernels.explog.ref import fx_exp_ref as j_fx_exp_ref

from repro_torch.kernels.explog.ops import EXP_TABLE_ENTRIES, exp_route
from repro_torch.kernels.explog.ref import (FX_ONE, INT32_MAX, LN2,
                                            LOG_TABLE, MAX_EXP_ARG,
                                            fx_exp_ref)

I32 = np.iinfo(np.int32)
# the kernels' floor division (csrc/explog.cu): u = clamp(x) + 22 LN2,
# q = umulhi(u, MAGIC) >> SHIFT, n = q - 22
BIAS, MAGIC, SHIFT = 22 * LN2, 3025558, 4
LOG2E_FX = np.float32(1.4426950408889634 / 32768)
ULPS = (-4, -1, 0, 1, 4)


def reference_mantissa():
    """(M, remainder) of the reference's ladder for every r in [0, LN2),
    with ``repro``'s own constants."""
    r = torch.arange(J_LN2, dtype=torch.int64)
    y = torch.full_like(r, J_FX_ONE)
    for k in range(1, 16):
        lk = J_LOG_TABLE[k - 1]
        take = r >= lk
        r = torch.where(take, r - lk, r)
        y = torch.where(take, y + (y >> k), y)
    return y, r


def exp_approx(r: torch.Tensor, ulps: int = 0) -> torch.Tensor:
    """floor(2^t), t = fma(r, log2(e) 2^-15, 15) in float32 (the product
    and the sum are exact in float64, so one rounding, as the card's
    FFMA), 2^t in float32 moved by ``ulps``, as the card's ex2.approx may
    be."""
    t = (r.double() * float(LOG2E_FX) + 15.0).to(torch.float32)
    e = torch.exp2(t)
    toward = torch.full_like(e, np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        e = torch.nextafter(e, toward)
    return torch.floor(e).to(torch.int64)


def build_table(ulps: int = 0) -> torch.Tensor:
    """The table's build: the mantissa minus the approximation, int8."""
    m, _ = reference_mantissa()
    d = m - exp_approx(torch.arange(LN2), ulps)
    assert bool(((d >= -128) & (d <= 127)).all())
    return d


def kernel_reduce(x: torch.Tensor):
    """(q, r) as the kernels take them: clamp, bias, multiply-high (the
    high 32 bits of a 32 x 32 product) and shift, r = u - q LN2."""
    u = x.to(torch.int64).clamp(-MAX_EXP_ARG, MAX_EXP_ARG) + BIAS
    assert bool(((u >= 0) & (u < 1 << 20)).all())
    q = ((u * MAGIC) >> 32) >> SHIFT
    return q, u - q * LN2


def kernel_scale(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M 2^n with n = q - 22: (M << 16) >> (38 - q) as uint32, where PTX
    clamps an amount of 32 or more (or a negative one, as uint32) to 32,
    which gives 0; q >= 38 (n >= 16) saturates."""
    a = 38 - q
    shifted = torch.where((a >= 0) & (a < 32),
                          ((m << 16) & 0xFFFFFFFF) >> a.clamp(0, 31), 0)
    return torch.where(q >= 38, INT32_MAX, shifted)


def kernel_ladder(r: torch.Tensor):
    """The ladder route's steps: take = (L_k - 1 - r) >>> 31 as uint32,
    r -= L_k take, y += (y >> k) take; returns (y, what is left of r)."""
    y = torch.full_like(r, FX_ONE)
    for k in range(1, 16):
        lk = LOG_TABLE[k - 1]
        take = ((lk - 1 - r) & 0xFFFFFFFF) >> 31
        r, y = r - lk * take, y + (y >> k) * take
    return y, r


def table_route(x: torch.Tensor, ulps: int = 0) -> torch.Tensor:
    """Correction table and lookups from one and the same approximation."""
    table = build_table(ulps)
    q, r = kernel_reduce(x)
    return kernel_scale(exp_approx(r, ulps) + table[r], q).to(torch.int32)


def ladder_route(x: torch.Tensor) -> torch.Tensor:
    q, r = kernel_reduce(x)
    return kernel_scale(kernel_ladder(r)[0], q).to(torch.int32)


def inputs(seed: int = 0) -> torch.Tensor:
    """Every x of the clamped domain and 4 past each end, the int32 ends
    and 10^5 seeded int32."""
    rng = np.random.default_rng(seed)
    return torch.cat([
        torch.arange(-MAX_EXP_ARG - 4, MAX_EXP_ARG + 5, dtype=torch.int64),
        torch.tensor([I32.min, I32.min + 1, I32.max - 1, I32.max]),
        torch.from_numpy(rng.integers(I32.min, I32.max, 10**5, np.int64,
                                      endpoint=True))]).to(torch.int32)


@pytest.fixture(scope="module")
def want():
    x = inputs()
    return x, torch.from_numpy(np.asarray(j_fx_exp_ref(jnp.asarray(
        x.numpy()))).copy())


def test_mantissa_table_is_what_the_table_route_relies_on():
    m, rem = reference_mantissa()
    assert m.numel() == LN2 == J_LN2 and LN2 <= EXP_TABLE_ENTRIES
    assert EXP_TABLE_ENTRIES % 16 == 0          # whole 16-byte words
    assert bool((rem == 0).all())               # the ladder leaves nothing
    assert bool(((m >= 1 << 15) & (m < 1 << 16)).all())
    assert bool((m[1:] > m[:-1]).all())         # strictly increasing
    y, r = kernel_ladder(torch.arange(LN2, dtype=torch.int64))
    assert torch.equal(y, m) and bool((r == 0).all())


@pytest.mark.parametrize("ulps", ULPS)
def test_corrections_are_small_for_a_nearby_exp(ulps):
    """The mantissa lies within [-7, 2] of the exact floor(2^15 exp(r
    2^-15)); an approximation a few ulp off keeps the difference far
    inside int8."""
    m, _ = reference_mantissa()
    r = torch.arange(LN2, dtype=torch.float64)
    exact = m - torch.floor(torch.exp(r / FX_ONE) * FX_ONE).to(torch.int64)
    assert int(exact.min()) == -7 and int(exact.max()) == 2
    d = build_table(ulps)
    assert int(d.min()) >= -9 and int(d.max()) <= 4


def test_multiply_high_division_is_the_floor(want):
    x, _ = want
    q, r = kernel_reduce(x)
    xc = x.to(torch.int64).clamp(-MAX_EXP_ARG, MAX_EXP_ARG)
    n = torch.div(xc, LN2, rounding_mode="floor")
    assert torch.equal(q - 22, n) and torch.equal(r, xc - n * LN2)
    assert bool(((r >= 0) & (r < LN2)).all())
    assert int(n.min()) == -22 and int(n.max()) == 21   # the clamp of n
                                                        # to +-31 never acts


@pytest.mark.parametrize("route", ["table", "ladder"])
def test_kernel_routes_match_fx_exp_ref(want, route):
    x, ref = want
    got = table_route(x) if route == "table" else ladder_route(x)
    assert torch.equal(got, ref)
    assert torch.equal(fx_exp_ref(x), ref)
    if route == "table":
        for ulps in (-4, 4):
            assert torch.equal(table_route(x, ulps), ref)


def test_routes_by_element_count():
    assert exp_route(1) == "ladder"         # the paths' one element
    assert exp_route(1 << 20) == "table"


def test_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(3)
    x = rng.integers(-(16 << 15), 16 << 15, (256, 128), np.int64,
                     endpoint=True).astype(np.int32)
    got = np.asarray(fx_exp_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        got, table_route(torch.from_numpy(x.ravel())).numpy().reshape(
            x.shape))
