"""Why ``csrc/explog.cu``'s fx_log is bitwise equal to the reference, on the
CPU.

The card's ``fx_log_kernel`` reaches the reference's result by other
steps: one shift after a count of leading zeros instead of the ten
compare-and-shift steps, a ladder whose take bit comes from a sign shift
and feeds multiply-adds instead of selects, and the remainder's floor
division from a float32 quotient estimate with one correction step each
way instead of the int32 division routine.  Here each step is written out
in torch (int64, no wrap reached) as the kernel does it and held against
the reference's steps: the normalisation at every msb and its edges, the
ladder and the division over every z in [2^15, 2^16), the only domain
they reach, and the whole function against ``repro``'s ``fx_log_ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.explog.ref import fx_log_ref as j_fx_log_ref

from repro_torch.kernels.explog.ref import (FX_ONE, LN2, LOG_BAD, LOG_TABLE,
                                            fx_log_ref)

I32 = np.iinfo(np.int32)
EVERY_Z = torch.arange(FX_ONE, 2 * FX_ONE, dtype=torch.int64)


def msb(z: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of z >= 1 (31 - __clz(z))."""
    return sum((z >= (1 << k)).to(torch.int64) for k in range(1, 31))


def kernel_normalise(x: torch.Tensor):
    """The kernel's normalisation: lead = clz(max(x, 1)), z = (z0 << lead)
    as uint32, >> 16; e = msb - 15 = 16 - lead."""
    z0 = x.to(torch.int64).clamp_min(1)
    lead = 31 - msb(z0)
    return ((z0 << lead) & 0xFFFFFFFF) >> 16, 16 - lead


def reference_normalise(x: torch.Tensor):
    """The reference's ten conditional shifts (``fx_log_ref``)."""
    z = x.to(torch.int64).clamp_min(1)
    e = torch.zeros_like(z)
    for shift in (15, 8, 4, 2, 1):
        cond = z >= (FX_ONE << shift)
        z, e = torch.where(cond, z >> shift, z), torch.where(cond, e + shift,
                                                             e)
    for shift in (8, 4, 2, 1, 1):
        cond = z < (FX_ONE >> (shift - 1))
        z, e = torch.where(cond, z << shift, z), torch.where(cond, e - shift,
                                                             e)
    return z, e


def kernel_ladder(z: torch.Tensor):
    """(w, sum of the taken ln(1 + 2^-k)): take = (w + t - z - 1) >>> 31
    as uint32, w += t * take, acc += L_k * take; the last step with
    t = w >> 15 = 1 (w stays in [2^15, 2^16)) and L_15 = 1."""
    w, acc = torch.full_like(z, FX_ONE), torch.zeros_like(z)
    for k in range(1, 15):
        t = w >> k
        take = ((w + t - z - 1) & 0xFFFFFFFF) >> 31
        w, acc = w + t * take, acc + LOG_TABLE[k - 1] * take
    assert bool(((w >> 15) == 1).all()) and LOG_TABLE[14] == 1
    take = ((w - z) & 0xFFFFFFFF) >> 31
    return w + take, acc + take


def reference_ladder(z: torch.Tensor):
    w, acc = torch.full_like(z, FX_ONE), torch.zeros_like(z)
    for k in range(1, 16):
        w_next = w + (w >> k)
        take = w_next <= z
        w = torch.where(take, w_next, w)
        acc = torch.where(take, acc + LOG_TABLE[k - 1], acc)
    return w, acc


def kernel_quotient(r: torch.Tensor, w: torch.Tensor, ulps: int = 0):
    """floor((r << 15) / w) as the kernel takes it: a float32 estimate of
    r / (w 2^-15), here the correctly rounded quotient moved by ``ulps``
    (the card's rcp.approx and product are within 1.5 ulp), truncated,
    then one correction step each way.  Returns (q, estimate)."""
    q_f = (r.double() * FX_ONE / w.double()).to(torch.float32)
    toward = torch.full_like(q_f, np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        q_f = torch.nextafter(q_f, toward).clamp_min(0)
    q0 = q_f.to(torch.int64)                      # truncation, q_f >= 0
    rem = (r << 15) - q0 * w
    return q0 + (rem >= w).long() - (rem < 0).long(), q0


def kernel_fx_log(x: torch.Tensor, ulps: int = 0) -> torch.Tensor:
    z, e = kernel_normalise(x)
    w, acc = kernel_ladder(z)
    q, _ = kernel_quotient(z - w, w, ulps)
    return torch.where(x <= 0, LOG_BAD, e * LN2 + acc + q).to(torch.int32)


def _edges():
    """Every power of two in int32 with its neighbours, and the ends."""
    ks = [v for k in range(31) for v in ((1 << k) - 1, 1 << k,
                                         (1 << k) + 1)]
    return torch.tensor(sorted({min(max(v, I32.min), I32.max) for v in ks
                                + [I32.min, -5, -1, 0, I32.max]}),
                        dtype=torch.int64)


def test_clz_normalisation_matches_the_shift_ladder():
    rng = np.random.default_rng(0)
    x = torch.cat([_edges(), torch.from_numpy(
        rng.integers(1, I32.max, 1 << 16, np.int64, endpoint=True))])
    z, e = kernel_normalise(x)
    z_ref, e_ref = reference_normalise(x)
    assert torch.equal(z, z_ref) and torch.equal(e, e_ref)
    assert bool(((z >= FX_ONE) & (z < 2 * FX_ONE)).all())
    # every msb 0..30 is reached, each at 2^k - 1, 2^k and 2^k + 1
    assert set(msb(x.clamp_min(1)).tolist()) == set(range(31))


def test_select_free_ladder_matches_the_reference_ladder():
    w, acc = kernel_ladder(EVERY_Z)
    w_ref, acc_ref = reference_ladder(EVERY_Z)
    assert torch.equal(w, w_ref) and torch.equal(acc, acc_ref)
    assert bool(((w >= FX_ONE) & (w <= EVERY_Z)).all())


@pytest.mark.parametrize("ulps", [-4, -2, -1, 0, 1, 2, 4])
def test_reciprocal_division_is_the_exact_floor(ulps):
    """Over every z the division meets: the estimate within 4 ulp of the
    quotient truncates to q - 1, q or q + 1, and one step each way gives
    the floor the reference takes."""
    w, _ = reference_ladder(EVERY_Z)
    r = EVERY_Z - w
    assert bool(((r >= 0) & (r < FX_ONE)).all())
    want = torch.div(r << 15, w, rounding_mode="floor")
    got, q0 = kernel_quotient(r, w, ulps)
    assert torch.equal(got, want)
    assert int((q0 - want).abs().max()) <= 1


def test_kernel_steps_match_fx_log_ref():
    rng = np.random.default_rng(1)
    x = torch.cat([_edges(), torch.from_numpy(
        rng.integers(I32.min, I32.max, 1 << 18, np.int64, endpoint=True)),
        EVERY_Z << 3]).to(torch.int32)
    got = kernel_fx_log(x)
    assert torch.equal(got, fx_log_ref(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_fx_log_ref(jnp.asarray(x.numpy()))))
    for ulps in (-2, 2):
        assert torch.equal(kernel_fx_log(x, ulps), got)
