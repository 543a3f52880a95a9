"""The backwards of the port's recurrence kernels on the CPU: autograd
through ``rg_lru`` (the ``LinearScan`` Function, so
``linear_scan_bwd_ref``) and ``wkv6`` (the ``WKV6`` Function, so
``wkv6_bwd_ref``) against ``jax.vjp`` of the reference's ``rg_lru``,
``wkv_sequential`` and ``wkv_chunked``, with nonzero cotangents on the
output and on the final state.

Tolerances, of each gradient's largest magnitude: float32 1e-5 against
the reference (the chunked forms sum in another order); the plain
backwards against autograd of their own plain forwards 1e-6.  A bf16 r,
k or v takes a bf16 gradient in both packages, rounded once from float32
sums that differ in order, so those three are held at one bf16 rounding
(one bf16 ulp: 2^-7 relative at most) beside 1e-5 of the largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro.models import rwkv6 as JW

from repro_torch.kernels.linear_scan import (linear_scan_bwd_ref,
                                             linear_scan_ref)
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd_ref, wkv6_ref
from repro_torch.models import rglru as TR

TOL, PLAIN_TOL, BF16_REL = 1e-5, 1e-6, 2.0 ** -7


def _close(got, want, what, tol=TOL, rel=0.0):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _torch(x, grad=True):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


# ------------------------------------------------------------------ RG-LRU

RGLRU_LEAVES = ("wi", "bi", "wa", "ba", "lam")


def _rglru_case(seed, B=2, S=24, w=8, lam=None):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    p = {"wi": f(w, w, scale=0.3), "bi": f(w, scale=0.1),
         "wa": f(w, w, scale=0.3), "ba": f(w, scale=0.1),
         "lam": (np.abs(f(w)) + 0.3 if lam is None
                 else np.full(w, lam, np.float32))}
    u, h0 = f(B, S, w), f(B, w)
    dy, dh = f(B, S, w), f(B, w)
    return p, u, h0, dy, dh


@pytest.mark.parametrize("lam", [None, -40.0], ids=["lam", "clamped"])
@pytest.mark.parametrize("chunk", [4, 1024])
def test_rg_lru_grads_match_reference_vjp(chunk, lam):
    """Gradients of u, wi, bi, wa, ba, lam and h0 through the port's
    rg_lru against jax.vjp of the reference's (chunk 4: six chunks of
    the associative scan; 1024: one).  lam -40: softplus(lam) ~ 4e-18,
    a = 1 in float32 and beta's 1e-12 clamp holds everywhere."""
    p, u, h0, dy, dh = _rglru_case(7, lam=lam)
    fn = lambda p, u, h0: JR.rg_lru(p, u, h0, chunk=chunk)
    (y, hf), vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(u), jnp.asarray(h0))
    jp, ju, jh0 = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tp = {k: _torch(v) for k, v in p.items()}
    tu, th0 = _torch(u), _torch(h0)
    ty, thf = TR.rg_lru(tp, tu, th0)
    assert ty.grad_fn is not None
    _close(ty.detach().numpy(), y, "y")
    _close(thf.detach().numpy(), hf, "h_final")
    torch.autograd.backward((ty, thf), (torch.from_numpy(dy),
                                        torch.from_numpy(dh)))
    for k in RGLRU_LEAVES:
        _close(tp[k].grad.numpy(), jp[k], f"d{k}")
    _close(tu.grad.numpy(), ju, "du")
    _close(th0.grad.numpy(), jh0, "dh0")


@pytest.mark.parametrize("lam", [None, -40.0], ids=["lam", "clamped"])
def test_linear_scan_bwd_ref_matches_autograd(lam):
    """linear_scan_bwd_ref against autograd through linear_scan_ref's own
    loop, at 1e-6."""
    rng = np.random.default_rng(3)
    B, S, w = 2, 9, 6
    xi, xa, u = (_torch(rng.standard_normal((B, S, w)).astype(np.float32))
                 for _ in range(3))
    lam_v = (rng.standard_normal(w) if lam is None
             else np.full(w, lam)).astype(np.float32)
    lam_t = _torch(lam_v)
    h0 = _torch(rng.standard_normal((B, w)).astype(np.float32))
    y, hf = linear_scan_ref(xi, xa, u, lam_t, h0)
    dy, dh = torch.randn_like(y), torch.randn_like(hf)
    want = torch.autograd.grad((y, hf), (xi, xa, u, lam_t, h0), (dy, dh))
    got = linear_scan_bwd_ref(xi.detach(), xa.detach(), u.detach(),
                              lam_t.detach(), h0.detach(), y.detach(), dy,
                              dh)
    for name, g, wnt in zip(("xi", "xa", "u", "lam", "h0"), got, want):
        _close(g.numpy(), wnt.numpy(), f"d{name}", PLAIN_TOL)


# ------------------------------------------------------------------- WKV-6

DECAYS = {"mixed": (-6.0, 2.0), "strong": (-8.0, 3.0), "weak": (-10.0, -5.0)}


def _wkv_case(seed, decay, B=2, S=32, H=2, D=8):
    """The reference test's inputs (tests/test_rwkv_rglru.py::_wkv_inputs)
    and cotangents, numpy float32."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = mk(B, S, H, D), mk(B, S, H, D), mk(B, S, H, D)
    lo, hi = DECAYS[decay]
    lw = (-np.exp(rng.uniform(lo, hi, (B, S, H, D)))).astype(np.float32)
    u, s0 = mk(H, D), mk(B, H, D, D)
    dy, ds = mk(B, S, H, D), mk(B, H, D, D)
    return (r, k, v, lw, u, s0), (dy, ds)


def _wkv_reference(form, chunk, inputs, cots, dtype):
    """jax.vjp of the reference's wkv_sequential or wkv_chunked: (y,
    state) and the six gradients; r, k, v in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x) for x in inputs]
    args[:3] = [a.astype(jdt) for a in args[:3]]
    if form == "sequential":
        fn = JW.wkv_sequential
    else:
        fn = lambda *a: JW.wkv_chunked(*a, chunk=chunk)
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(tuple(jnp.asarray(c) for c in cots))


def _wkv_port(inputs, cots, dtype):
    """Autograd through the port's wkv6 (the WKV6 Function on CPU
    tensors): (y, state) and the six gradients."""
    ts = [_torch(x) for x in inputs]
    ts[:3] = [t.detach().to(dtype).requires_grad_() for t in ts[:3]]
    y, st = wkv6(*ts)
    assert y.grad_fn is not None
    torch.autograd.backward((y, st), tuple(torch.from_numpy(c)
                                           for c in cots))
    return (y, st), [t.grad for t in ts]


F32, BF16 = torch.float32, torch.bfloat16
# (form, chunk, decay, r/k/v dtype): every form at the three decay ranges
# in float32, and each form once with bf16 r, k, v
WKV_CASES = ([(f, c, d, F32) for f, c in (("sequential", 0), ("chunked", 8),
                                          ("chunked", 16))
              for d in sorted(DECAYS)]
             + [("sequential", 0, "mixed", BF16), ("chunked", 8, "weak", BF16),
                ("chunked", 16, "strong", BF16)])


@pytest.mark.parametrize("form,chunk,decay,dtype", WKV_CASES,
                         ids=[f"{f}{c or ''}-{d}-{str(t)[6:]}"
                              for f, c, d, t in WKV_CASES])
def test_wkv6_grads_match_reference_vjp(form, chunk, decay, dtype):
    """dr, dk, dv, dlw, du and dstate0 through the port's wkv6 against
    jax.vjp of the reference's sequential oracle and its chunked form
    (chunks 8 and 16 over 32 positions), at the reference test's three
    decay ranges, with r, k, v in float32 and in bf16."""
    inputs, cots = _wkv_case(11, decay)
    (y, st), want = _wkv_reference(form, chunk, inputs, cots, dtype)
    (ty, tst), got = _wkv_port(inputs, cots, dtype)
    # the forward at the reference test's own tolerance for the chunked
    # form (5e-4), float32 agreement for the oracle
    tol = TOL if form == "sequential" else 5e-4
    _close(ty.detach().numpy(), np.asarray(y, np.float32), "y", tol)
    _close(tst.detach().numpy(), np.asarray(st, np.float32), "state", tol)
    for i, name in enumerate(("r", "k", "v", "lw", "u", "state0")):
        g, w = got[i], np.asarray(want[i].astype(jnp.float32))
        if i < 3:
            assert g.dtype == dtype
        rel = BF16_REL if i < 3 and dtype == torch.bfloat16 else 0.0
        _close(g.float().numpy(), w, f"d{name}", TOL, rel)


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_wkv6_bwd_ref_matches_autograd(decay):
    """wkv6_bwd_ref against autograd through wkv6_ref's own loop, at
    1e-6."""
    inputs, (dy, ds) = _wkv_case(5, decay, S=12, D=4)
    ts = [_torch(x) for x in inputs]
    y, st = wkv6_ref(*ts)
    want = torch.autograd.grad((y, st), ts, (torch.from_numpy(dy),
                                             torch.from_numpy(ds)))
    got = wkv6_bwd_ref(*(t.detach() for t in ts), torch.from_numpy(dy),
                       torch.from_numpy(ds))
    for name, g, w in zip(("r", "k", "v", "lw", "u", "state0"), got, want):
        _close(g.numpy(), w.numpy(), f"d{name}", PLAIN_TOL)


def test_wkv6_without_grad_records_nothing():
    """Without grad the wrapper is the serving call: no graph."""
    inputs, _ = _wkv_case(2, "mixed", S=4)
    ts = [_torch(x) for x in inputs]
    with torch.no_grad():
        y, st = wkv6(*ts)
    assert y.grad_fn is None and st.grad_fn is None
    y2, _ = wkv6(*(t.detach() for t in ts))
    assert y2.grad_fn is None and torch.equal(y, y2)
