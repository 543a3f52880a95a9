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
from repro_torch.kernels.wkv6 import ops as wkv_ops
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


# ------------------------------------------- WKV-6's chunked backward route

def wkv6_bwd_chunk_algebra(r, k, v, lw, u, state0, dy, dstate, C=64, T=16):
    """A torch transcription of ``csrc/wkv6_bwd_chunked.cu``'s two
    kernels, in float32: chunks of C positions (the last zero-filled: r =
    k = v = dy = 0, lw = 0), sub-chunks of T; every decay factor a product
    of the step decays w = exp(lw) (<= 1), never a quotient.

    1. per chunk (``wkv6_bwd_state_kernel``): A_i = prod_{s<i} w_s and
       Z_j = prod_{s>j} w_s down and up the chunk, decay = prod w, the
       local state dS_loc = (k Z)^T V and cotangent dD_loc = (r A)^T dY;
    2. (the last block of each (batch, head) of the same kernel, or
       ``wkv6_bwd_scan_kernel`` past 8 chunks) S_{n+1} = decay_n S_n +
       dS_loc_n from state0, and the cotangent at each chunk's end from
       dstate:
       dS_{n-1} = decay_n dS_n + dD_loc_n (dstate0 the last);
    3. per chunk (``wkv6_bwd_chunk_kernel``), from S_n and dS_n: within
       sub-chunk I the exclusive prefix H and suffix G products and the
       total T_I; pre_I, suf_I across sub-chunks and g_IJ = prod_{J<M<I}
       T_M; B = dY V^T; A as the forward's (Q (K~ g)^T off the diagonal
       sub-blocks, a running product down each row within them, A_ii =
       r_i . (u k_i));
         dr~ = H (pre (dY S_n^T) + sum_{J<I} B_IJ (K~_J g_IJ)) + the
               diagonal sub-block's pairs,
         dk~ = G (suf (V dS_n^T) + sum_{L>I} B_LI^T (Q_L g_LI)) + pairs,
         dv = (K~ suf) dS_n + A^T dY,
       dlw by the identity restarted at the chunk: phi = sum_v S_{n+1} o
       dS_n, dlw_i = phi + sum_{s>i} (r dr~ - k dk~)_s - k_i dk~_i; the
       bonus u k_i (v_i . dy_i) on dr, u r_i (v_i . dy_i) on dk, and du
       the sum of r k (v . dy).
    Returns the six gradients of ``wkv6_bwd_ref``, dr, dk, dv in r's
    dtype."""
    Bn, Sn, H, D = r.shape
    N = -(-Sn // C)
    n, NS = N * C, C // T

    def chunks(x):
        x = torch.cat([x.float(), x.new_zeros(Bn, n - Sn, H, D).float()], 1)
        return x.reshape(Bn, N, C, H, D)
    rc, kc, vc, yc = chunks(r), chunks(k), chunks(v), chunks(dy)
    wc = torch.exp(chunks(lw))
    # 1. each chunk's decays and local contributions
    A, Z = torch.ones_like(wc), torch.ones_like(wc)
    for i in range(1, C):
        A[:, :, i] = A[:, :, i - 1] * wc[:, :, i - 1]
    for j in range(C - 2, -1, -1):
        Z[:, :, j] = Z[:, :, j + 1] * wc[:, :, j + 1]
    decay = A[:, :, -1] * wc[:, :, -1]                     # (B, N, H, D)
    s_loc = torch.einsum("bnchk,bnchv->bnhkv", kc * Z, vc)
    d_loc = torch.einsum("bnchk,bnchv->bnhkv", rc * A, yc)
    # 2. the two scans over the chunks
    states = [state0]
    for m in range(N):
        states.append(decay[:, m, ..., None] * states[-1] + s_loc[:, m])
    ends, d = [None] * N, dstate
    for m in reversed(range(N)):
        ends[m] = d
        d = decay[:, m, ..., None] * d + d_loc[:, m]
    dstate0 = d
    # 3. the chunk pass
    out = {x: [] for x in ("dr", "dk", "dv", "dlw")}
    du = torch.zeros(H, D)
    sub = lambda x, I: x[:, I * T:(I + 1) * T]             # (B, T, H, D)
    for m in range(N):
        r_, k_, v_, y_, w_ = (x[:, m] for x in (rc, kc, vc, yc, wc))
        S0, Sn1, dS = states[m], states[m + 1], ends[m]
        Hp, G = torch.ones_like(w_), torch.ones_like(w_)
        tot, pre, suf = [], [], [None] * NS
        for I in range(NS):
            b = I * T
            for a in range(1, T):
                Hp[:, b + a] = Hp[:, b + a - 1] * w_[:, b + a - 1]
            for a in range(T - 2, -1, -1):
                G[:, b + a] = G[:, b + a + 1] * w_[:, b + a + 1]
            tot.append(Hp[:, b + T - 1] * w_[:, b + T - 1])  # (B, H, D)
        one = torch.ones_like(tot[0])
        pre.append(one)
        for I in range(1, NS):
            pre.append(pre[-1] * tot[I - 1])
        suf[NS - 1] = one
        for J in range(NS - 2, -1, -1):
            suf[J] = suf[J + 1] * tot[J + 1]

        def gfac(I, J):                                    # J < I
            g = one
            for M in range(J + 1, I):
                g = g * tot[M]
            return g
        Q, Kt = r_ * Hp, k_ * G
        Bm = torch.einsum("bihv,bjhv->bhij", y_, v_)
        Am = torch.zeros(Bn, H, C, C)
        for I in range(NS):
            rows = slice(I * T, (I + 1) * T)
            for J in range(I):
                Am[:, :, rows, J * T:(J + 1) * T] = torch.einsum(
                    "bihk,bjhk->bhij", sub(Q, I),
                    sub(Kt, J) * gfac(I, J)[:, None])
            for j in range(T):
                a = I * T + j
                Am[:, :, a, a] = torch.einsum("bhk,bhk->bh", r_[:, a],
                                              u[None] * k_[:, a])
                kp = k_[:, a]
                for i in range(j + 1, T):
                    if i > j + 1:
                        kp = kp * w_[:, I * T + i - 1]
                    Am[:, :, I * T + i, a] = torch.einsum(
                        "bhk,bhk->bh", r_[:, I * T + i], kp)
        dr, dk, dv = [], [], []
        for I in range(NS):
            rows = slice(I * T, (I + 1) * T)
            acc_r = torch.einsum("bihv,bhcv->bihc", sub(y_, I),
                                 S0 * pre[I][..., None])
            for J in range(I):
                acc_r = acc_r + torch.einsum(
                    "bhij,bjhc->bihc", Bm[:, :, rows, J * T:(J + 1) * T],
                    sub(Kt, J) * gfac(I, J)[:, None])
            acc_k = torch.einsum("bihv,bhcv->bihc", sub(v_, I),
                                 dS * suf[I][..., None])
            for L in range(I + 1, NS):
                acc_k = acc_k + torch.einsum(
                    "bhli,blhc->bihc", Bm[:, :, L * T:(L + 1) * T, rows],
                    sub(Q, L) * gfac(L, I)[:, None])
            acc_v = torch.einsum("bihc,bhcv->bihv",
                                 sub(Kt, I) * suf[I][:, None], dS)
            for L in range(I, NS):
                acc_v = acc_v + torch.einsum(
                    "bhli,blhv->bihv", Am[:, :, L * T:(L + 1) * T, rows],
                    sub(y_, L))
            dr_i, dk_i = sub(Hp, I) * acc_r, sub(G, I) * acc_k
            # the diagonal sub-block's pairs, by running products
            w_i, r_i, k_i = sub(w_, I), sub(r_, I), sub(k_, I)
            Bi = Bm[:, :, rows, rows]
            xr, xk = list(dr_i.unbind(1)), list(dk_i.unbind(1))
            for j in range(T - 1):
                p = k_i[:, j]
                for i in range(j + 1, T):
                    if i > j + 1:
                        p = p * w_i[:, i - 1]
                    xr[i] = xr[i] + Bi[:, :, i, j, None] * p
            for l in range(T - 1, 0, -1):
                p = r_i[:, l]
                for i in range(l - 1, -1, -1):
                    if i < l - 1:
                        p = p * w_i[:, i + 1]
                    xk[i] = xk[i] + Bi[:, :, l, i, None] * p
            dr.append(torch.stack(xr, 1))
            dk.append(torch.stack(xk, 1))
            dv.append(acc_v)
        dr, dk, dv = torch.cat(dr, 1), torch.cat(dk, 1), torch.cat(dv, 1)
        # dlw by the identity restarted at the chunk's end
        acc = (Sn1 * dS).sum(-1)                           # (B, H, D)
        dlw = [None] * C
        for i in range(C - 1, -1, -1):
            kdk = k_[:, i] * dk[:, i]
            dlw[i] = acc - kdk
            acc = acc + (r_[:, i] * dr[:, i] - kdk)
        vdy = torch.diagonal(Bm, dim1=2, dim2=3).permute(0, 2, 1)[..., None]
        out["dr"].append(dr + u * k_ * vdy)
        out["dk"].append(dk + u * r_ * vdy)
        out["dv"].append(dv)
        out["dlw"].append(torch.stack(dlw, 1))
        du = du + (r_ * k_ * vdy).sum((0, 1))
    cat = {x: torch.cat(ts, 1)[:, :Sn] for x, ts in out.items()}
    return (cat["dr"].to(r.dtype), cat["dk"].to(k.dtype),
            cat["dv"].to(v.dtype), cat["dlw"], du, dstate0)


CHUNK_REL = 2.0 ** -16       # the chunked route's limit, of each max
# (form, chunk, decay, r/k/v dtype): the reference's oracle and its
# chunked form (chunks of 8) at the three decay ranges in float32, and
# each form at one range in bf16
CHUNK_ALGEBRA_CASES = (
    [(f, c, d, F32) for f, c in (("sequential", 0), ("chunked", 8))
     for d in sorted(DECAYS)]
    + [("sequential", 0, "strong", BF16), ("chunked", 8, "mixed", BF16)])


@pytest.mark.parametrize("form,chunk,decay,dtype", CHUNK_ALGEBRA_CASES,
                         ids=[f"{f}{c or ''}-{d}-{str(t)[6:]}"
                              for f, c, d, t in CHUNK_ALGEBRA_CASES])
def test_wkv6_bwd_chunk_algebra_matches_reference_vjp(form, chunk, decay,
                                                      dtype):
    """The chunked backward's arithmetic (``wkv6_bwd_chunk_algebra``,
    chunks of 16 in sub-chunks of 4: every off-diagonal sub-block pair)
    over 40 positions (two full chunks and a ragged one, so both scans
    carry), nonzero state0 and dstate, against jax.vjp of the reference's
    wkv_sequential and wkv_chunked: each gradient within 2^-16 of its
    largest magnitude, and one bf16 rounding (2^-7 relative) on bf16 dr,
    dk, dv."""
    inputs, cots = _wkv_case(17, decay, S=40)
    _, want = _wkv_reference(form, chunk, inputs, cots, dtype)
    ts = [torch.from_numpy(x) for x in inputs + cots]
    ts[:3] = [t.to(dtype) for t in ts[:3]]
    got = wkv6_bwd_chunk_algebra(*ts, C=16, T=4)
    for i, name in enumerate(("r", "k", "v", "lw", "u", "state0")):
        g, w = got[i], np.asarray(want[i].astype(jnp.float32))
        assert torch.isfinite(g.float()).all(), name
        if i < 3:
            assert g.dtype == dtype
        rel = BF16_REL if i < 3 and dtype == torch.bfloat16 else 0.0
        _close(g.float().numpy(), w, f"d{name}", CHUNK_REL, rel)


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_wkv6_bwd_chunk_algebra_at_the_kernels_sizes(decay):
    """The chunked backward's arithmetic at the kernels' own sizes (D 64,
    chunks of 64 in sub-chunks of 16) over 200 positions (three chunks and
    a ragged one) against the plain wkv6_bwd_ref, within 2^-16 of each
    gradient's largest magnitude; finite at the strongest decays (log
    decays down to -exp(3) a position underflow w to 0)."""
    inputs, cots = _wkv_case(23, decay, B=1, S=200, D=64)
    ts = [torch.from_numpy(x) for x in inputs + cots]
    got = wkv6_bwd_chunk_algebra(*ts)
    want = wkv6_bwd_ref(*ts)
    for name, g, w in zip(("r", "k", "v", "lw", "u", "state0"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g.numpy(), w.numpy(), f"d{name}", CHUNK_REL)


@pytest.mark.parametrize("D", [8, 16, 32, 64])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 192, 193, 512, 513, 4096])
def test_wkv6_bwd_route(S, D):
    """The backward's route has no knob: head size 64 and at least 64
    positions take the chunked kernels (two launches a call, three past 3
    chunks, where the scans over the chunks take a kernel of their own),
    as the forward takes its chunked kernel; every other shape the walk
    (one)."""
    chunked = D == wkv_ops.CHUNKED_D and S >= wkv_ops.CHUNK
    assert wkv_ops.bwd_route(S, D) == ("chunked" if chunked else "walk")
    assert wkv_ops.bwd_route(S, D) == (
        "chunked" if wkv_ops.route(S, D) == "chunked" else "walk")
    assert wkv_ops.bwd_launches(S, D) == (
        (2 if S <= 3 * 64 else 3) if chunked else 1)
