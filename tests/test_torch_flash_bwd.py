"""The flash-attention backward of the port (``flash_attention_bwd_ref``,
the log-sum-exp of ``flash_attention_ref`` and the autograd path of
``flash_attention_kernel``) against the reference's model attention, on
the CPU.

The reference differentiates its attention with ``_flash_attention``, a
``custom_vjp`` whose backward ``_flash_bwd`` recomputes P from the
forward's log-sum-exp (``models/layers.py:284-349``), and, below 4 Mi
scores, by autograd through ``attention_dense``.  The same numpy inputs
and cotangent go to ``jax.vjp`` of both and to the port's plain backward,
with the port's own output and lse as its inputs; float32 throughout, so
every gradient is held at 1e-5 of its largest magnitude (and 1e-5
relative).  The reference's attention is causal; ``causal=False`` is held
against autograd through the port's plain forward.  Layouts: the
reference's q (B, S, KH, G, D) is the port's (B, S, KH G, D), query head
kh G + g meeting KV head kh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels import flash_attention_bwd, flash_attention_kernel
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)
from test_torch_tf32 import split


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the suite runs several worker
    processes at once, and smoke-width steps on many threads each
    oversubscribe the cores (a step then takes tens of times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
CHUNK = 32               # the reference's blockwise query and kv chunks
# (B, S, KH, G, D, window)
# rg_d256: RecurrentGemma's local attention, 10 query heads over 1 KV
# head of 256, window 8 at S 32
CASES = {"mha_d128": (2, 64, 2, 1, 128, 0), "gqa_d64": (1, 96, 2, 3, 64, 0),
         "window_d64": (2, 96, 3, 2, 64, 40),
         "window_d128": (1, 128, 1, 4, 128, 17),
         "rg_d256": (1, 32, 1, 10, 256, 8)}


def _inputs(B, S, KH, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KH, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KH, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, KH, G, D)).astype(np.float32)
    return q, k, v, do


def _port(x):
    """A (B, S, KH, G, D) array as the port's (B, S, KH G, D) tensor."""
    B, S = x.shape[:2]
    return torch.from_numpy(x.reshape(B, S, -1, x.shape[-1]).copy())


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _port_forward(q, k, v, window, causal=True):
    """(o, lse (B, H, S)) of the port's plain forward."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    o, lse = flash_attention_ref(
        fold(q), fold(k.repeat_interleave(G, 2)),
        fold(v.repeat_interleave(G, 2)), causal=causal, window=window,
        return_lse=True)
    return o.reshape(B, H, S, D).transpose(1, 2), lse.reshape(B, H, S)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_blockwise_forward(case):
    B, S, KH, G, D, window = CASES[case]
    q, k, v, _ = _inputs(B, S, KH, G, D, 1)
    pos = jnp.arange(S)
    out, lse = JL._bw_attn_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), pos, pos, window, CHUNK,
                               CHUNK)
    o, got = _port_forward(_port(q), _port(k), _port(v), window)
    _close(o.numpy(), out, "output")
    # the reference's (B, S, KH, G) against the port's (B, KH G, S)
    _close(got.transpose(1, 2).numpy(), np.asarray(lse).reshape(B, S, -1),
           "lse")


@pytest.mark.parametrize("attn", ["flash_custom_vjp", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_reference_vjp(case, attn):
    B, S, KH, G, D, window = CASES[case]
    q, k, v, do = _inputs(B, S, KH, G, D, 2)
    pos = jnp.arange(S)
    if attn == "dense":
        fn = lambda q, k, v: JL.attention_dense(q, k, v, pos, pos,
                                                window=window)
    else:
        fn = lambda q, k, v: JL._flash_attention((window, CHUNK, CHUNK), q,
                                                 k, v, pos, pos)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _port(q), _port(k), _port(v)
    o, lse = _port_forward(tq, tk, tv, window)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, _port(do),
                                  window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w, f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_path_matches_plain_autograd(case, causal):
    """torch.autograd.grad through flash_attention_kernel on CPU tensors
    (the autograd Function: the plain forward with lse, then
    flash_attention_bwd) against autograd through flash_attention_ref."""
    B, S, KH, G, D, window = CASES[case]
    q, k, v, do = (_port(x) for x in _inputs(B, S, KH, G, D, 3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention_kernel(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    H = KH * G
    fold = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    plain = flash_attention_ref(
        fold(q), fold(k.repeat_interleave(G, 2)),
        fold(v.repeat_interleave(G, 2)), causal=causal,
        window=window).reshape(B, H, S, D).transpose(1, 2)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  plain.detach().numpy())
    want = torch.autograd.grad(plain, (q, k, v), do)
    for name, g, w in zip("qkv", got, want):
        _close(g.numpy(), w.numpy(), f"d{name}")


def test_no_grad_call_saves_nothing():
    """Without grad the wrapper is the serving call: no graph, no lse."""
    q, k, v, _ = (_port(x) for x in _inputs(1, 32, 2, 1, 64, 4))
    q.requires_grad_()
    with torch.no_grad():
        out = flash_attention_kernel(q, k, v)
    assert out.grad_fn is None
    assert flash_attention_kernel(q.detach(), k, v).grad_fn is None


def test_bwd_wrapper_checks_its_inputs():
    q = torch.ones(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, lse[:, :1], q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q[:, :4], lse, q)
    dq, dk, dv = flash_attention_bwd(q, q, q, q, lse, q)
    assert dq.shape == dk.shape == dv.shape == q.shape


# ---------------------------------------- the card's wgmma route, on the CPU

BF16_TOL = 2.0 ** -6     # the card's bf16 limit, of each gradient's max
# (B, S, KH, G, D, window): G 1 (Qwen1.5-4B), 2 (Gemma-3's 32 over 16) and
# 16 (GLM-4-9B's 32 over 2)
SPLIT_CASES = {"g1": (1, 96, 2, 1, 64, 0), "g2_window": (1, 96, 2, 2, 64, 40),
               "g16": (1, 64, 1, 16, 64, 0), "g16_d128": (1, 64, 1, 16, 128, 0)}


def _bwd_wgmma_arithmetic(q, k, v, o, lse, do, window):
    """The wgmma route's arithmetic written out in torch on (B, S, h, D)
    tensors: P = 2^(S scale log2(e) - lse log2(e)) under the mask, P and
    dS rounded to bf16 once for their products (float32 sums), each query
    head's dK and dV a float32 partial, summed over a KV head's G query
    heads in head order and rounded to bf16 once."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    log2e = 1.4426950408889634
    scale = 1.0 / np.sqrt(D)
    heads = lambda t: t.float().transpose(1, 2)            # (B, h, S, D)
    qf, kf, vf, of, dof = (heads(t) for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    lse2 = lse.float() * log2e
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    if window:
        keep &= ~torch.ones(S, S, dtype=torch.bool).tril(-window)
    rnd = lambda t: t.bfloat16().float()
    dq = torch.empty_like(qf)
    part_k = torch.empty(B, H, S, D)
    part_v = torch.empty(B, H, S, D)
    for h in range(H):
        kh, vh = kf[:, h // G], vf[:, h // G]
        s = qf[:, h] @ kh.transpose(-1, -2)
        p = torch.where(keep, torch.exp2(s * (scale * log2e)
                                         - lse2[:, h, :, None]), 0.0)
        dp = dof[:, h] @ vh.transpose(-1, -2)
        ds = p * (dp - delta[:, h, :, None]) * scale
        part_v[:, h] = rnd(p).transpose(-1, -2) @ dof[:, h]
        part_k[:, h] = rnd(ds).transpose(-1, -2) @ qf[:, h]
        dq[:, h] = rnd(ds) @ kh
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for h in range(H):                     # head order, a KV head's group
        dk[:, h // G] += part_k[:, h]
        dv[:, h // G] += part_v[:, h]
    back = lambda t: t.transpose(1, 2).bfloat16()
    return back(dq), back(dk), back(dv)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_gqa_split_matches_reference_vjp(case):
    """The wgmma route's GQA split (per-query-head float32 partial dK and
    dV summed in head order, rounded once; P and dS in bf16 for their
    products) on bf16 inputs against jax.vjp of the reference's
    _flash_attention (float32 on the same bf16 values) at the card's bf16
    limit: 2^-6 of the larger of each gradient's and dV's largest
    magnitude."""
    B, S, KH, G, D, window = SPLIT_CASES[case]
    bf = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())
    q, k, v, do = (bf(x) for x in _inputs(B, S, KH, G, D, 5))
    pos = jnp.arange(S)
    fn = lambda q, k, v: JL._flash_attention((window, CHUNK, CHUNK), q, k,
                                             v, pos, pos)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w).reshape(B, S, -1, D) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (_port(x).bfloat16() for x in (q, k, v, do))
    o, lse = _port_forward(tq.float(), tk.float(), tv.float(), window)
    got = _bwd_wgmma_arithmetic(tq, tk, tv, o.bfloat16(), lse, tdo, window)
    scale = float(np.abs(want[2]).max())
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BF16_TOL * max(float(np.abs(w).max()), scale), \
            (name, err)


# ----------------------------------------- the card's tf32 route, on the CPU

F32_TOL = 2.0 ** -14     # the card's float32 limit, of each gradient's max


def _mm3(a, b, three=True):
    """a @ b as the tf32 kernels take it: a_hi b_hi + a_hi b_lo + a_lo b_hi
    (test_torch_tf32's split: TF32 rounding on the bit pattern, products
    of TF32 values exact in float32), or one TF32 product."""
    (ah, al), (bh, bl) = split(a), split(b)
    if not three:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _bwd_tf32_arithmetic(q, k, v, o, lse, do, window, three=True):
    """The tf32 route's arithmetic written out in torch on float32 (B, S,
    h, D) tensors: delta = rowsum(dO o O), P = 2^(S scale log2(e) - lse
    log2(e)) under the mask, dS = P (dP - delta) scale, each of the five
    products (S, dP, dV, dK, dQ) in three TF32 terms (``three=False``:
    one) with float32 sums, each query head's dK and dV a float32 partial,
    summed over a KV head's G query heads in head order."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    log2e = 1.4426950408889634
    scale = 1.0 / np.sqrt(D)
    heads = lambda t: t.transpose(1, 2).contiguous()        # (B, h, S, D)
    qf, kf, vf, of, dof = (heads(t) for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    lse2 = lse * log2e
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    if window:
        keep &= ~torch.ones(S, S, dtype=torch.bool).tril(-window)
    mm = lambda a, b: _mm3(a, b, three)
    dq = torch.empty_like(qf)
    part_k = torch.empty(B, H, S, D)
    part_v = torch.empty(B, H, S, D)
    for h in range(H):
        kh, vh = kf[:, h // G], vf[:, h // G]
        s = mm(qf[:, h], kh.transpose(-1, -2))
        p = torch.where(keep, torch.exp2(s * np.float32(scale * log2e)
                                         - lse2[:, h, :, None]), 0.0)
        dp = mm(dof[:, h], vh.transpose(-1, -2))
        ds = p * (dp - delta[:, h, :, None]) * np.float32(scale)
        part_v[:, h] = mm(p.transpose(-1, -2), dof[:, h])
        part_k[:, h] = mm(ds.transpose(-1, -2), qf[:, h])
        dq[:, h] = mm(ds, kh)
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for h in range(H):                     # head order, a KV head's group
        dk[:, h // G] += part_k[:, h]
        dv[:, h // G] += part_v[:, h]
    back = lambda t: t.transpose(1, 2)
    return back(dq), back(dk), back(dv)


def _tf32_case(case):
    """The reference's gradients (jax.vjp of _flash_attention, float32)
    and the port's inputs of the same case."""
    B, S, KH, G, D, window = SPLIT_CASES[case]
    q, k, v, do = _inputs(B, S, KH, G, D, 6)
    pos = jnp.arange(S)
    fn = lambda q, k, v: JL._flash_attention((window, CHUNK, CHUNK), q, k,
                                             v, pos, pos)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w).reshape(B, S, -1, D) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (_port(x) for x in (q, k, v, do))
    o, lse = _port_forward(tq, tk, tv, window)
    return want, (tq, tk, tv, o, lse, tdo), window


def _tf32_errors(got, want):
    """Each gradient's largest error over the larger of its own and dV's
    largest magnitude."""
    scale = float(np.abs(want[2]).max())
    return [float(np.abs(g.numpy() - w).max())
            / max(float(np.abs(w).max()), scale)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", ["g1", "g2_window", "g16"])
def test_tf32_route_matches_reference_vjp(case):
    """The tf32 route's arithmetic (every product as three TF32 terms,
    per-query-head float32 partial dK and dV summed in head order) on
    float32 inputs against jax.vjp of the reference's _flash_attention at
    the card's float32 limit: 2^-14 of the larger of each gradient's and
    dV's largest magnitude."""
    want, args, window = _tf32_case(case)
    got = _bwd_tf32_arithmetic(*args, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
    errs = _tf32_errors(got, want)
    assert max(errs) <= F32_TOL, errs


@pytest.mark.parametrize("case", ["g1", "g16"])
def test_one_tf32_product_misses_the_float32_limit(case):
    """The same arithmetic with one TF32 product in place of three misses
    2^-14: why the kernels split every operand."""
    want, args, window = _tf32_case(case)
    got = _bwd_tf32_arithmetic(*args, window, three=False)
    assert max(_tf32_errors(got, want)) > F32_TOL


# ----------------------------------------- the card's d256 route, on the CPU

def _bwd_d256_arithmetic(q, k, v, o, lse, do, window):
    """The d256 route's arithmetic written out in torch on (B, S, h, D)
    tensors: delta = rowsum(dO o O), P = exp(S scale - lse) under the
    mask, dS = P (dP - delta) scale; bfloat16: the products of bf16
    operands exact in float32, P and dS rounded to bf16 once for their
    products; float32: each of the five products in three TF32 terms, P
    and dS in float32.  Each query head's dK and dV a float32 partial,
    summed over a KV head's G query heads in head order and rounded to
    the inputs' dtype once."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    bf16 = q.dtype == torch.bfloat16
    scale = np.float32(1.0 / np.sqrt(D))
    heads = lambda t: t.float().transpose(1, 2).contiguous()
    qf, kf, vf, of, dof = (heads(t) for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    if window:
        keep &= ~torch.ones(S, S, dtype=torch.bool).tril(-window)
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    mm = (lambda a, b: a @ b) if bf16 else _mm3
    dq = torch.empty_like(qf)
    part_k = torch.empty(B, H, S, D)
    part_v = torch.empty(B, H, S, D)
    for h in range(H):
        kh, vh = kf[:, h // G], vf[:, h // G]
        s = mm(qf[:, h], kh.transpose(-1, -2))
        p = torch.where(keep, torch.exp(s * scale - lse[:, h, :, None]),
                        0.0)
        dp = mm(dof[:, h], vh.transpose(-1, -2))
        ds = p * (dp - delta[:, h, :, None]) * scale
        part_v[:, h] = mm(rnd(p).transpose(-1, -2).contiguous(), dof[:, h])
        part_k[:, h] = mm(rnd(ds).transpose(-1, -2).contiguous(), qf[:, h])
        dq[:, h] = mm(rnd(ds), kh)
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for h in range(H):                     # head order, a KV head's group
        dk[:, h // G] += part_k[:, h]
        dv[:, h // G] += part_v[:, h]
    back = lambda t: t.transpose(1, 2).to(q.dtype)
    return back(dq), back(dk), back(dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_d256_route_matches_reference_vjp(dtype):
    """The d256 route's arithmetic at RecurrentGemma's head size (10 query
    heads over 1 KV head of 256, window 8 at S 32) against jax.vjp of
    the reference's _flash_attention (float32 on the same values) at the
    card's limit: bf16 2^-6, float32 2^-14 of the larger of each
    gradient's and dV's largest magnitude."""
    B, S, KH, G, D, window = CASES["rg_d256"]
    q, k, v, do = _inputs(B, S, KH, G, D, 8)
    if dtype == torch.bfloat16:
        bf = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())
        q, k, v, do = (bf(x) for x in (q, k, v, do))
    pos = jnp.arange(S)
    fn = lambda q, k, v: JL._flash_attention((window, CHUNK, CHUNK), q, k,
                                             v, pos, pos)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w).reshape(B, S, -1, D) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (_port(x) for x in (q, k, v, do))
    o, lse = _port_forward(tq, tk, tv, window)
    got = _bwd_d256_arithmetic(*(t.to(dtype) for t in (tq, tk, tv)),
                               o.to(dtype), lse, tdo.to(dtype), window)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
    errs = _tf32_errors([g.float() for g in got], want)
    limit = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    assert max(errs) <= limit, errs


# ------------------------------------ the card's wgmma_d256 route, on the CPU

def _bwd_wgmma_d256_arithmetic(q, k, v, o, lse, do, window):
    """The wgmma_d256 route's arithmetic written out in torch on bf16 (B,
    S, h, D) tensors, D zero-filled to 256 as TMA reads it: S^T = K Q^T
    and dP^T = V dO^T over the full D (products of bf16 values, exact in
    float32, float32 sums), P^T = 2^(S^T scale log2(e) - lse log2(e))
    under the mask and dS^T = P^T (dP^T - delta) scale, each rounded to
    bf16 once before its products; dV += P^T dO, dK += dS^T Q and dQ +=
    dS K accumulated apart for the two halves of D (128 columns each, one
    consumer warpgroup's), in float32 over the kv or query tiles of 64;
    each query head's dK and dV a float32 partial, summed over a KV head's
    G query heads in head order and rounded to bf16 once; only D columns
    kept."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    log2e = 1.4426950408889634
    scale = 1.0 / np.sqrt(D)
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 256 - D))
    heads = lambda t: pad(t).transpose(1, 2)               # (B, h, S, 256)
    qf, kf, vf, of, dof = (heads(t) for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    lse2 = lse.float() * log2e
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    if window:
        keep &= ~torch.ones(S, S, dtype=torch.bool).tril(-window)
    rnd = lambda t: t.bfloat16().float()
    tiles = [slice(t, min(t + 64, S)) for t in range(0, S, 64)]

    def acc(a, b):
        """a @ b, a (.., M, S) and b (.., S, 256): each half of b's columns
        on its own, summed over tiles of 64 rows of b in order."""
        out = torch.zeros(*a.shape[:-1], 256)
        for half in (slice(0, 128), slice(128, 256)):
            for t in tiles:
                out[..., half] += a[..., t] @ b[..., t, half]
        return out

    dq = torch.empty_like(qf)
    part_k = torch.empty(B, H, S, 256)
    part_v = torch.empty(B, H, S, 256)
    for h in range(H):
        kh, vh = kf[:, h // G], vf[:, h // G]
        st = kh @ qf[:, h].transpose(-1, -2)           # (B, S keys, S q)
        pt = torch.where(keep.T, torch.exp2(st * (scale * log2e)
                                            - lse2[:, h, None, :]), 0.0)
        dpt = vh @ dof[:, h].transpose(-1, -2)
        dst = pt * (dpt - delta[:, h, None, :]) * scale
        part_v[:, h] = acc(rnd(pt), dof[:, h])
        part_k[:, h] = acc(rnd(dst), qf[:, h])
        dq[:, h] = acc(rnd(dst).transpose(-1, -2), kh)
    dk = torch.zeros(B, Hkv, S, 256)
    dv = torch.zeros(B, Hkv, S, 256)
    for h in range(H):                     # head order, a KV head's group
        dk[:, h // G] += part_k[:, h]
        dv[:, h // G] += part_v[:, h]
    back = lambda t: t[..., :D].transpose(1, 2).bfloat16()
    return back(dq), back(dk), back(dv)


# (B, S, KH, G, D, window): RecurrentGemma's local attention (rg_d256),
# and D 192 (TMA's zero fill past D in the last column block) at a ragged
# S (the reference then takes S as its one block)
WGMMA_D256_CASES = {"rg_d256": CASES["rg_d256"],
                    "d192_ragged": (1, 37, 2, 2, 192, 20)}


@pytest.mark.parametrize("case", sorted(WGMMA_D256_CASES))
def test_wgmma_d256_route_matches_reference_vjp(case):
    """The wgmma_d256 route's arithmetic on bf16 inputs against jax.vjp of
    the reference's _flash_attention (float32 on the same bf16 values) at
    the card's bf16 limit: 2^-6 of the larger of each gradient's and dV's
    largest magnitude."""
    B, S, KH, G, D, window = WGMMA_D256_CASES[case]
    bf = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())
    q, k, v, do = (bf(x) for x in _inputs(B, S, KH, G, D, 9))
    pos = jnp.arange(S)
    chunk = CHUNK if S % CHUNK == 0 else S     # the reference's blocks
    fn = lambda q, k, v: JL._flash_attention((window, chunk, chunk), q, k,
                                             v, pos, pos)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w).reshape(B, S, -1, D) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (_port(x).bfloat16() for x in (q, k, v, do))
    o, lse = _port_forward(tq.float(), tk.float(), tv.float(), window)
    got = _bwd_wgmma_d256_arithmetic(tq, tk, tv, o.bfloat16(), lse, tdo,
                                     window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
    errs = _tf32_errors([g.float() for g in got], want)
    assert max(errs) <= BF16_TOL, errs


def _view(shape, dtype, offset=0, transpose=False):
    """A CPU tensor of ``shape`` whose data starts ``offset`` elements
    into its storage (``transpose``: a (B, H, S, D) buffer viewed as (B,
    S, H, D), not contiguous)."""
    if transpose:
        B, S, H, D = shape
        return torch.zeros(B, H, S, D, dtype=dtype).transpose(1, 2)
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (dtype, D, offset of q in elements, q transposed) -> route
ROUTE_CASES = [(torch.bfloat16, 128, 0, False, "wgmma"),
               (torch.bfloat16, 64, 0, False, "wgmma"),
               (torch.bfloat16, 8, 0, False, "wgmma"),
               (torch.bfloat16, 40, 0, False, "wgmma"),
               (torch.bfloat16, 120, 8, False, "wgmma"),
               (torch.bfloat16, 128, 4, False, "mma"),
               (torch.bfloat16, 128, 0, True, "mma"),
               (torch.bfloat16, 100, 0, False, "mma"),
               (torch.bfloat16, 100, 0, True, "mma"),
               (torch.bfloat16, 36, 0, False, "mma"),
               (torch.float32, 128, 0, False, "tf32"),
               (torch.float32, 64, 0, False, "tf32"),
               (torch.float32, 30, 0, False, "tf32"),
               (torch.float32, 128, 1, False, "tf32"),
               (torch.float32, 128, 0, True, "tf32"),
               (torch.bfloat16, 256, 0, False, "wgmma_d256"),
               (torch.bfloat16, 136, 0, False, "wgmma_d256"),
               (torch.bfloat16, 160, 4, False, "d256"),
               (torch.bfloat16, 132, 0, False, "d256"),
               (torch.bfloat16, 200, 0, True, "d256"),
               (torch.float32, 256, 0, False, "d256"),
               (torch.float32, 136, 1, False, "d256")]


@pytest.mark.parametrize("dtype,D,offset,transpose,route", ROUTE_CASES)
def test_bwd_route_rule(dtype, D, offset, transpose, route):
    """bwd_route is a function of dtype, D, strides and alignment alone:
    bf16 with D % 8 == 0 and every tensor contiguous on a 16-byte aligned
    base takes the wgmma kernels, at D above 128 the wgmma_d256 ones; the
    rest of bf16 the mma.sync ones, at D above 128 those of the d256
    route; float32 the tf32 kernels whatever its alignment, at D above
    128 the d256 ones; a call launches 4 kernels on every route but mma
    with H_kv < H, else 3.
    (On the card ``flash_attention_bwd`` refuses the transposed views:
    the kernels read fixed strides.)"""
    from repro_torch.kernels.flash_attn.ops import bwd_launches, bwd_route
    B, S, H, Hkv = 1, 16, 4, 2
    q = _view((B, S, H, D), dtype, offset, transpose)
    k, v = (_view((B, S, Hkv, D), dtype) for _ in range(2))
    o, do = (_view((B, S, H, D), dtype) for _ in range(2))
    assert bwd_route(q, k, v, o, do) == route
    # the sum pass: every route but mma splits the group
    split = route != "mma"
    assert bwd_launches(q, k, v, o, do) == (4 if split else 3)
    assert bwd_launches(q, q, q, o, do) == 3       # H_kv == H: no sum pass
