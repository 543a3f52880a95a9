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
CASES = {"mha_d128": (2, 64, 2, 1, 128, 0), "gqa_d64": (1, 96, 2, 3, 64, 0),
         "window_d64": (2, 96, 3, 2, 64, 40),
         "window_d128": (1, 128, 1, 4, 128, 17)}


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
