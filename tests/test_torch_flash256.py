"""Flash attention with K and V at their own head count, and the float32
head_dim-256 kernel's 3xTF32 arithmetic, on the CPU.

``flash_attention_kernel`` takes K and V as (B, S, H_kv, D) with
H % H_kv == 0; query head h meets KV head h // (H / H_kv).  The kernels
read the KV head in place; the plain version (CPU tensors) expands K and
V first, so the two forms are the same call here.  ``attention_prefill``
hands the model's K and V over unexpanded: it is held against the
reference's model attention (``repro.models.layers.attention``) at
G = 1, 2 and 5.

``flash_attn_tf32_d256_kernel`` (``csrc/flash_attn.cu``) is written out
in torch as the card runs it: TF32 rounding of the float32 bit pattern
(round to nearest, ties away), S = Q_hi [K_hi; K_lo] + Q_lo [K_hi; K_lo]
summed over its two 32-column halves (four terms), O += P_hi V_hi + P_hi
V_lo + P_lo V_hi, the online softmax in float32 over 64-row query tiles
and 32-row kv tiles from the band's first tile, m from -1e30 under a
window.  On a RecurrentGemma-like input it stays within the float32
tolerance (atol 2e-5, rtol 1e-4) of attention in float64: the budget the
card's kernel is held to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention_kernel
from repro_torch.models import layers as L

TOL = dict(atol=2e-5, rtol=1e-4)     # chip_smoke.py's float32 ATTN_TOL


def _qkv(B, S, H, Hkv, D, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D), np.float32))
            for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,window", [(4, 2, 0), (6, 2, 5), (10, 1, 7),
                                          (3, 1, 0)])
def test_kv_heads_equal_the_expanded_call(h, hkv, window, dtype):
    q, k, v = _qkv(2, 19, h, hkv, 16, h + window, dtype)
    G = h // hkv
    got = flash_attention_kernel(q, k, v, window=window)
    want = flash_attention_kernel(q, k.repeat_interleave(G, dim=2),
                                  v.repeat_interleave(G, dim=2),
                                  window=window)
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv_shape", [(1, 9, 3, 16), (1, 9, 0, 16),
                                      (1, 8, 2, 16), (1, 9, 2, 8),
                                      (2, 9, 2, 16)])
def test_kv_heads_that_do_not_group_are_refused(kv_shape):
    """H % H_kv != 0, no KV head, and K and V off q's batch, length or
    head size raise."""
    q = torch.zeros(1, 9, 4, 16)
    k = torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k.clone())


def test_k_and_v_must_share_a_shape():
    q = torch.zeros(1, 9, 4, 16)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, torch.zeros(1, 9, 2, 16),
                               torch.zeros(1, 9, 4, 16))


@pytest.mark.parametrize("G", [1, 2, 5])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_prefill_matches_the_reference_attention(G, window):
    """The model's attention, q (B, S, KH, G, D) against K and V at KH
    heads, causal and banded: the port's prefill path (the flash wrapper,
    K and V unexpanded) against the reference's model attention on the
    same float32 inputs."""
    B, S, KH, D = 2, 24, 2, 32
    rng = np.random.default_rng(10 * G + window)
    q = rng.standard_normal((B, S, KH, G, D), np.float32)
    k, v = (rng.standard_normal((B, S, KH, D), np.float32) for _ in range(2))
    pos = jnp.arange(S)
    want = np.array(JL.attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), pos, pos, window=window))
    got = L.attention_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window)
    assert got.shape == (B, S, KH, G, D)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


# ------------------------------------------------------- 3xTF32 at D 256

FQ, FK = 64, 32                      # the kernel's query and kv tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel's to_tf32: half the 13 dropped
    mantissa bits' range added to the magnitude, then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def flash_tf32_d256(q, k, v, window):
    """(S, D) float32 q, k, v of one head -> the kernel's output: causal,
    ``window`` > 0 a band, tiles and numerics as in the module doc."""
    S, D = q.shape
    log2e = np.float32(1.4426950408889634)
    scale_log2 = np.float32(1.0 / np.sqrt(D)) * log2e
    rows = torch.arange(S)
    out = torch.empty_like(q)
    for q0 in range(0, S, FQ):
        qt = q[q0:q0 + FQ]
        qh, ql = split(qt)
        r = rows[q0:q0 + FQ, None]
        j0 = max(0, q0 - window + 1) // FK if window else 0
        j1 = min((S + FK - 1) // FK, (q0 + FQ - 1) // FK + 1)
        m = torch.full((len(qt), 1), -1e30 if window else float("-inf"))
        l = torch.zeros(len(qt), 1)
        acc = torch.zeros(len(qt), D)
        for j in range(j0, j1):
            k0 = j * FK
            kt, vt = k[k0:k0 + FK], v[k0:k0 + FK]
            kh, kl = split(kt)
            s = (qh @ kh.T + ql @ kh.T) + (qh @ kl.T + ql @ kl.T)
            c = rows[None, k0:k0 + FK]
            masked = (c > r) | ((c <= r - window) if window else False)
            s = s.masked_fill(masked, float("-inf"))
            m_new = torch.maximum(m, s.amax(1, keepdim=True) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new)
            l = l * corr + p.sum(1, keepdim=True)
            (ph, pl), (vh, vl) = split(p), split(vt)
            acc = acc * corr + (ph @ vh + ph @ vl + pl @ vh)
            m = m_new
        out[q0:q0 + FQ] = acc / l.clamp_min(1e-30)
    return out


def attention_f64(q, k, v, window):
    S, D = q.shape
    s = (q.double() @ k.double().T) / np.sqrt(D)
    i = torch.arange(S)
    keep = (i[None, :] <= i[:, None])
    if window:
        keep &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v.double()


def test_tf32_d256_split_stays_in_the_float32_tolerance():
    """RecurrentGemma-like: 2 heads of 256 over 1 KV head, window 64, S
    300 (across the 64-row query tiles and 32-row kv tiles): the kernel's
    3xTF32 arithmetic against float64 attention within atol 2e-5, rtol
    1e-4, with room to spare; one TF32 product a matrix product misses."""
    q, k, v = _qkv(1, 300, 2, 1, 256, 256)
    for h in range(2):
        want = attention_f64(q[0, :, h], k[0, :, 0], v[0, :, 0], 64)
        got = flash_tf32_d256(q[0, :, h], k[0, :, 0], v[0, :, 0], 64)
        err = (got.double() - want).abs()
        limit = TOL["atol"] + TOL["rtol"] * want.abs()
        assert (err / limit).max() < 0.5, float((err / limit).max())
        one = torch.softmax((tf32(q[0, :, h]) @ tf32(k[0, :, 0]).T / 16.0)
                            .masked_fill(~_band(300, 64), float("-inf")),
                            -1) @ tf32(v[0, :, 0])
        assert ((one.double() - want).abs() > limit).any()


def _band(S, window):
    i = torch.arange(S)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
