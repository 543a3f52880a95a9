"""Building blocks of the attention-based transformers.

Parameters are declared as ``PSpec`` trees (shape + init style), as in the
reference; ``init_params`` turns a tree into tensors drawn from an explicit
``torch.Generator``, one leaf at a time.  The functions below read a
parameter tree by key (``p["wq"]``), so they take a nested dict of tensors
or the ``nn.Module`` of ``models.transformer``, which is indexed the same
way.

All matmuls run in the activation dtype (bf16 by default) with float32
accumulation; norms, softmax and rope run in float32.  Every
full-sequence attention, a prefill's and a training forward's alike, is
``kernels.flash_attention_kernel`` (causal, with the sliding window of a
``"local"`` layer): the hand-written kernel on a CUDA tensor, its plain
version on a CPU tensor; under grad its backward is
``kernels.flash_attention_bwd``.  Decode attention over the cache is
``attention_dense``, as in the reference; a local layer's cache is a ring
of ``window_size`` slots once the sequence can outgrow it.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention_kernel


@dataclass(frozen=True)
class PSpec:
    shape: tuple
    init: str = "normal"      # "normal" | "out" | "zeros" | "ones" | "embed"
    dtype: str = "float32"


def init_leaf(spec: PSpec, generator: torch.Generator,
              depth_scale: float = 1.0, *, dtype=None, device=None):
    """One parameter: zeros, ones, or a float32 standard normal from
    ``generator`` scaled by 0.02 (``"out"``: 0.02 x ``depth_scale``;
    ``"embed"``: unscaled), cast to ``dtype`` (default: the spec's).  The
    reference's scheme; not its random stream."""
    dt = dtype or getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if spec.init != "embed":
        x.mul_(0.02 * depth_scale if spec.init == "out" else 0.02)
    return x.to(dt)


def init_params(spec_tree, generator: torch.Generator,
                depth_scale: float = 1.0, *, dtype=None, device=None):
    """The tensors of a nested dict/list tree of ``PSpec``, drawn leaf by
    leaf in the tree's order."""
    def walk(node):
        if isinstance(node, PSpec):
            return init_leaf(node, generator, depth_scale, dtype=dtype,
                             device=device)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        raise TypeError(type(node))
    return walk(spec_tree)


# ---------------------------------------------------------------------------
# Norms (float32 math)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(x.dtype)


def rmsnorm_bf16(x, scale, eps=1e-6):
    """Variance in float32; multiplies in x.dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * (1.0 + scale.float()).to(x.dtype)


def layernorm_bf16(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    r = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu.to(x.dtype)) * r
    return y * (1.0 + scale.float()).to(x.dtype) + bias.to(x.dtype)


def norm_pspecs(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": PSpec((d,), "zeros"), "bias": PSpec((d,), "zeros")}
    return {"scale": PSpec((d,), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        if cfg.norm_bf16_mul:
            return layernorm_bf16(x, p["scale"], p["bias"], cfg.norm_eps)
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.norm_bf16_mul:
        return rmsnorm_bf16(x, p["scale"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, rope_pct: float, base: float, device=None):
    """(rotated dims, float32 inverse frequencies): a partial rotary
    fraction rotates the first ``rot`` dims only.  Cached per device: a
    copy from the host at every call would wait for the device each
    layer."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    inv = 1.0 / (base ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return rot, torch.as_tensor(inv, dtype=torch.float32, device=device)


def apply_rope(x, pos, *, base=10_000.0, pct=1.0):
    """x: (..., S, H, D); pos: broadcastable to (..., S).  Half-split
    layout: dims [0, rot/2) pair with [rot/2, rot); dims past ``rot`` pass
    through."""
    D = x.shape[-1]
    rot, inv = rope_freqs(D, pct, base, device=x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = pos[..., None].float() * inv                 # (..., S, rot/2)
    sin = torch.sin(ang)[..., None, :]                 # (..., S, 1, rot/2)
    cos = torch.cos(ang)[..., None, :]
    x1f, x2f = xr[..., :rot // 2].float(), xr[..., rot // 2:].float()
    y1 = x1f * cos - x2f * sin
    y2 = x2f * cos + x1f * sin
    out = torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < D else out


@functools.lru_cache(maxsize=16)
def _sinusoidal_freq(d_model: int, device=None):
    half = d_model // 2
    freq = np.exp(-np.log(10_000.0) * np.arange(half) / half)
    return torch.as_tensor(freq, dtype=torch.float32, device=device)


def sinusoidal_emb(pos, d_model: int, dtype=torch.float32):
    """pos: (...,) -> (..., d_model): [sin | cos] of pos times the
    frequencies 10000^(-i / (d_model / 2)), in float32, cast to
    ``dtype``."""
    ang = pos[..., None].float() * _sinusoidal_freq(d_model, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

_NEG = -1e30


def _mask(qpos, kpos, window=0):
    """qpos: (Q,), kpos: (K,) -> bool (Q, K).  Causal, optional sliding
    window (key positions within ``window`` behind the query)."""
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def attention_dense(q, k, v, qpos, kpos, *, window=0, kv_len=None):
    """q: (B,Sq,KH,G,D)  k,v: (B,Sk,KH,D).  Scores and softmax in float32,
    the probabilities cast to v's dtype for the PV product, as in the
    reference (the decode path over the cache)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    m = _mask(qpos, kpos, window)
    if kv_len is not None:                       # decode: valid cache prefix
        m &= ((kpos < kv_len) & (kpos >= 0))[None, :]
    s = torch.where(m[None, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def attention_prefill(q, k, v, window=0):
    """Causal full-sequence attention through the flash kernel, banded to
    ``window`` keys when it is set; differentiable in q, k and v (the
    reshapes below carry the gradients to the kernel's backward).

    q: (B,S,KH,G,D), k,v: (B,S,KH,D) -> (B,S,KH,G,D).  Query head
    ``h = kh*G + g`` meets KV head ``kh`` (the reference's
    ``bqhgd,bkhd`` einsum), which is the kernel's own grouping: K and V
    go to it at their KH heads, with no copy to every query head.  The
    bf16 kernel rounds the probabilities to bf16 for the PV product, as
    the reference does; its plain version (CPU tensors) keeps them in
    float32."""
    B, S, KH, G, D = q.shape
    qh = q.reshape(B, S, KH * G, D)
    o = flash_attention_kernel(qh.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=window)
    return o.reshape(B, S, KH, G, D)


def attn_pspecs(cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": PSpec((d, qd)), "wk": PSpec((d, kvd)), "wv": PSpec((d, kvd)),
         "wo": PSpec((qd, d), "out")}
    if cfg.qkv_bias:
        p["bq"] = PSpec((qd,), "zeros")
        p["bk"] = PSpec((kvd,), "zeros")
        p["bv"] = PSpec((kvd,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = PSpec((cfg.head_dim,), "zeros")
        p["k_norm"] = PSpec((cfg.head_dim,), "zeros")
    return p


def rope_base(cfg, kind):
    """Global layers (``"attn"``) take ``rope_base_global`` where the
    config sets one (Gemma-3: 1e6); local layers keep ``rope_base``."""
    if kind == "attn" and cfg.rope_base_global:
        return cfg.rope_base_global
    return cfg.rope_base


def attn_qkv(cfg, p, x, qpos, kind="attn"):
    """Projections, qk-norm and rope: q (B,S,KH,G,D), k and v (B,S,KH,D)."""
    B, S, _ = x.shape
    KH, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    base = rope_base(cfg, kind)
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, KH, D)
    v = v.reshape(B, S, KH, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, qpos, base=base, pct=cfg.rope_pct)
        k = apply_rope(k, qpos, base=base, pct=cfg.rope_pct)
    return q.reshape(B, S, KH, H // KH, D), k, v


def attn_out(cfg, p, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"].to(o.dtype)


def ring_slot(kv_len: int, window: int) -> int:
    """The ring cache's slot for position ``kv_len``."""
    return kv_len % window


@functools.lru_cache(maxsize=64)
def cached_arange(n: int, device=None):
    """``torch.arange(n)`` on ``device``, made once: a decode step reads
    it in every layer."""
    return torch.arange(n, device=device)


def ring_positions(kv_len: int, window: int, device=None):
    """Absolute position held in each ring slot once position ``kv_len``
    is written: slot s holds kv_len - ((kv_len mod window - s) mod
    window); slots not written yet come out negative."""
    slots = cached_arange(window, device)
    return kv_len - torch.remainder(kv_len % window - slots, window)


def attn_apply(cfg, p, x, qpos, *, kind="attn", cache=None, kv_len=None):
    """Attention of a block; ``kind`` ``"local"`` bands it to
    ``cfg.window_size`` keys.  x: (B,S,d).  ``cache`` None: causal
    full-sequence attention (the flash kernel); returns (out, {"k", "v"})
    with this sequence's k and v, from which a prefill builds its cache.
    Else a decode step: k and v are written into ``cache`` in place, at
    slot ``kv_len`` (a host int; clamped to the buffer as
    ``dynamic_update_slice`` clamps), or, in a local layer's ring of
    ``window`` slots, at ``ring_slot(kv_len, window)``; q attends over
    the valid positions; returns (out, cache)."""
    window = cfg.window_size if kind == "local" else 0
    q, k, v = attn_qkv(cfg, p, x, qpos, kind)
    if cache is None:
        o = attention_prefill(q, k, v, window)
        return attn_out(cfg, p, o), {"k": k, "v": v}
    ck, cv = cache["k"], cache["v"]                          # (B,Sc,KH,D)
    S, Sc = x.shape[1], ck.shape[1]
    kv_len = int(kv_len)
    ring = bool(window) and Sc == window
    slot = ring_slot(kv_len, window) if ring else kv_len
    slot = min(max(slot, 0), Sc - S)
    ck[:, slot:slot + S] = k.to(ck.dtype)
    cv[:, slot:slot + S] = v.to(cv.dtype)
    kpos = (ring_positions(kv_len, window, x.device) if ring
            else cached_arange(Sc, x.device))
    o = attention_dense(q, ck, cv, qpos, kpos, window=window,
                        kv_len=kv_len + 1)
    return attn_out(cfg, p, o), cache


def cache_len(cfg, max_seq: int, kind: str) -> int:
    """A layer's cache length: ``min(max_seq, window_size)`` for a local
    layer, else ``max_seq``."""
    if kind == "local" and cfg.window_size:
        return min(max_seq, cfg.window_size)
    return max_seq


def init_attn_cache(cfg, batch, max_seq, kind="attn", dtype=torch.bfloat16,
                    device=None):
    shape = (batch, cache_len(cfg, max_seq, kind), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_pspecs(cfg):
    """The MLP's leaves; ``rwkv_channel_mix`` is RWKV-6's channel mixing
    (``models.rwkv6.channel_mix_apply``)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": PSpec((d, f)), "wg": PSpec((d, f)),
                "wo": PSpec((f, d), "out")}
    if cfg.mlp == "rwkv_channel_mix":
        return {"wk": PSpec((d, f)), "wv": PSpec((f, d), "out"),
                "wr": PSpec((d, d)), "mix_k": PSpec((d,), "zeros"),
                "mix_r": PSpec((d,), "zeros")}
    return {"wi": PSpec((d, f)), "wo": PSpec((f, d), "out")}


def mlp_apply(cfg, p, x):
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["wg"].to(dt)
        g = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * (x @ p["wi"].to(dt))
    elif cfg.mlp == "relu2":
        h = torch.relu(x @ p["wi"].to(dt)).square()
    else:  # gelu
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_pspecs(cfg):
    p = {"table": PSpec((cfg.vocab_size, cfg.d_model), "embed")}
    if not cfg.tie_embeddings:
        if cfg.num_codebooks > 1:
            p["head"] = PSpec((cfg.num_codebooks, cfg.d_model,
                               cfg.vocab_size))
        else:
            p["head"] = PSpec((cfg.d_model, cfg.vocab_size))
    return p


def embed_lookup(cfg, p, tokens, dtype=torch.bfloat16):
    """Rows of the table cast to ``dtype`` (bf16 by default, whatever the
    table's dtype, as in the reference)."""
    x = p["table"][tokens].to(dtype)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to ``dtype`` first, as the reference's
        # jnp.asarray(.., dtype); a host scalar, so no copy to the device
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype).item()
    return x


def head_matrix(cfg, p):
    """(d, V) or (K, d, V) head weights."""
    if cfg.tie_embeddings:
        return p["table"].T
    return p["head"]
