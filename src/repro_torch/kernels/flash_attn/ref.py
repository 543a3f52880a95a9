"""Plain PyTorch versions of the fused flash-attention kernels: softmax
attention written out, with the (S, S) scores in memory, and its
backward, the reference model attention's recompute-from-lse backward
(``_flash_bwd``) written out.

Scores and products are float32 (on the card PyTorch's float32 matmul
runs in full float32 unless ``torch.backends.cuda.matmul.allow_tf32`` is
set; callers that hold the kernel against this leave it unset).  Masked
scores are -1e30, as in the reference; the result is cast to q's dtype.
``window`` > 0 also masks the keys at or past ``window`` positions behind
each query (the reference's model attention's sliding window,
``_mask(qpos, kpos, window)``).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def keep_mask(S: int, causal: bool, window: int, device=None):
    """(S, S) bool: query i sees key j (j <= i when causal; j > i - window
    when ``window`` > 0)."""
    i = torch.arange(S, device=device)
    keep = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    return keep


def flash_attention_ref(q, k, v, *, causal=True, window=0,
                        return_lse=False):
    """q, k, v: (BH, S, D) -> (BH, S, D) in q's dtype; with ``window``,
    query i sees keys j with i - window < j (and j <= i if causal).  With
    ``return_lse`` also the float32 log-sum-exp of each row's scaled,
    masked scores, (BH, S), natural log (the backward's input)."""
    S = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        s.masked_fill_(above, NEG)
    if window:
        behind = torch.ones(S, S, dtype=torch.bool,
                            device=q.device).tril(-window)
        s.masked_fill_(behind, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0):
    """The backward of ``flash_attention_kernel`` on its layout: q, o, do
    (B, S, H, D), k, v (B, S, H_kv, D), lse (B, H, S) float32 ->
    dq, dk, dv in the inputs' dtypes, float32 inside.  The reference's
    ``_flash_bwd``: delta = rowsum(dO o O), P = exp(S scale - lse) under
    the mask, dV = P^T dO, dS = P o (dO V^T - delta) scale, dQ = dS K,
    dK = dS^T Q; with H_kv < H, dK and dV summed over each KV head's G
    query heads."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    heads = lambda t: t.float().transpose(1, 2)            # (B, h, S, D)
    qf, of, dof = heads(q), heads(o), heads(do)
    kf = heads(k).repeat_interleave(G, dim=1)
    vf = heads(v).repeat_interleave(G, dim=1)
    delta = (dof * of).sum(-1)                             # (B, H, S)
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(keep_mask(S, causal, window, q.device),
                    torch.exp(s - lse.float()[..., None]), 0.0)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    group = lambda t: t.reshape(B, Hkv, G, S, D).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype), group(dk).to(k.dtype),
            group(dv).to(v.dtype))
