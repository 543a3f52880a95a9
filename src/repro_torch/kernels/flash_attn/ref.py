"""Plain PyTorch version of the fused flash-attention kernel: softmax
attention written out, with the (S, S) scores in memory.

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


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q, k, v: (BH, S, D) -> (BH, S, D) in q's dtype; with ``window``,
    query i sees keys j with i - window < j (and j <= i if causal)."""
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
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
