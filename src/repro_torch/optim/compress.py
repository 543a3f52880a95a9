"""int8 gradient compression with error feedback (the reference's
``optim/compress.py``): one float32 scale a tensor, the quantisation
residual fed back into the next step.  The reference's
``compressed_psum_mean`` (an all-gather over a mesh inside ``shard_map``)
is not ported: one card has no mesh (ROADMAP)."""
from __future__ import annotations

import torch


def quantize_tensor(g, bits: int = 8):
    """(q int8, scale float32 0-d): round(g / scale) clipped to the
    signed range, scale = max|g| / (2^(bits-1) - 1), at least 1e-12 /
    that."""
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_tensor(q, scale):
    return q.to(torch.float32) * scale


def ef_compress(grads: dict, ef_state: dict | None):
    """Error feedback, then quantise each leaf of ``grads`` ({name:
    tensor}).  Returns ({name: q}, {name: scale}, new ef_state)."""
    if ef_state is None:
        ef_state = {k: torch.zeros_like(g, dtype=torch.float32)
                    for k, g in grads.items()}
    corrected = {k: g.float() + ef_state[k] for k, g in grads.items()}
    qs = {k: quantize_tensor(c) for k, c in corrected.items()}
    q_tree = {k: t[0] for k, t in qs.items()}
    s_tree = {k: t[1] for k, t in qs.items()}
    new_ef = {k: c - dequantize_tensor(q_tree[k], s_tree[k])
              for k, c in corrected.items()}
    return q_tree, s_tree, new_ef
