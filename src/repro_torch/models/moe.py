"""Mixture-of-Experts block (the reference's ``models/moe.py``).

A token's top-k expert assignment is the rate-based twin of SpiNNaker2's
multicast routing: the router picks destinations, the activation vector
is the payload.  Two implementations, as in the reference:

* ``moe_apply_dense`` — the oracle: every expert sees every token, masked
  combine, no drops.  O(T E f); for tests and the decode gate.
* ``moe_apply``       — the served path: capacity dispatch.  Each (token,
  k) assignment is ranked within its expert in flat (token, k) order;
  those ranked past the capacity ``C = max(ceil(cf T K / E), 1)`` (on the
  host, from the call's own T, so decode and prefill drop differently)
  go to a trash row.  Tokens are scattered into (E, C, d) buffers, the
  expert MLPs run as grouped products, and each token's K outputs are
  added back in the order k = 0 .. K-1 in the activation dtype.

The router's logits accumulate in float64 and round once to float32, so
the card and the CPU hold the same float32 numbers (the reference's
float32 product is within float32 rounding of them); top-k is a stable
descending sort of the float32 probabilities, so ties go to the lower
expert index, as ``lax.top_k``'s do.  The reference's expert-parallel
``moe_apply_sharded`` (``shard_map`` over a mesh) is not ported: one card
has no mesh (ROADMAP).

Aux losses: the Switch load-balance loss and the router z-loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import PSpec, cached_arange


def moe_pspecs(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": PSpec((d, E))}
    if cfg.mlp in ("swiglu", "geglu"):
        p.update({"wi": PSpec((E, d, f)), "wg": PSpec((E, d, f)),
                  "wo": PSpec((E, f, d), "out")})
    else:
        p.update({"wi": PSpec((E, d, f)), "wo": PSpec((E, f, d), "out")})
    return p


def _router(cfg, p, x):
    """x: (T, d) -> (probs (T, E) float32, logits float32)."""
    logits = (x.double() @ p["router"].double()).float()
    return torch.softmax(logits, dim=-1), logits


def _top_k(probs, k: int):
    """The k largest probabilities of each row and their experts, ties to
    the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gates(cfg, probs):
    """Top-k gate values, renormalised to sum to 1 a token, and their
    experts: (T, K) float32, (T, K) int64."""
    vals, idx = _top_k(probs, cfg.experts_per_token)
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return vals, idx


def _expert_ffn(cfg, p, xe):
    """xe: (E, C, d) -> (E, C, d); grouped products in xe's dtype."""
    dt = xe.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = torch.bmm(xe, p["wg"].to(dt))
        g = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * torch.bmm(xe, p["wi"].to(dt))
    elif cfg.mlp == "relu2":
        h = torch.relu(torch.bmm(xe, p["wi"].to(dt))).square()
    else:
        h = F.gelu(torch.bmm(xe, p["wi"].to(dt)), approximate="tanh")
    return torch.bmm(h, p["wo"].to(dt))


def aux_losses(probs, sel_onehot):
    """Switch load-balance loss.  probs: (T, E) float32; sel_onehot: (T, E)
    float32 (summed over k)."""
    E = probs.shape[-1]
    return E * (sel_onehot.mean(0) * probs.mean(0)).sum()


def _one_hot(idx, n: int):
    """(..., n) bool indicator of ``idx``: ``F.one_hot`` without its check
    of the indices' range, which reads them back to the host."""
    return idx[..., None] == cached_arange(n, idx.device)


def _aux(probs, logits, gate_idx):
    sel = _one_hot(gate_idx, probs.shape[-1]).float().sum(1)
    return {"lb_loss": aux_losses(probs, sel),
            "z_loss": torch.logsumexp(logits, dim=-1).square().mean()}


def capacity(cfg, tokens: int, capacity_factor=None) -> int:
    """Slots an expert, from the call's own token count (host)."""
    cf = capacity_factor or cfg.capacity_factor
    K, E = cfg.experts_per_token, cfg.num_experts
    return max(int(np.ceil(cf * tokens * K / E)), 1)


def dispatch(cfg, p, xt, *, capacity_factor=None) -> dict:
    """The routing of ``xt`` (T, d): probabilities and logits (T, E),
    gate values and experts (T, K), and for each flat (token, k)
    assignment its rank within its expert (``rank``), whether it fits
    (``keep``: rank < C) and its row of the (E C + 1, d) buffer (``dst``;
    E C, the trash row, for the dropped), with ``C``."""
    E = cfg.num_experts
    C = capacity(cfg, xt.shape[0], capacity_factor)
    probs, logits = _router(cfg, p, xt)
    gate_vals, gate_idx = _gates(cfg, probs)
    flat_e = gate_idx.reshape(-1)                            # (T K,)
    # rank of each assignment among same-expert ones, in flat order: a
    # running count along each expert's row of the (E, T K) indicator
    # (the scan runs along the contiguous axis)
    hits = cached_arange(E, xt.device)[:, None] == flat_e[None, :]
    rank = hits.cumsum(1).gather(0, flat_e[None, :])[0] - 1
    keep = rank < C
    dst = torch.where(keep, flat_e * C + rank, E * C)
    return dict(probs=probs, logits=logits, gate_vals=gate_vals,
                gate_idx=gate_idx, rank=rank, keep=keep, dst=dst, C=C)


def moe_apply(cfg, p, x, *, capacity_factor=None, aux=True):
    """Top-k dispatch with capacity.  x: (B, S, d) -> (out, {"lb_loss",
    "z_loss"}), the losses float32 scalars (None with ``aux=False``)."""
    B, S, d = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(T, d)
    r = dispatch(cfg, p, xt, capacity_factor=capacity_factor)
    C, dst = r["C"], r["dst"]
    # scatter: only the trash row takes more than one source, so the
    # adds into zeros are exact
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dst, xt.repeat_interleave(K, dim=0))
    ye = _expert_ffn(cfg, p, buf[:E * C].view(E, C, d))
    # combine: each token's K outputs, weighted, added in order k = 0..K-1
    yt = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    w = (r["gate_vals"] * r["keep"].view(T, K)).to(x.dtype)
    contrib = yt[dst].view(T, K, d) * w[..., None]
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    losses = (_aux(r["probs"], r["logits"], r["gate_idx"]) if aux
              else {"lb_loss": None, "z_loss": None})
    return out.reshape(B, S, d), losses


def moe_apply_dense(cfg, p, x, *, aux=True):
    """Oracle: every expert on every token, weighted combine in float32,
    no drops."""
    B, S, d = x.shape
    T, E = B * S, cfg.num_experts
    xt = x.reshape(T, d)
    probs, logits = _router(cfg, p, xt)
    gate_vals, gate_idx = _gates(cfg, probs)
    w = (_one_hot(gate_idx, E).float() * gate_vals[..., None]).sum(1)
    ye = _expert_ffn(cfg, p, xt.expand(E, T, d))
    out = torch.einsum("etd,te->td", ye.float(), w).to(x.dtype)
    losses = (_aux(probs, logits, gate_idx) if aux
              else {"lb_loss": None, "z_loss": None})
    return out.reshape(B, S, d), losses
