#!/usr/bin/env python3
"""Three float32 forms of WKV-6's log-decay gradient dlw against float64,
on the CPU:

    python3 scripts/wkv6_dlw_forms.py [--seq 4096] [--chunk 64]

direct    dlw_t = w_t o sum_v S_{t-1} o dS_t, from the states themselves
          (the form of ``wkv6_bwd_ref`` and of the walk,
          ``wkv6_bwd_kernel``);
identity  dlw_t = sum_{s>t} r_s o dr~_s + sum_v S_T o dS_T
                  - sum_{s>=t} k_s o dk~_s,
          two running sums over the sequence (dr~ = S_{t-1} dy, dk~ =
          dS_t v; nothing rebuilt);
chunk     the identity restarted at every chunk of ``--chunk`` positions
          (the form of the chunked route, ``wkv6_bwd_chunk_kernel``):
          dlw_t = sum_{t<s<=e} r_s o dr~_s + sum_v S_e o dS_e
                  - sum_{t<=s<=e} k_s o dk~_s, e the chunk's last
          position, the sums walked up the chunk.
Inputs from a seed: r, k, v, dy standard normal, u and state0 too, log
decays -exp(U(lo, hi)) over the reference tests' three ranges, the
final state's cotangent zero (a training step) or standard normal.
Prints, for each, the largest error of each form over max |dlw| (the
gradient tests' measure); the truth is the direct form in float64.
Both forms are written here for any dtype (the port's plain version
widens its inputs to float32).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

DECAYS = {"mixed": (-6.0, 2.0), "strong": (-8.0, 3.0), "weak": (-10.0, -5.0)}


def states(k, v, w, s0):
    """S_{t-1} of every position, (B, S, H, D, D), and S_T."""
    state, prev = s0, []
    for t in range(k.shape[1]):
        prev.append(state)
        state = state * w[:, t, ..., None] + torch.einsum(
            "bhk,bhv->bhkv", k[:, t], v[:, t])
    return torch.stack(prev, 1), state


def dlw_direct(r, k, v, lw, u, s0, dy, ds):
    """dlw from the states, every sum in the inputs' dtype."""
    w = torch.exp(lw)
    prev, _ = states(k, v, w, s0)
    dS, out = ds, [None] * r.shape[1]
    for t in reversed(range(r.shape[1])):
        out[t] = w[:, t] * (prev[:, t] * dS).sum(-1)
        dS = dS * w[:, t, ..., None] + torch.einsum("bhk,bhv->bhkv",
                                                    r[:, t], dy[:, t])
    return torch.stack(out, 1)


def dlw_identity(r, k, v, lw, u, s0, dy, ds):
    """dlw by the identity, every sum in the inputs' dtype."""
    w = torch.exp(lw)
    S = r.shape[1]
    state, dr_t = s0, []
    for t in range(S):
        dr_t.append(torch.einsum("bhkv,bhv->bhk", state, dy[:, t]))
        state = state * w[:, t, ..., None] + torch.einsum(
            "bhk,bhv->bhkv", k[:, t], v[:, t])
    dS, dk_t = ds, [None] * S
    for t in reversed(range(S)):
        dk_t[t] = torch.einsum("bhkv,bhv->bhk", dS, v[:, t])
        dS = dS * w[:, t, ..., None] + torch.einsum("bhk,bhv->bhkv",
                                                    r[:, t], dy[:, t])
    rdr = r * torch.stack(dr_t, 1)                     # (B, S, H, D)
    kdk = k * torch.stack(dk_t, 1)
    phi_T = (state * ds).sum(-1)                       # (B, H, D)
    # suffix sums: sum_{s>t} r dr~ and sum_{s>=t} k dk~
    after = torch.flip(torch.cumsum(torch.flip(rdr, [1]), 1), [1]) - rdr
    from_t = torch.flip(torch.cumsum(torch.flip(kdk, [1]), 1), [1])
    return after + phi_T[:, None] - from_t


def dlw_chunk(r, k, v, lw, u, s0, dy, ds, chunk=64):
    """dlw by the identity restarted at each chunk's last position e, its
    state and cotangent from the sequence's walks, every sum in the
    inputs' dtype."""
    w = torch.exp(lw)
    S = r.shape[1]
    state, dr_t, after = s0, [], []
    for t in range(S):
        dr_t.append(torch.einsum("bhkv,bhv->bhk", state, dy[:, t]))
        state = state * w[:, t, ..., None] + torch.einsum(
            "bhk,bhv->bhkv", k[:, t], v[:, t])
        after.append(state)                            # S_t
    dS, dk_t, dS_t = ds, [None] * S, [None] * S
    for t in reversed(range(S)):
        dS_t[t] = dS
        dk_t[t] = torch.einsum("bhkv,bhv->bhk", dS, v[:, t])
        dS = dS * w[:, t, ..., None] + torch.einsum("bhk,bhv->bhkv",
                                                    r[:, t], dy[:, t])
    out = [None] * S
    for c0 in range(0, S, chunk):
        e = min(c0 + chunk, S) - 1
        acc = (after[e] * dS_t[e]).sum(-1)             # phi at e
        for t in range(e, c0 - 1, -1):
            kdk = k[:, t] * dk_t[t]
            out[t] = acc - kdk
            acc = acc + (r[:, t] * dr_t[t] - kdk)
    return torch.stack(out, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--head-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=64)
    args = ap.parse_args()
    B, S, H, D = 1, args.seq, args.heads, args.head_size
    for decay, (lo, hi) in DECAYS.items():
        for final in ("zero", "normal"):
            rng = np.random.default_rng(args.seed)
            mk = lambda *s: torch.from_numpy(rng.standard_normal(s))
            r, k, v, dy = (mk(B, S, H, D) for _ in range(4))
            lw = -torch.from_numpy(np.exp(rng.uniform(lo, hi, (B, S, H, D))))
            u, s0 = mk(H, D), mk(B, H, D, D)
            ds = mk(B, H, D, D) if final == "normal" else torch.zeros(
                B, H, D, D, dtype=torch.float64)
            f64 = (r, k, v, lw, u, s0, dy, ds)
            f32 = tuple(t.float() for t in f64)
            truth = dlw_direct(*f64)
            scale = float(truth.abs().max())
            direct = dlw_direct(*f32).double()
            ident = dlw_identity(*f32).double()
            chunked = dlw_chunk(*f32, chunk=args.chunk).double()
            err = lambda x: float((x - truth).abs().max()) / scale
            print(f"S {S} decays {decay:6s} dstate {final:6s}: direct "
                  f"{err(direct):.3e}, identity {err(ident):.3e}, chunk "
                  f"{args.chunk} {err(chunked):.3e} of max |dlw| "
                  f"{scale:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
