"""Decoder-only LM for the dense global-attention transformers.

``Transformer`` is an ``nn.Module`` laid out as the reference's parameter
tree (``embed``, ``final_norm``, ``blocks``), indexed the same way
(``params["blocks"][i]["attn"]["wq"]``), with one ``Block`` a layer where
the reference stacks the layers along a scanned leading axis.  The
reference's entry points keep their names as module-level functions over
it: ``forward_hidden`` and ``logits_fn`` (the full-sequence forward),
``prefill`` (last-position logits and the KV cache; attention through the
flash kernel) and ``decode_step`` (one token against the cache).  Layers
run in a Python loop; there is no mesh and no rematerialisation on one
card.

Families that need more than a dense block (MoE, local windows, RG-LRU,
RWKV-6, modality frontends, several codebooks, sinusoidal positions) are
refused with a ``ValueError`` (ROADMAP queue A item 5).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L


def check_supported(cfg) -> None:
    """Raise ``ValueError`` naming what this port lacks for ``cfg``."""
    missing = []
    if cfg.moe:
        missing.append("mixture-of-experts layers (models/moe.py)")
    kinds = set(cfg.layer_pattern)
    if "local" in kinds:
        missing.append("local-window attention and ring caches")
    if "rglru" in kinds or cfg.family == "rglru":
        missing.append("RG-LRU blocks (models/rglru.py)")
    if cfg.family == "rwkv6" or "rwkv" in kinds:
        missing.append("RWKV-6 mixing (models/rwkv6.py)")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.num_codebooks > 1:
        missing.append("multi-codebook heads")
    if cfg.pos_emb not in ("rope", "none"):
        missing.append(f"{cfg.pos_emb} position embeddings")
    if missing:
        raise ValueError(f"{cfg.name}: the port runs dense global-attention "
                         f"transformers only; it lacks "
                         f"{', '.join(missing)} (ROADMAP queue A item 5)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def block_pspecs(cfg):
    return {"norm1": L.norm_pspecs(cfg), "attn": L.attn_pspecs(cfg),
            "norm2": L.norm_pspecs(cfg), "mlp": L.mlp_pspecs(cfg)}


def model_pspecs(cfg):
    """The module's tree: the reference's, with ``blocks`` one entry a
    layer instead of stacked along a scanned axis."""
    check_supported(cfg)
    return {"embed": L.embed_pspecs(cfg), "final_norm": L.norm_pspecs(cfg),
            "blocks": [block_pspecs(cfg) for _ in range(cfg.num_layers)]}


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.ModuleDict):
    """One dense layer: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, tree: dict):
        super().__init__({k: _params(v) for k, v in tree.items()})


class Transformer(nn.ModuleDict):
    """The model's parameters under the reference's keys; ``forward``
    is the full-sequence forward to logits."""

    def __init__(self, cfg, tree: dict):
        check_supported(cfg)
        super().__init__({
            "embed": _params(tree["embed"]),
            "final_norm": _params(tree["final_norm"]),
            "blocks": nn.ModuleList(Block(b) for b in tree["blocks"])})
        if len(self["blocks"]) != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {len(self['blocks'])} blocks for "
                             f"{cfg.num_layers} layers")
        self.cfg = cfg

    def forward(self, tokens, dtype=torch.bfloat16):
        qpos = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed_input(self.cfg, self, {"tokens": tokens}, qpos, dtype)
        hidden, _, _ = forward_hidden(self.cfg, self, x, qpos)
        return logits_fn(self.cfg, self, hidden)


def init_params(cfg, generator: torch.Generator | None = None, *,
                dtype=torch.float32, device=None, seed: int = 0):
    """A ``Transformer`` with the reference's initialisation scheme drawn
    leaf by leaf on ``device`` from ``generator`` (None: a generator on
    that device seeded with ``seed``), stored in ``dtype``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    depth_scale = 1.0 / np.sqrt(2.0 * max(cfg.num_layers, 1))
    tree = L.init_params(model_pspecs(cfg), generator, depth_scale,
                         dtype=dtype, device=device)
    return Transformer(cfg, tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg, tree: dict, device=None) -> Transformer:
    """A ``Transformer`` holding the reference's parameter tree (numpy
    arrays, any float dtype, bfloat16 included), dtype kept: the scanned
    ``blocks`` (one stack per pattern position, layers along the leading
    axis) and ``rem_blocks`` unstack into one block a layer, in layer
    order."""
    device = resolve_device(device)
    conv = lambda node: {k: (conv(v) if isinstance(v, dict)
                             else _tensor(v, device))
                         for k, v in node.items()}
    plen, groups = cfg.pattern_len, cfg.num_groups
    blocks = []
    for layer in range(cfg.num_layers):
        g, i = divmod(layer, plen)
        if g < groups:
            stacked = tree["blocks"][i]
            blocks.append({k: {n: a[g] for n, a in sub.items()}
                           for k, sub in stacked.items()})
        else:
            blocks.append(tree["rem_blocks"][layer - groups * plen])
    return Transformer(cfg, {"embed": conv(tree["embed"]),
                             "final_norm": conv(tree["final_norm"]),
                             "blocks": [conv(b) for b in blocks]})


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """One ``{"k", "v"}`` buffer of (B, max_seq, KH, D) a layer."""
    device = resolve_device(device)
    return [L.init_attn_cache(cfg, batch, max_seq, dtype, device)
            for _ in range(cfg.num_layers)]


def _materialize_cache(k, v, S, Sc):
    """A (B, Sc, KH, D) cache holding the first min(S, Sc) positions."""
    B, _, KH, D = k.shape
    ck = torch.zeros((B, Sc, KH, D), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, Sc, KH, D), dtype=v.dtype, device=v.device)
    n = min(S, Sc)
    ck[:, :n] = k[:, :n]
    cv[:, :n] = v[:, :n]
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def attn_with_cache(cfg, p, x, qpos, *, cache, kv_len, build_cache_len):
    """``attn_apply``; for a prefill (``build_cache_len`` set), the cache
    built from its k and v (the reference projects them a second time;
    the values are the same)."""
    out, kv = L.attn_apply(cfg, p, x, qpos, cache=cache, kv_len=kv_len)
    if build_cache_len is not None:
        kv = _materialize_cache(kv["k"], kv["v"], x.shape[1],
                                build_cache_len)
    return out, kv


def block_apply(cfg, p, x, qpos, *, cache=None, kv_len=None,
                build_cache_len=None):
    """Returns (x, new_cache)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    a, new_cache = attn_with_cache(cfg, p["attn"], h, qpos, cache=cache,
                                   kv_len=kv_len,
                                   build_cache_len=build_cache_len)
    x = x + a
    h = L.apply_norm(cfg, p["norm2"], x)
    return x + L.mlp_apply(cfg, p["mlp"], h), new_cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_input(cfg, params, batch, qpos, dtype=torch.bfloat16):
    return L.embed_lookup(cfg, params["embed"], batch["tokens"], dtype)


def forward_hidden(cfg, params, x, qpos, *, caches=None, kv_len=None,
                   build_cache_len=None):
    """Run all layers.  Returns (hidden, new_caches, aux); a dense model
    has no auxiliary losses, so ``aux`` holds zeros."""
    keep = caches is not None or build_cache_len is not None
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        x, nc = block_apply(cfg, bp, x, qpos,
                            cache=caches[i] if caches is not None else None,
                            kv_len=kv_len, build_cache_len=build_cache_len)
        if keep:
            new_caches.append(nc)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, (new_caches if keep else None), {"lb_loss": 0.0,
                                               "z_loss": 0.0}


def logits_fn(cfg, params, hidden):
    head = L.head_matrix(cfg, params["embed"])
    return hidden @ head.to(hidden.dtype)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch, max_seq, *, dtype=torch.bfloat16):
    """Full-sequence forward building the cache.  ``batch``: {"tokens":
    (B, S) integer tensor}; prompts are not masked for left padding
    (positions are ``arange(S)``), as in the reference.  Returns
    (last_logits (B, 1, V), caches)."""
    S = batch["tokens"].shape[1]
    qpos = torch.arange(S, device=batch["tokens"].device)
    x = embed_input(cfg, params, batch, qpos, dtype)
    hidden, caches, _ = forward_hidden(cfg, params, x, qpos,
                                       build_cache_len=max_seq)
    return logits_fn(cfg, params, hidden[:, -1:]), caches


def decode_step(cfg, params, caches, pos: int, batch, *,
                dtype=torch.bfloat16):
    """One token at 0-based position ``pos`` (a host int) for the whole
    batch.  ``batch``: {"tokens": (B, 1)}.  The caches are updated in
    place.  Returns (logits (B, 1, V), caches)."""
    qpos = torch.arange(int(pos), int(pos) + 1,
                        device=batch["tokens"].device)
    x = embed_input(cfg, params, batch, qpos, dtype)
    hidden, caches, _ = forward_hidden(cfg, params, x, qpos, caches=caches,
                                       kv_len=int(pos))
    return logits_fn(cfg, params, hidden), caches
