"""Decoder-only LM for every assigned architecture.

A model is a repeated ``layer_pattern`` of layers: attention, ``"attn"``
(global) or ``"local"`` (a sliding window of ``window_size`` keys, as in
Gemma-3's 5 local : 1 global), each with a dense MLP or, for the MoE
configs, a mixture of experts (``models.moe``); ``"rglru"``, Griffin's
recurrent block (``models.rglru``, RecurrentGemma's rglru, rglru, local);
or ``"rwkv"``, RWKV-6's time and channel mixing (``models.rwkv6``).
``Transformer`` is an ``nn.Module`` laid out as the reference's
parameter tree (``embed``, ``final_norm``, ``blocks``), indexed the same
way (``params["blocks"][i]["attn"]["wq"]``), with one ``Block`` a layer
where the reference stacks each pattern position's layers along a
scanned leading axis; layer i has kind ``layer_pattern[i % len(pattern)]`` for
the whole groups and ``rem_layers`` after them.  The reference's entry
points keep their names as module-level functions over it:
``forward_hidden`` and ``logits_fn`` (the full-sequence forward),
``prefill`` (last-position logits and the caches; attention through the
flash kernel, the recurrences through the linear_scan and wkv6 kernels)
and ``decode_step`` (one token or frame against the caches: an attention
layer's k and v, a recurrent layer's state, O(1) in the sequence).
Inputs are ``{"tokens": (B, S)}`` or, for the encodec frontend
(MusicGen), ``{"frames": (B, S, d_model)}`` (precomputed frame
embeddings, as the reference's stub); several codebooks give (B, S, K, V)
logits.  Layers run in a Python loop; there is no mesh and no
rematerialisation on one card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RWKV

ATTN_KINDS = ("attn", "local")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` naming what this port lacks for ``cfg``."""
    missing = []
    if cfg.frontend not in ("none", "vq_image", "encodec"):
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.pos_emb not in ("rope", "sinusoidal", "none"):
        missing.append(f"{cfg.pos_emb} position embeddings")
    if missing:
        raise ValueError(f"{cfg.name}: the port lacks "
                         f"{', '.join(missing)}")


def layer_kinds(cfg) -> list:
    """Each layer's kind: the pattern over the whole groups, then
    ``rem_layers``."""
    return [cfg.layer_pattern[i % cfg.pattern_len]
            for i in range(cfg.num_groups * cfg.pattern_len)] + list(
                cfg.rem_layers)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def block_pspecs(cfg, kind="attn"):
    if kind in ATTN_KINDS:
        mlp = MOE.moe_pspecs(cfg) if cfg.moe else L.mlp_pspecs(cfg)
        return {"norm1": L.norm_pspecs(cfg), "attn": L.attn_pspecs(cfg),
                "norm2": L.norm_pspecs(cfg), "mlp": mlp}
    if kind == "rglru":
        return {"norm1": L.norm_pspecs(cfg), "rec": RG.rglru_pspecs(cfg),
                "norm2": L.norm_pspecs(cfg), "mlp": L.mlp_pspecs(cfg)}
    if kind == "rwkv":
        return {"norm1": L.norm_pspecs(cfg),
                "tmix": RWKV.time_mix_pspecs(cfg),
                "norm2": L.norm_pspecs(cfg), "cmix": L.mlp_pspecs(cfg)}
    raise ValueError(kind)


def model_pspecs(cfg):
    """The module's tree: the reference's, with ``blocks`` one entry a
    layer instead of stacked along a scanned axis (``ln0``, RWKV-6's norm
    of the embeddings, where the family has it)."""
    check_supported(cfg)
    p = {"embed": L.embed_pspecs(cfg), "final_norm": L.norm_pspecs(cfg)}
    if cfg.family == "rwkv6":
        p["ln0"] = L.norm_pspecs(cfg)
    p["blocks"] = [block_pspecs(cfg, kind) for kind in layer_kinds(cfg)]
    return p


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.ModuleDict):
    """One layer: ``norm1``, ``attn``, ``norm2``, ``mlp`` (dense, or the
    MoE's ``router`` and (E, ...) expert weights); a recurrent layer's
    ``rec`` (RG-LRU) or ``tmix`` and ``cmix`` (RWKV-6) in their place."""

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
            **({"ln0": _params(tree["ln0"])} if "ln0" in tree else {}),
            "blocks": nn.ModuleList(Block(b) for b in tree["blocks"])})
        if len(self["blocks"]) != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {len(self['blocks'])} blocks for "
                             f"{cfg.num_layers} layers")
        self.cfg = cfg

    def forward(self, inputs, dtype=torch.bfloat16, *, moe_dense=False):
        """``inputs``: a (B, S) tensor of tokens, or a batch dict."""
        batch = inputs if isinstance(inputs, dict) else {"tokens": inputs}
        qpos = torch.arange(seq_len(batch), device=batch_device(batch))
        x = embed_input(self.cfg, self, batch, qpos, dtype)
        hidden, _, _ = forward_hidden(self.cfg, self, x, qpos,
                                      moe_dense=moe_dense, aux=False)
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
    top = {k: conv(tree[k]) for k in ("embed", "final_norm", "ln0")
           if k in tree}
    return Transformer(cfg, {**top, "blocks": [conv(b) for b in blocks]})


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_layer_cache(cfg, kind, batch, max_seq, dtype=torch.bfloat16,
                     device=None):
    if kind in ATTN_KINDS:
        return L.init_attn_cache(cfg, batch, max_seq, kind, dtype, device)
    if kind == "rglru":
        return RG.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "rwkv":
        return RWKV.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """One zero cache a layer: an attention layer's ``{"k", "v"}`` buffer
    of (B, Sc, KH, D), Sc = max_seq, or ``min(max_seq, window_size)`` for
    a local layer; an RG-LRU layer's ``{"conv", "state"}``; an RWKV-6
    layer's ``{"tmix": {"shift", "state"}, "cmix": {"shift"}}``."""
    device = resolve_device(device)
    return [init_layer_cache(cfg, kind, batch, max_seq, dtype, device)
            for kind in layer_kinds(cfg)]


def _materialize_cache(k, v, S, Sc, window=0):
    """A (B, Sc, KH, D) cache: a local layer's ring (``Sc == window <=
    S``) holds positions S-window .. S-1 at slots ``pos mod window``;
    otherwise the first min(S, Sc) positions from slot 0."""
    B, _, KH, D = k.shape
    ck = torch.zeros((B, Sc, KH, D), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, Sc, KH, D), dtype=v.dtype, device=v.device)
    if window and S >= window and Sc == window:
        # slots (S - window + i) mod window for i = 0..window-1: the last
        # window positions rolled so that position p sits at p mod window
        shift = (S - window) % window
        ck[:] = torch.roll(k[:, S - window:], shift, dims=1)
        cv[:] = torch.roll(v[:, S - window:], shift, dims=1)
    else:
        n = min(S, Sc)
        ck[:, :n] = k[:, :n]
        cv[:, :n] = v[:, :n]
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def attn_with_cache(cfg, p, x, qpos, *, kind, cache, kv_len,
                    build_cache_len):
    """``attn_apply``; for a prefill (``build_cache_len`` set), the cache
    built from its k and v (the reference projects them a second time;
    the values are the same), a local layer's as its ring."""
    out, kv = L.attn_apply(cfg, p, x, qpos, kind=kind, cache=cache,
                           kv_len=kv_len)
    if build_cache_len is not None:
        window = cfg.window_size if kind == "local" else 0
        kv = _materialize_cache(kv["k"], kv["v"], x.shape[1],
                                L.cache_len(cfg, build_cache_len, kind),
                                window)
    return out, kv


def block_apply(cfg, kind, p, x, qpos, *, cache=None, kv_len=None,
                build_cache_len=None, moe_dense=False, aux=True):
    """Returns (x, new_cache, aux_losses): the MoE's losses, or None for
    a dense MLP or a recurrent layer (and, with ``aux=False``, their
    values None).  A recurrent layer's cache is its state after x, from
    ``cache`` (None: zeros), whether or not the call builds caches."""
    if kind == "rglru":
        h = L.apply_norm(cfg, p["norm1"], x)
        r, new_cache = RG.rglru_block_apply(cfg, p["rec"], h, cache=cache)
        x = x + r
        h = L.apply_norm(cfg, p["norm2"], x)
        return x + L.mlp_apply(cfg, p["mlp"], h), new_cache, None
    if kind == "rwkv":
        h = L.apply_norm(cfg, p["norm1"], x)
        t, tcache = RWKV.time_mix_apply(
            cfg, p["tmix"], h, cache=cache["tmix"] if cache else None)
        x = x + t
        h = L.apply_norm(cfg, p["norm2"], x)
        c, ccache = RWKV.channel_mix_apply(
            cfg, p["cmix"], h, cache=cache["cmix"] if cache else None)
        return x + c, {"tmix": tcache, "cmix": ccache}, None
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    h = L.apply_norm(cfg, p["norm1"], x)
    a, new_cache = attn_with_cache(cfg, p["attn"], h, qpos, kind=kind,
                                   cache=cache, kv_len=kv_len,
                                   build_cache_len=build_cache_len)
    x = x + a
    h = L.apply_norm(cfg, p["norm2"], x)
    if cfg.moe:
        moe = MOE.moe_apply_dense if moe_dense else MOE.moe_apply
        m, losses = moe(cfg, p["mlp"], h, aux=aux)
    else:
        m, losses = L.mlp_apply(cfg, p["mlp"], h), None
    return x + m, new_cache, losses


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _input(batch) -> torch.Tensor:
    return batch["frames"] if "frames" in batch else batch["tokens"]


def seq_len(batch) -> int:
    """Positions in a batch of tokens (B, S) or frames (B, S, d)."""
    return _input(batch).shape[1]


def batch_device(batch):
    return _input(batch).device


def embed_input(cfg, params, batch, qpos, dtype=torch.bfloat16):
    """Token embeddings, or the encodec frontend's frames (B, S, d) cast
    to ``dtype`` and scaled as embeddings are; sinusoidal positions added
    at ``qpos`` where the config has them; RWKV-6's ``ln0``."""
    if "frames" in batch:                       # stubbed modality frontend
        x = batch["frames"].to(dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype).item()
    else:
        x = L.embed_lookup(cfg, params["embed"], batch["tokens"], dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + L.sinusoidal_emb(qpos, cfg.d_model, dtype)[None]
    if cfg.family == "rwkv6":
        x = L.apply_norm(cfg, params["ln0"], x)
    return x


def forward_hidden(cfg, params, x, qpos, *, caches=None, kv_len=None,
                   build_cache_len=None, moe_dense=False, aux=True):
    """Run all layers.  Returns (hidden, new_caches, aux): ``aux`` holds
    the MoE layers' summed ``lb_loss`` and ``z_loss``, float32 scalars
    (zeros for a dense model; None with ``aux=False``, which skips them)."""
    keep = caches is not None or build_cache_len is not None
    kinds = layer_kinds(cfg)
    new_caches = []
    total = None
    if aux:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        total = {"lb_loss": zero, "z_loss": zero}
    for i, bp in enumerate(params["blocks"]):
        x, nc, losses = block_apply(
            cfg, kinds[i], bp, x, qpos,
            cache=caches[i] if caches is not None else None, kv_len=kv_len,
            build_cache_len=build_cache_len, moe_dense=moe_dense, aux=aux)
        if keep:
            new_caches.append(nc)
        if aux and losses is not None:
            total = {k: total[k] + losses[k] for k in total}
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, (new_caches if keep else None), total


def logits_fn(cfg, params, hidden):
    """(B, S, V) logits, or (B, S, K, V) with K codebook heads."""
    head = L.head_matrix(cfg, params["embed"]).to(hidden.dtype)
    if cfg.num_codebooks > 1:
        return torch.einsum("bsd,kdv->bskv", hidden, head)
    return hidden @ head


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch, max_seq, *, moe_dense=False,
            dtype=torch.bfloat16):
    """Full-sequence forward building the caches.  ``batch``: {"tokens":
    (B, S) integer tensor} or {"frames": (B, S, d)}; prompts are not
    masked for left padding (positions are ``arange(S)``), as in the
    reference.  Returns (last_logits (B, 1, [K,] V), caches)."""
    qpos = torch.arange(seq_len(batch), device=batch_device(batch))
    x = embed_input(cfg, params, batch, qpos, dtype)
    hidden, caches, _ = forward_hidden(cfg, params, x, qpos,
                                       build_cache_len=max_seq,
                                       moe_dense=moe_dense, aux=False)
    return logits_fn(cfg, params, hidden[:, -1:]), caches


def decode_step(cfg, params, caches, pos: int, batch, *, moe_dense=False,
                dtype=torch.bfloat16):
    """One token (or frame) at 0-based position ``pos`` (a host int) for
    the whole batch.  ``batch``: {"tokens": (B, 1)} or {"frames": (B, 1,
    d)}.  Attention caches are updated in place; a recurrent layer's
    state comes back as a new cache.  Returns (logits (B, 1, [K,] V),
    caches)."""
    qpos = torch.arange(int(pos), int(pos) + 1, device=batch_device(batch))
    x = embed_input(cfg, params, batch, qpos, dtype)
    hidden, caches, _ = forward_hidden(cfg, params, x, qpos, caches=caches,
                                       kv_len=int(pos), moe_dense=moe_dense,
                                       aux=False)
    return logits_fn(cfg, params, hidden), caches
