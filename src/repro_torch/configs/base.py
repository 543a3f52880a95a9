"""Architecture / shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape
is a ``ShapeSpec``.  Reduced ("smoke") variants of each arch are derived
mechanically so CPU tests stay cheap while exercising the same code paths.
A copy of the reference's ``configs/base.py`` (pure dataclasses); only
``get_arch`` differs: an assigned architecture whose model family the port
does not run yet raises a ``KeyError`` that names the work still to do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterator


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # "transformer" | "rwkv6" | "rglru"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer pattern -----------------------------------------------------
    # Repeated over depth.  Entries: "attn" (global), "local" (windowed attn),
    # "rglru" (recurrent block).  len(pattern) is the scan-group size.
    layer_pattern: tuple = ("attn",)
    window_size: int = 0              # for "local" layers

    # --- attention details ---------------------------------------------------
    pos_emb: str = "rope"             # "rope" | "sinusoidal" | "none"
    rope_base: float = 10_000.0
    rope_base_global: float = 0.0     # 0 -> same as rope_base (gemma3: 1e6)
    rope_pct: float = 1.0             # partial rotary (glm4 / nemotron: 0.5)
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0        # final-logit softcap (0 = off)

    # --- MLP -----------------------------------------------------------------
    mlp: str = "swiglu"               # "swiglu" | "geglu" | "relu2" | "gelu"

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- embeddings ----------------------------------------------------------
    embed_scale: bool = False         # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = False

    # --- modality frontend (stub per assignment) -----------------------------
    frontend: str = "none"            # "none" | "vq_image" | "encodec"
    num_codebooks: int = 1

    # --- recurrent families --------------------------------------------------
    conv_width: int = 4               # temporal conv width (rglru)
    lru_width: int = 0                # RG-LRU state width (0 -> d_model)
    rwkv_head_size: int = 64

    # --- norms ---------------------------------------------------------------
    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6

    # --- runtime -------------------------------------------------------------
    dtype: str = "bfloat16"
    sub_quadratic: bool = False       # eligible for long_500k
    attn_impl: str = "baseline"       # "baseline" | "packed" (see layers.py)
    attn_part: str = "baseline"       # "baseline" | "expand": repeat KV to
                                      # full head count so attention shards
                                      # head-parallel when kv_heads < TP
    norm_bf16_mul: bool = False       # norms: f32 only inside the variance
                                      # reduction (fused); multiplies stay
                                      # bf16 -> no full-seq f32 tensors
    moe_scatter_out: bool = False     # psum_scatter MoE output over seq
                                      # (matches the SP residual; 16x less
                                      # all-reduce volume than full psum)
    train_gather_bf16: bool = False   # cast params bf16 BEFORE the FSDP
                                      # all-gather (identical numerics: the
                                      # baseline casts the same f32 values
                                      # after gathering; this halves gather
                                      # bytes on the ICI)
    source: str = ""                  # provenance tag from the assignment

    # -------------------------------------------------------------------
    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.pattern_len

    @property
    def rem_layers(self) -> tuple:
        """Trailing layers that do not fill a whole pattern group."""
        rem = self.num_layers % self.pattern_len
        return self.layer_pattern[:rem]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # -------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and sanity checks)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d                                    # embedding
        if not self.tie_embeddings:
            n += v * d * self.num_codebooks           # lm head(s)
        n += d                                        # final norm
        for kind in self._all_layers():
            if kind in ("attn", "local"):
                n += self._attn_params()
                n += self._mlp_params()
                n += 2 * d                            # pre norms
                if self.norm == "layernorm":
                    n += 2 * d
            elif kind == "rglru":
                n += self._rglru_params()
                n += self._mlp_params()
                n += 2 * d
            elif kind == "rwkv":
                # time mixing: r,k,v,g,o projections + token-shift mixing
                # LoRAs (5x32), decay LoRA (64), mu/u/groupnorm vectors
                n += 5 * d * d + d * (1 + 5 + 2 * 5 * 32 + 1 + 2 * 64 + 1 + 2)
                # channel mixing: k (d->dff), v (dff->d), r (d->d), mixes
                n += d * dff + dff * d + d * d + 2 * d
                n += 4 * d                        # two layernorms
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        expert_p = self._expert_params()
        total = self.param_count()
        inactive = (self.num_experts - self.experts_per_token) * expert_p
        return total - inactive * self.num_layers

    def _all_layers(self):
        for g in range(self.num_groups):
            yield from self.layer_pattern
        yield from self.rem_layers

    def _attn_params(self) -> int:
        d = self.d_model
        p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            p += 2 * self.head_dim
        return p

    def _expert_params(self) -> int:
        d, dff = self.d_model, self.d_ff
        if self.mlp in ("swiglu", "geglu"):
            return 3 * d * dff
        return 2 * d * dff

    def _mlp_params(self) -> int:
        d, dff = self.d_model, self.d_ff
        if self.moe:
            return self.num_experts * self._expert_params() + d * self.num_experts
        if self.mlp in ("swiglu", "geglu"):
            return 3 * d * dff
        return 2 * d * dff

    def _rglru_params(self) -> int:
        d = self.d_model
        w = self.lru_width or d
        # in/out proj (2 branches) + conv + rg-lru gates + out
        p = 2 * d * w            # x branch + gate branch
        p += self.conv_width * w  # temporal conv (depthwise)
        p += 2 * (w // _RGLRU_BLOCKS) * w  # input & recurrence gates (block-diag)
        p += w                   # lambda
        p += w * d               # out proj
        return p

    # -------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """Mechanically reduced config of the same family for CPU tests."""
        plen = self.pattern_len
        changes = dict(
            name=self.name + "-smoke",
            num_layers=max(plen, 2 if plen == 1 else plen),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=160,
            vocab_size=256,
            window_size=min(self.window_size, 8) if self.window_size else 0,
            lru_width=128 if self.lru_width else 0,
            rwkv_head_size=32,
        )
        if self.moe:
            changes.update(num_experts=4, experts_per_token=min(self.experts_per_token, 2))
        return dataclasses.replace(self, **changes)


_RGLRU_BLOCKS = 1  # block-diagonal gate factor (1 = dense, matches small widths)


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k only for sub-quadratic archs (see DESIGN.md table)."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}

# assigned architectures not registered in the port, and what they need
# (ROADMAP queue A, item 5: the LM stack's second half)
NOT_PORTED = {
    "phi3.5-moe-42b-a6.6b": "mixture-of-experts layers (models/moe.py)",
    "olmoe-1b-7b": "mixture-of-experts layers (models/moe.py)",
    "gemma3-27b": "local-window attention with ring caches",
    "nemotron-4-15b": "its config (a later slice of the LM stack)",
    "chameleon-34b": "the vq_image modality frontend",
    "rwkv6-1.6b": "the RWKV-6 time and channel mixing (models/rwkv6.py)",
    "musicgen-large": "the encodec frontend and multi-codebook heads",
    "recurrentgemma-2b": "RG-LRU blocks (models/rglru.py) and local "
                         "attention",
}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: it needs "
                       f"{NOT_PORTED[name]}, ROADMAP queue A item 5; "
                       f"have {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict:
    return dict(_REGISTRY)


def cells() -> Iterator[tuple]:
    """Yield every applicable (arch, shape) dry-run cell."""
    for arch in _REGISTRY.values():
        for shape in SHAPES.values():
            if shape_applicable(arch, shape):
                yield arch, shape
