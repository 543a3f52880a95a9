"""olmoe-1b-7b — 64-expert top-8 MoE transformer.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ArchConfig, register

OLMOE = register(ArchConfig(
    name="olmoe-1b-7b",
    family="transformer",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    layer_pattern=("attn",),
    mlp="swiglu",
    num_experts=64,
    experts_per_token=8,
    qk_norm=True,              # OLMoE applies QK-norm
    rope_base=10_000.0,
    sub_quadratic=False,
    source="arXiv:2409.02060",
))
