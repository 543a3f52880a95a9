"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE transformer.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ArchConfig, register

PHI35_MOE = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="transformer",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    layer_pattern=("attn",),
    mlp="swiglu",
    num_experts=16,
    experts_per_token=2,
    norm="layernorm",          # Phi-3.5-MoE uses LayerNorm
    rope_base=10_000.0,
    sub_quadratic=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
