"""nemotron-4-15b — dense transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified]  32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000.  Nemotron-4: squared-ReLU (no gating), partial rotary 50%,
LayerNorm.
"""
from repro_torch.configs.base import ArchConfig, register

NEMOTRON4_15B = register(ArchConfig(
    name="nemotron-4-15b",
    family="transformer",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern=("attn",),
    mlp="relu2",
    rope_pct=0.5,
    norm="layernorm",
    rope_base=10_000.0,
    sub_quadratic=False,
    source="arXiv:2402.16819",
))
