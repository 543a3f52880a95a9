"""glm4-9b — dense transformer, extreme GQA (kv=2), partial rotary.

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.  GLM4 uses 50% partial rotary embedding and QKV bias.
"""
from repro_torch.configs.base import ArchConfig, register

GLM4_9B = register(ArchConfig(
    name="glm4-9b",
    family="transformer",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    layer_pattern=("attn",),
    mlp="swiglu",
    rope_pct=0.5,
    qkv_bias=True,
    rope_base=10_000.0,
    sub_quadratic=False,
    source="hf:THUDM/glm-4-9b",
))
