"""qwen1.5-4b — dense transformer with QKV bias (MHA: kv == heads).

[hf:Qwen/Qwen1.5-0.5B (family); hf]  40L d_model=2560 20H (GQA kv=20)
d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN15_4B = register(ArchConfig(
    name="qwen1.5-4b",
    family="transformer",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    layer_pattern=("attn",),
    mlp="swiglu",
    qkv_bias=True,
    rope_base=10_000.0,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-0.5B (family); 4b geometry per assignment",
))
