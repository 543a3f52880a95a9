"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU + local attention (2:1).

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680
vocab=256000.  Pattern: (recurrent, recurrent, local-attention) repeated;
sliding window 2048; RG-LRU width 2560, temporal conv width 4.
O(1)-state recurrent decode; eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

RECURRENTGEMMA_2B = register(ArchConfig(
    name="recurrentgemma-2b",
    family="rglru",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    conv_width=4,
    lru_width=2560,
    rope_base=10_000.0,
    sub_quadratic=True,
    source="arXiv:2402.19427",
))
