"""rwkv6-1.6b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
Head size 64 -> 32 WKV heads.  O(1)-state decode; eligible for long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

RWKV6_1B6 = register(ArchConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # d_model / rwkv_head_size
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    mlp="rwkv_channel_mix",    # RWKV channel mixing (squared-relu variant)
    rwkv_head_size=64,
    pos_emb="none",
    norm="layernorm",
    sub_quadratic=True,
    source="arXiv:2404.05892",
))
