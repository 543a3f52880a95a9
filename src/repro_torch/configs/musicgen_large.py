"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048.  Backbone only per assignment: the EnCodec frontend is a stub
that supplies precomputed frame embeddings (sum of 4 codebook embeddings,
delay-pattern interleaving abstracted away).  4 codebook output heads.
"""
from repro_torch.configs.base import ArchConfig, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    family="transformer",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=("attn",),
    mlp="gelu",
    pos_emb="sinusoidal",
    norm="layernorm",
    frontend="encodec",
    num_codebooks=4,
    sub_quadratic=False,
    source="arXiv:2306.05284 / hf:facebook/musicgen-large",
))
