"""gemma3-27b — dense transformer, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  head_dim=128 (explicit, gemma3 style: q_dim != d_model).
Pattern: 5 sliding-window (1024) layers then 1 global layer; global layers use
rope base 1e6.
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA3_27B = register(ArchConfig(
    name="gemma3-27b",
    family="transformer",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window_size=1024,
    mlp="geglu",
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_base=10_000.0,
    rope_base_global=1_000_000.0,
    sub_quadratic=True,        # 5/6 of layers are sliding-window
    source="hf:google/gemma-3-1b-pt (family); 27b geometry per assignment",
))
