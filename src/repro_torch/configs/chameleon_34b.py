"""chameleon-34b — early-fusion VLM over a unified text+VQ-image vocab.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536.  Early fusion: images are VQ-quantized into tokens of the SAME
vocabulary, so the backbone is a plain decoder-only transformer; the VQ
tokenizer is the (stubbed) modality frontend.  Chameleon uses QK-norm for
training stability.
"""
from repro_torch.configs.base import ArchConfig, register

CHAMELEON_34B = register(ArchConfig(
    name="chameleon-34b",
    family="transformer",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    layer_pattern=("attn",),
    mlp="swiglu",
    qk_norm=True,
    frontend="vq_image",
    rope_base=10_000.0,
    sub_quadratic=False,
    source="arXiv:2405.09818",
))
