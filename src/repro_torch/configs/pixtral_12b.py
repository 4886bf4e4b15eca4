"""Pixtral-12B decoder backbone [hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The Pixtral-ViT
vision encoder + projector is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (frontend='vision').
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    activation="swiglu",
    rope_theta=1e9,
    frontend="vision",
    frontend_tokens=256,  # one 16x16-patch image tile worth of embeddings
    source="hf:mistralai/Pixtral-12B-2409",
)
