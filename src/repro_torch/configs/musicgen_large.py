"""MusicGen-large decoder over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048 (EnCodec codebook).
The mel/EnCodec conv frontend is a STUB: ``input_specs`` provides frame
embeddings (frontend='audio'). GELU MLP, full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    rope_theta=1e4,
    frontend="audio",
    frontend_tokens=64,  # conditioning frames from the (stub) codec encoder
    source="arXiv:2306.05284",
)
