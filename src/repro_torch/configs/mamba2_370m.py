"""Mamba2-370m (SSD, state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    activation="swiglu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=64),
    source="arXiv:2405.21060",
)
