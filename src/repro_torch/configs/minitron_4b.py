"""Minitron-4B (pruned Nemotron-4) [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000, squared-ReLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="relu2",
    rope_theta=1e4,
    source="arXiv:2407.14679",
)
