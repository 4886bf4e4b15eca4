"""Nemotron-4 340B [arXiv:2402.16819 / 2406.11704].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    rope_theta=1e4,
    source="arXiv:2402.16819",
)
