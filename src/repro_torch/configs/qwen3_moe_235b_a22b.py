"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family, scaled card].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # all blocks are MoE
    vocab_size=151936,
    activation="swiglu",
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536),
    source="hf:Qwen/Qwen3-30B-A3B",
)
