"""Jamba v0.1 52B [arXiv:2403.19887].

32L d_model=4096, attention:mamba 1:7 interleave (attention at index 4 of
every 8-block period), 32H (GQA kv=8) d_ff=14336, MoE 16 experts top-2 on
every other block, vocab=65536.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

# period-8 pattern, attention in slot 4 (as in the Jamba paper), x4 periods
_PATTERN = ("MMMMAMMM" * 4)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    block_pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336, moe_every=2),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2),
    source="arXiv:2403.19887",
)
