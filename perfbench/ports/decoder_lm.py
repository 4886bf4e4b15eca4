"""A decoder-LM configuration file as the program's ``ModelConfig``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig


def model_config(conf) -> ModelConfig:
    """The port's config of ``conf`` (Hugging Face keys, as cut)."""
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's decoder MLPs here are SwiGLU")
    if conf.get("num_experts") and not conf.get("norm_topk_prob", False):
        raise ValueError("the port renormalizes the top-k gates")
    moe = MoEConfig()
    if conf.get("num_experts"):
        moe = MoEConfig(num_experts=conf["num_experts"],
                        top_k=conf["num_experts_per_tok"],
                        expert_d_ff=conf["moe_intermediate_size"])
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"],
        arch_type="moe" if moe.enabled else "dense",
        num_layers=conf["num_hidden_layers"],
        d_model=d,
        num_heads=h,
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=int(conf.get("head_dim") or d // h),
        d_ff=0 if moe.enabled else conf["intermediate_size"],
        vocab_size=conf["vocab_size"],
        activation="swiglu",
        qkv_bias=bool(conf.get("qkv_bias") or conf.get("attention_bias")),
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        moe=moe,
        source=conf["source"],
    )
