"""A decoder-LM configuration file as the program's ``ModelConfig``, and
the tiny widths that the benchmark's CPU tests cut it to."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig

# the port's ModelConfig.reduced() widths, as Hugging Face keys
TINY = {"hidden_size": 256, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 64, "intermediate_size": 512, "num_hidden_layers": 2,
        "vocab_size": 512}
TINY_EXPERTS = {"num_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 128}


def tiny(conf) -> dict:
    """The keys of ``conf`` to overwrite for a run at tiny widths on the
    CPU: 2 layers, d 256, 4 query and 2 KV heads of 64, FFN 512,
    vocabulary 512, and, for a mixture of experts, 4 experts of width
    128, top-2."""
    return {**TINY, **(TINY_EXPERTS if conf.get("num_experts") else {})}


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
