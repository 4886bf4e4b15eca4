"""Frozen arithmetic of the benchmark: the card's peaks, a kernel's least
time, a training step's model FLOPs. Later changes to the program do not
change these.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at a
power limit of 700 W (copied from ``chip_smoke.py`` ``HBM_BYTES_PER_S``,
``BF16_FLOPS_PER_S``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def stage_bound(rows: int, d: int, f: int, gated: bool, x_elt: int,
                w_elt: int, flops_per_s: float = BF16_FLOPS_PER_S
                ) -> Tuple[float, str, int, int]:
    """Least time (ms) of one ``stage_mlp_block`` call: bytes (x and the
    norm weight read once, the weights read once in their stored type,
    the output written once) over the HBM rate against the three (two
    ungated) products over the operands' peak; the larger wins. Returns
    ``(ms, "bytes" | "operations", bytes, flops)``.

    Copied from ``chip_smoke.py`` ``stage_bound``."""
    mats = 3 if gated else 2
    nbytes = 2 * rows * d * x_elt + d * w_elt + mats * d * f * w_elt
    flops = 2 * rows * d * f * mats
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def head_dim(conf: Dict[str, Any]) -> int:
    return int(conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"])


def active_matmul_params(conf: Dict[str, Any]) -> int:
    """Parameters a token multiplies by in the forward: every block's
    attention and (dense or its routed experts' and router's) MLP
    weights and its two norms, the final norm, and the LM head. The input
    embedding is a gather and is not counted; the head is counted whether
    or not it is tied to the embedding."""
    d = conf["hidden_size"]
    h, kh, hd = conf["num_attention_heads"], conf["num_key_value_heads"], head_dim(conf)
    attn = d * h * hd + 2 * d * kh * hd + h * hd * d
    if conf.get("qkv_bias") or conf.get("attention_bias"):
        attn += (h + 2 * kh) * hd
    if conf.get("num_experts"):
        mlp = (conf["num_experts_per_tok"] * 3 * d * conf["moe_intermediate_size"]
               + d * conf["num_experts"])
    else:
        mlp = 3 * d * conf["intermediate_size"]
    block = 2 * d + attn + mlp
    return conf["num_hidden_layers"] * block + d + conf["vocab_size"] * d


def train_flops_per_token(conf: Dict[str, Any], seq: int) -> float:
    """Model FLOPs of one trained token at sequence length ``seq``: 2 per
    active parameter, plus the causal-halved attention products (4 hd
    per query-key pair and head), times 3 for the forward and backward.
    Recomputation is not counted.

    Copied from ``repro_torch.launch.dryrun.analytic_hlo_flops_per_device``
    (``kind="train"``, ``remat=False``, one device, no window), except
    that a tied LM head is counted: that function subtracts the
    embedding's ``V x D`` once, which for a tied embedding also drops the
    head's product."""
    fwd = 2.0 * active_matmul_params(conf)
    per_tok = 4.0 * seq * conf["num_attention_heads"] * head_dim(conf) * 0.5
    fwd += per_tok * conf["num_hidden_layers"]
    return 3.0 * fwd
