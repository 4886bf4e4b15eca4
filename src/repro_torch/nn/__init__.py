from repro_torch.nn.layers import (
    dense_apply,
    gru_apply,
    init_dense,
    init_gru,
    init_layernorm,
    init_mlp,
    init_residual_mlp,
    layernorm_apply,
    mlp_apply,
    residual_mlp_apply,
)

__all__ = [
    "init_dense",
    "dense_apply",
    "init_mlp",
    "mlp_apply",
    "init_layernorm",
    "layernorm_apply",
    "init_gru",
    "gru_apply",
    "init_residual_mlp",
    "residual_mlp_apply",
]
