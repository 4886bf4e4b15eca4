from repro_torch.optim.optimizers import (
    OptState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    sgd_momentum,
)

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "linear_warmup_cosine", "sgd_momentum"]
