from repro_torch.optim.optimizers import OptState, adamw, apply_updates

__all__ = ["OptState", "adamw", "apply_updates"]
