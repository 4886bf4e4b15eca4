"""The port's model stack (``repro.models`` counterpart): layers and the
decoder LM, cache-free."""
from repro_torch.models.model import (
    find_period,
    forward,
    init_params,
    loss_and_grads,
    loss_fn,
    make_train_step,
    signature,
    softmax_xent,
)

__all__ = [
    "find_period",
    "forward",
    "init_params",
    "loss_and_grads",
    "loss_fn",
    "make_train_step",
    "signature",
    "softmax_xent",
]
