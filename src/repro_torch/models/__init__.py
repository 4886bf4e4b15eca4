"""The port's model stack (``repro.models`` counterpart): layers and the
decoder LM, with the caches of serving."""
from repro_torch.models.model import (
    find_period,
    forward,
    init_caches,
    init_params,
    loss_and_grads,
    loss_fn,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    signature,
    softmax_xent,
)

__all__ = [
    "find_period",
    "forward",
    "init_caches",
    "init_params",
    "loss_and_grads",
    "loss_fn",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "signature",
    "softmax_xent",
]
