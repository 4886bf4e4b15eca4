"""PyTorch/CUDA port of the MHSL split-learning reproduction.

Mirrors the layout of the JAX package ``repro`` (``core/``,
``core/agents/``, ``nn/``, ``optim/``, ``kernels/``) so the counterpart
of each module is found under the same path. The port imports ``torch``
and ``numpy`` only. Its entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
