"""Runnable examples of the port that import only through
:mod:`repro_torch.api`."""
