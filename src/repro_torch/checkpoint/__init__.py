"""Checkpoints of the port: trees of tensors in one ``.npz``
(:mod:`.store`) and the stop/resume state of the trainers
(:mod:`.train_state`)."""
