"""Learned attacker-in-the-loop leakage evaluation (port of
``repro.attack``).

A trainable FSHA-style reconstruction adversary (encoder / decoder /
discriminator, alternating step) measures how much an eavesdropper
learns from the smashed activations crossing each split boundary: the
empirical counterpart of the paper's analytic Eq. 30 model, surfaced
through :class:`repro_torch.core.leakage.EmpiricalLeakage`.
"""
from repro_torch.attack.fsha import (
    AttackConfig,
    AttackDraws,
    attack_scores,
    draw_attack,
    flatten_rows,
    init_attack_state,
    init_attacker,
    make_attack_chunk,
    reconstruct,
    smashed_activations,
)
from repro_torch.attack.population import (
    AttackResult,
    capture_weight,
    empirical_model_from,
    init_attacker_population,
    make_activation_scorer,
    make_population_attack_chunk,
    tiny_attack_model_cfg,
    train_attacker_population,
    train_attacker_populations,
    train_empirical_model,
)

__all__ = [
    "AttackConfig",
    "AttackDraws",
    "AttackResult",
    "attack_scores",
    "capture_weight",
    "draw_attack",
    "empirical_model_from",
    "flatten_rows",
    "init_attack_state",
    "init_attacker",
    "init_attacker_population",
    "make_activation_scorer",
    "make_attack_chunk",
    "make_population_attack_chunk",
    "reconstruct",
    "smashed_activations",
    "tiny_attack_model_cfg",
    "train_attacker_population",
    "train_attacker_populations",
    "train_empirical_model",
]
