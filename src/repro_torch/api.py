"""Single-import facade over the port, the counterpart of ``repro.api``.

``repro_torch.api`` re-exports the port's counterpart of every entry
point the JAX package's facade exports, under the same names, so drivers
(``repro_torch.examples.quickstart``, notebooks) depend on one module:

* **RL planning**: :func:`train_sac`, :func:`train_population` (both
  with ``mesh=``), :func:`score_plans`, :func:`make_plan_scorer`,
  :func:`make_split_oracle`.
* **Execution**: :func:`pipeline_step_fn` (the 1F1B executor, in one
  process or one stage per rank of a :func:`make_stage_mesh`),
  :class:`ServingService`.
* **Leakage**: :func:`evaluate_leakage` with :class:`AnalyticLeakage` or
  :class:`EmpiricalLeakage` (the trained attacker population's values,
  :func:`train_empirical_model`).
* **Model stack**: configs, parameters, the train step, data,
  optimizers and checkpoints.
* **Faults**: :class:`FaultSchedule`, :func:`sample_fault_schedule`,
  :func:`degrade_scenario`, consumed by ``ServingService.run(faults=)``
  and the chaos harness (``repro_torch.launch.chaos``).
"""
from __future__ import annotations

from repro_torch.attack import (AttackConfig, capture_weight,
                                train_attacker_population, train_empirical_model)
from repro_torch.checkpoint.store import load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.core.agents.action_space import flat_dim, onehot
from repro_torch.core.agents.loops import train_sac
from repro_torch.core.agents.sac import SACConfig, select_action
from repro_torch.core.channel import NetworkConfig
from repro_torch.core.env import MHSLEnv
from repro_torch.core.faults import (FaultClock, FaultSchedule, degrade_scenario,
                                     fault_free, make_schedule, reference_schedule,
                                     sample_fault_schedule)
from repro_torch.core.leakage import (AnalyticLeakage, EmpiricalLeakage,
                                      LeakageModel, evaluate_leakage,
                                      plan_hop_geometry)
from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
from repro_torch.core.profiles import transformer_profile
from repro_torch.core.scenario import (ScenarioParams, evaluate_population,
                                       train_population)
from repro_torch.core.splitting import make_plan_scorer, score_plans
from repro_torch.data import synthetic_stream
from repro_torch.launch.mesh import make_stage_mesh
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.serving import ServeConfig, ServingService


def make_split_oracle(env: MHSLEnv):
    """Batched exhaustive split-plan scorer for ``env`` (the serving
    re-planner's oracle): ``oracle(p_tx, decoy, positions) -> scores``
    over every (boundaries x devices) candidate; a wrapper over
    :meth:`repro_torch.core.env.MHSLEnv.make_split_oracle`."""
    return env.make_split_oracle()


__all__ = [
    "AnalyticLeakage",
    "AttackConfig",
    "EmpiricalLeakage",
    "FaultClock",
    "FaultSchedule",
    "LeakageModel",
    "MHSLEnv",
    "NetworkConfig",
    "PipelineConfig",
    "SACConfig",
    "ScenarioParams",
    "ServeConfig",
    "ServingService",
    "adamw",
    "capture_weight",
    "degrade_scenario",
    "evaluate_leakage",
    "evaluate_population",
    "fault_free",
    "flat_dim",
    "get_config",
    "init_params",
    "linear_warmup_cosine",
    "load_pytree",
    "make_plan_scorer",
    "make_schedule",
    "make_split_oracle",
    "make_stage_mesh",
    "make_train_step",
    "onehot",
    "pipeline_step_fn",
    "plan_hop_geometry",
    "reference_schedule",
    "sample_fault_schedule",
    "save_pytree",
    "score_plans",
    "select_action",
    "synthetic_stream",
    "train_attacker_population",
    "train_empirical_model",
    "train_population",
    "train_sac",
    "transformer_profile",
]
