"""Carry parameters and AdamW state between the JAX package and the port.

Both sides keep the same tree layout (nested dicts and lists, ``x @ w + b``
with ``w`` of shape ``(d_in, d_out)``), so a conversion is a leafwise copy.
The JAX side is handed over as numpy arrays (``jax.tree.map(np.asarray,
tree)``); this module imports neither JAX nor the JAX package. Every
leaf keeps its dtype: a bf16 model keeps its f32 leaves (a Mamba block's
``a_log``, ``dt_bias`` and ``d_skip``, an MoE router) in f32. bf16 leaves
come as numpy's ``bfloat16`` extension dtype and are carried exactly;
numpy has no bf16 of its own, so the way back gives them as f32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import OptState
from repro_torch.tree import tree_index, tree_leaves, tree_map, tree_stack


def _to_torch(x, dev):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # exact: bf16 -> f32 -> bf16
        return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(arr.copy()).to(dev)


def _to_numpy(x):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def sac_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX SAC params (as numpy arrays) -> the port's params on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_torch(x, dev), np_tree)


def sac_params_to_numpy(params: Any):
    """The port's params -> numpy arrays in the same tree layout."""
    return tree_map(_to_numpy, params)


def sac_opt_state_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX ``{actor, critic, icm}`` AdamW states (numpy leaves; each an
    ``OptState(step, mu, nu)`` or ``()``) -> the port's."""
    dev = resolve_device(device)
    return {
        name: (OptState(step=_to_torch(st.step, dev).to(torch.int32),
                        mu=sac_params_from_jax(st.mu, dev),
                        nu=sac_params_from_jax(st.nu, dev))
               if len(st) else ())
        for name, st in np_tree.items()
    }


def sac_opt_state_to_numpy(opt_state: Any):
    """The port's AdamW states -> numpy ``(step, mu, nu)`` triples."""
    return {
        name: (OptState(step=st.step.cpu().numpy(),
                        mu=sac_params_to_numpy(st.mu),
                        nu=sac_params_to_numpy(st.nu)) if len(st) else ())
        for name, st in opt_state.items()
    }


def dqn_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX DQN Q-net params (an ``init_mlp`` tree of numpy arrays) -> the
    port's on ``device``."""
    return sac_params_from_jax(np_tree, device)


def dqn_params_to_numpy(params: Any):
    """The port's DQN Q-net params -> numpy arrays in the same layout."""
    return sac_params_to_numpy(params)


def ppo_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX PPO params (``{actor, critic}`` MLP trees of numpy arrays) ->
    the port's on ``device``."""
    return sac_params_from_jax(np_tree, device)


def ppo_params_to_numpy(params: Any):
    """The port's PPO params -> numpy arrays in the same layout."""
    return sac_params_to_numpy(params)


def model_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX model params (``repro.models.init_params`` layout, numpy leaves)
    -> the port's params on ``device``: the same tree, leaf for leaf, for
    every block kind (attention, Mamba, dense MLP, MoE), each slot of
    the period and a modality frontend's projector."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_torch(x, dev), np_tree)


def model_params_to_numpy(params: Any):
    """The port's model params -> numpy arrays in the same tree layout
    (bf16 leaves as f32)."""
    return tree_map(_to_numpy, params)


def model_opt_state_from_jax(np_state: Any, device: DeviceLike = None):
    """A JAX AdamW ``OptState(step, mu, nu)`` over model params (numpy
    leaves) -> the port's."""
    dev = resolve_device(device)
    return OptState(step=_to_torch(np_state.step, dev).to(torch.int32),
                    mu=model_params_from_jax(np_state.mu, dev),
                    nu=model_params_from_jax(np_state.nu, dev))


def model_opt_state_to_numpy(opt_state: Any):
    """The port's AdamW state over model params -> numpy ``(step, mu, nu)``."""
    return OptState(step=opt_state.step.cpu().numpy(),
                    mu=model_params_to_numpy(opt_state.mu),
                    nu=model_params_to_numpy(opt_state.nu))


def population_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """The stacked params of a JAX population (``train_population``; every
    leaf with a leading scenario axis, numpy leaves) -> the port's stacked
    params, scenario by scenario through :func:`sac_params_from_jax`."""
    n = len(tree_leaves(np_tree)[0])
    return tree_stack([sac_params_from_jax(tree_map(lambda x: x[s], np_tree), device)
                       for s in range(n)])


def population_params_to_numpy(params: Any):
    """The port's stacked population params -> numpy arrays, stacked."""
    n = tree_leaves(params)[0].shape[0]
    return tree_map(lambda *xs: np.stack(xs),
                    *[sac_params_to_numpy(tree_index(params, s)) for s in range(n)])


def population_opt_state_from_jax(np_tree: Any, device: DeviceLike = None):
    """A JAX population's stacked ``{actor, critic, icm}`` AdamW states
    (leading scenario axis) -> the port's, stacked, through
    :func:`sac_opt_state_from_jax`."""
    n = len(tree_leaves(np_tree)[0])
    return tree_stack([sac_opt_state_from_jax(tree_map(lambda x: x[s], np_tree), device)
                       for s in range(n)])


def population_opt_state_to_numpy(opt_state: Any):
    """The port's stacked population AdamW states -> numpy, stacked."""
    n = tree_leaves(opt_state)[0].shape[0]
    return tree_map(lambda *xs: np.stack(xs),
                    *[sac_opt_state_to_numpy(tree_index(opt_state, s))
                      for s in range(n)])


def attacker_params_from_jax(np_tree: Any, device: DeviceLike = None):
    """JAX attacker params (``repro.attack.init_attacker`` layout, numpy
    leaves; one attacker, or a population stacked on a leading axis) ->
    the port's on ``device``."""
    return sac_params_from_jax(np_tree, device)


def attacker_params_to_numpy(params: Any):
    """The port's attacker params (one or stacked) -> numpy arrays."""
    return sac_params_to_numpy(params)


def attacker_opt_state_from_jax(np_state: Any, device: DeviceLike = None):
    """JAX ``(attacker, discriminator)`` AdamW states (numpy leaves) -> the
    port's. A stacked population's step counts, (N,) and equal because
    its attackers train in lockstep, become the port's one scalar step."""
    dev = resolve_device(device)
    out = []
    for st in np_state:
        step = np.asarray(st.step)
        if step.ndim:
            if not (step == step.flat[0]).all():
                raise ValueError(f"attackers at different steps {step.tolist()}")
            step = step.flat[0]
        out.append(OptState(step=torch.as_tensor(step, dtype=torch.int32, device=dev),
                            mu=sac_params_from_jax(st.mu, dev),
                            nu=sac_params_from_jax(st.nu, dev)))
    return tuple(out)


def attacker_opt_state_to_numpy(opt_state: Any, population: int = 0):
    """The port's ``(attacker, discriminator)`` AdamW states -> numpy
    ``(step, mu, nu)``; with ``population`` N the step is repeated to
    (N,), as a stacked JAX population holds it."""
    def step(st):
        s = st.step.cpu().numpy()
        return np.full((population,), s, s.dtype) if population else s

    return tuple(OptState(step=step(st), mu=sac_params_to_numpy(st.mu),
                          nu=sac_params_to_numpy(st.nu)) for st in opt_state)
