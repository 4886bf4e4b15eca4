"""Batched rollout engine for the MHSL SAC agent, PyTorch port.

Port of ``repro.core.agents.rollout``. Where the JAX engine ``vmap``s one
env and ``lax.scan``s over the episode, the port steps the whole env
population at once (every tensor carries the env axis first) in a Python
loop over the ``2S-1`` steps; the ``lax.cond`` gates of the fused train
chunk become plain ``if``s on host integers.

* ``BufferState`` + ``buffer_init``/``buffer_add``/``buffer_gather`` - a
  replay ring of device tensors. ``buffer_add`` writes in place (the
  reference donates the storage to the same effect); the write pointer
  and fill count are host integers, so reading them never syncs.
* Policies share one signature, so SAC, DQN and PPO plug into the same
  engine::

      policy(params, gen, obs, hist, hist_mask, masks) -> (action, extras)

  with ``gen`` the ``torch.Generator`` of the action draw and ``extras``
  a dict of further per-step fields recorded into the trajectory (PPO's
  ``logp``/``v``, DQN's flat action index and mask).
* ``rollout_episode`` - one batched episode; ``make_train_chunk`` - reset
  -> rollout -> buffer write -> ``n_updates`` gradient steps -> metric
  reduction, with one host sync per chunk.
* ``make_fused_update`` - ``n_updates`` off-policy gradient steps on
  replay rows drawn at once; ``make_scan_updates`` - ``n`` epochs over
  one fixed batch (PPO); both report per-metric means. ``gae`` -
  generalized advantage estimation over the episode axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.agents import action_space as A
from repro_torch.core.env import EnvState, MHSLEnv
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Policy = Callable[..., Tuple[Dict[str, Tensor], Dict[str, Tensor]]]


# ---------------------------------------------------------------------------
# replay buffer: tree of (capacity, ...) tensors + ring pointer
# ---------------------------------------------------------------------------


@dataclass
class BufferState:
    """Replay storage (circular, fixed capacity), written in place."""

    data: Any  # tree; each leaf (capacity, ...)
    ptr: int = 0  # next write slot
    size: int = 0  # filled slots

    @property
    def capacity(self) -> int:
        return tree_leaves(self.data)[0].shape[0]


def buffer_init(capacity: int, example: Any) -> BufferState:
    """Allocate storage from a single-transition example tree."""
    return BufferState(data=tree_map(
        lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), example))


def buffer_add(state: BufferState, batch: Any) -> BufferState:
    """Ring-write a batch of transitions (leaves shaped (B, ...)) in place.

    As in the reference, a batch larger than the capacity keeps only its
    last ``capacity`` rows, so the scatter indices stay unique."""
    capacity = state.capacity
    n_total = tree_leaves(batch)[0].shape[0]
    drop = max(n_total - capacity, 0)
    n = n_total - drop
    dev = tree_leaves(state.data)[0].device
    idx = (state.ptr + drop + torch.arange(n, device=dev)) % capacity

    def write(d, b):
        d[idx] = b[drop:].to(d.dtype)

    tree_map(write, state.data, batch)
    state.ptr = (state.ptr + n_total) % capacity
    state.size = min(state.size + n_total, capacity)
    return state


def buffer_gather(state: BufferState, idx: Tensor) -> Any:
    """Gather transitions at ``idx`` (any leading shape) from the buffer."""
    return tree_map(lambda d: d[idx], state.data)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


def uniform_policy(action_dims: Dict[str, int]) -> Policy:
    """Masked-uniform exploration policy (the warmup behaviour)."""

    def policy(params, gen, obs, hist, hist_mask, masks):
        n = obs.shape[0]
        logits = {
            "u": torch.where(masks["u"], 0.0, A.NEG),
            "size": torch.where(masks["size"], 0.0, A.NEG),
            "decoys": torch.stack(
                [torch.zeros(masks["decoys"].shape, device=obs.device),
                 torch.where(masks["decoys"], 0.0, A.NEG)], -1),
            "p_tx": torch.zeros((n, action_dims["p_tx"]), device=obs.device),
            "p_d": torch.zeros((n, action_dims["p_d"]), device=obs.device),
        }
        return A.sample(logits, A.gumbel_like(logits, gen)), {}

    return policy


def sac_policy(action_dims: Dict[str, int], cfg) -> Policy:
    """Stochastic ICM-CA SAC actor."""
    from repro_torch.core.agents import sac as SAC  # local import: avoid cycle

    def policy(params, gen, obs, hist, hist_mask, masks):
        logits = SAC.actor_logits(params, obs, hist, hist_mask, masks,
                                  action_dims, cfg)
        return A.sample(logits, A.gumbel_like(logits, gen)), {}

    return policy


# ---------------------------------------------------------------------------
# batched episode rollout
# ---------------------------------------------------------------------------


@torch.no_grad()
def rollout_episode(env: MHSLEnv, policy: Policy, params, st0: EnvState,
                    gen: torch.Generator, hist_len: int, scenario=None
                    ) -> Tuple[EnvState, Dict[str, Any]]:
    """One full ``2S-1``-step episode of the whole population ``st0``.

    Returns ``(final_state, traj)`` with traj leaves shaped
    ``(num_envs, T, ...)``: obs / obs_next / hist / hist_mask / action /
    masks / reward / done plus ``leak``/``viol`` diagnostics and the
    policy's ``extras``. Each step draws the policy's noise, then the
    env's leakage draw, from ``gen``.
    """
    sp = env.scenario() if scenario is None else scenario
    adims = env.action_dims
    n_env = st0.n.shape[0]
    pair_dim = env.obs_dim + A.flat_dim(adims)
    hist = torch.zeros((n_env, hist_len, pair_dim), device=env.device)
    hmask = torch.zeros((n_env, hist_len), device=env.device)
    st = st0
    steps = []
    obs = env.observe(st, sp)
    for _ in range(env.episode_len):
        masks = env.action_masks(st)
        action, extras = policy(params, gen, obs, hist, hmask, masks)
        st2, reward, done, info = env.step(st, action, env.draw(gen, n_env), sp)
        obs2 = env.observe(st2, sp)
        pair = torch.cat([obs, A.onehot(action, adims)], dim=-1)
        steps.append(dict(
            obs=obs, obs_next=obs2, hist=hist, hist_mask=hmask,
            action=action, masks=masks, reward=reward,
            done=done.float(), leak=info["leak"],
            viol=((st2.e_r <= 0) | (st2.t_r <= 0)).float(), **extras,
        ))
        hist = torch.cat([hist[:, 1:], pair[:, None]], dim=1)
        hmask = torch.cat([hmask[:, 1:], torch.ones_like(hmask[:, :1])], dim=1)
        st, obs = st2, obs2
    traj = tree_map(lambda *xs: torch.stack(xs, dim=1), steps[0], *steps[1:])
    return st, traj


# ---------------------------------------------------------------------------
# fused train chunk: reset -> rollout -> buffer add -> updates -> metrics
# ---------------------------------------------------------------------------

# Discretization bin width for the Fig. 7 distinct-state counter.
OBS_BINS = 4.0

# Two FNV-1a style 32-bit mixes with different offset bases; together an
# effectively-64-bit state key, bit-equal to the reference's uint32 lanes.
_KEY_PRIME = 16777619
_KEY_BASIS_HI = 0x811C9DC5
_KEY_BASIS_LO = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def pack_obs_keys(obs: Tensor, bins: float = OBS_BINS) -> Tensor:
    """Pack discretized observations into per-row state keys on device.

    ``obs`` (..., D) float -> (..., 2) int64 holding two uint32 lanes: each
    row is binned with ``round(obs * bins)`` and mixed column by column
    into two independent 32-bit FNV lanes. torch has no full uint32
    arithmetic on CUDA, so the lanes are computed in int64 and masked to
    32 bits after every step (the product of two 32-bit values stays
    below 2^57), which reproduces the reference's wrapping uint32
    multiplies bit for bit.
    """
    q = torch.round(obs * bins).to(torch.int32).to(torch.int64) & _MASK32

    def mix(basis: int) -> Tensor:
        h = torch.full(q.shape[:-1], basis, dtype=torch.int64, device=q.device)
        for d in range(q.shape[-1]):
            h = ((h ^ q[..., d]) * _KEY_PRIME) & _MASK32
        return h

    return torch.stack([mix(_KEY_BASIS_HI), mix(_KEY_BASIS_LO)], dim=-1)


def flatten_transitions(traj: Any, keys: Tuple[str, ...]) -> Any:
    """Select ``keys`` from a (num_envs, T, ...) trajectory and flatten the
    leading two axes into one transition batch of num_envs * T rows."""
    return tree_map(lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]),
                    {k: traj[k] for k in keys})


def reduce_traj(traj) -> Dict[str, Tensor]:
    """A chunk's metrics, reduced on the device: per-episode
    ``reward``/``leak``/``viol`` sums ``(num_envs,)`` and the packed state
    keys ``obs_keys`` ``(num_envs, T, 2)``."""
    return {
        "reward": traj["reward"].sum(1),
        "leak": traj["leak"].sum(1),
        "viol": traj["viol"].sum(1),
        "obs_keys": pack_obs_keys(traj["obs"]),
    }


def make_positions(env: MHSLEnv, gen: torch.Generator, num_envs: int,
                   resample: bool, scenario=None):
    """Per-chunk reset positions, ``positions() -> (dev, eav)``. With
    ``resample`` each call draws a fresh geometry for every env;
    otherwise one geometry is drawn now and every env of every chunk
    replays it (the reference's ``episode_reset_keys``)."""
    if resample:
        return lambda: env.sample_positions(gen, num_envs, scenario)
    dev, eav = env.sample_positions(gen, 1, scenario)
    fixed = (dev.expand(num_envs, -1, -1), eav.expand(num_envs, -1, -1))
    return lambda: fixed


def metric_means(ms):
    """Per-metric mean over a list of update metrics (a tree of scalars
    each)."""
    return tree_map(lambda *xs: torch.stack(xs).mean(0), ms[0], *ms[1:])


def make_fused_update(update_fn, batch_size: int, n_updates: int):
    """``n_updates`` off-policy gradient steps on replay rows.

    ``update_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``. Returns ``fused(params, opt_state, buf, gen)`` -> the same
    triple with each metric averaged over the steps. The replay indices of
    all steps are drawn at once from ``gen``, ``(n_updates, batch_size)``
    uniform over the filled slots, as the reference does."""

    def fused(params, opt_state, buf: BufferState, gen: torch.Generator):
        dev = tree_leaves(buf.data)[0].device
        idx = torch.randint(0, max(buf.size, 1), (n_updates, batch_size),
                            generator=gen, device=dev)
        ms = []
        for row in idx:
            params, opt_state, m = update_fn(params, opt_state,
                                             buffer_gather(buf, row))
            ms.append(m)
        return params, opt_state, metric_means(ms)

    return fused


def make_scan_updates(update_fn, n: int):
    """``n`` update epochs over one fixed batch (the on-policy analogue of
    :func:`make_fused_update`): ``run(params, opt_state, batch)`` -> the
    same triple with each metric averaged over the epochs."""

    def run(params, opt_state, batch):
        ms = []
        for _ in range(n):
            params, opt_state, m = update_fn(params, opt_state, batch)
            ms.append(m)
        return params, opt_state, metric_means(ms)

    return run


def gae(rewards: Tensor, values: Tensor, gamma: float, lam: float):
    """Generalized advantage estimation along the last (episode) axis.

    ``rewards``/``values``: (..., T). The terminal bootstrap value is 0
    (MHSL episodes always end at ``2S-1``). Returns (advantages,
    returns)."""
    v_next = torch.cat([values[..., 1:], torch.zeros_like(values[..., :1])],
                       dim=-1)
    delta = rewards + gamma * v_next - values
    g = torch.zeros_like(values[..., 0])
    adv = []
    for t in range(values.shape[-1] - 1, -1, -1):
        g = delta[..., t] + gamma * lam * g
        adv.append(g)
    adv = torch.stack(adv[::-1], dim=-1)
    return adv, adv + values


def make_train_chunk(env: MHSLEnv, explore_policy: Policy, train_policy: Policy,
                     update_fn, *, hist_len: int, fields: Tuple[str, ...],
                     batch_size: int, n_updates: int, gather=None):
    """One training chunk: reset -> batched episode rollout (explore or
    train policy) -> ring-buffer write -> ``n_updates`` gradient steps
    (only when ``train`` and the buffer holds ``batch_size`` rows) ->
    metric reduction.

    Returns ``chunk(params, opt_state, buf, positions, gen, train,
    scenario=None, update_gen=None) -> (params, opt_state, metrics)``;
    ``buf`` is written in place. ``positions`` are the per-env ``(dev,
    eav)`` reset positions. The rollout draws from ``gen``, and so do the
    replay indices unless ``update_gen`` is given (a population shares
    its rollout draws across scenarios but not its replay indices).
    ``metrics`` stay on the device::

        {"reward"|"leak"|"viol": (num_envs,) episode sums,
         "obs_keys": (num_envs, T, 2) packed state keys,
         "update": per-metric means over the update steps (or None),
         "did_update": bool}

    The updates are :func:`make_fused_update`'s. ``gather``, when given,
    maps the rollout's trajectory, this rank's rows of the population,
    to the whole population's before the replay write and the metrics
    (``train_sac`` on a population mesh).
    """
    fused = make_fused_update(update_fn, batch_size, n_updates)

    def chunk(params, opt_state, buf: BufferState, positions, gen, train: bool,
              scenario=None, update_gen=None):
        st0 = env.reset(positions, scenario)
        policy = train_policy if train else explore_policy
        _, traj = rollout_episode(env, policy, params, st0, gen, hist_len,
                                  scenario)
        if gather is not None:
            traj = gather(traj)
        buffer_add(buf, flatten_transitions(traj, fields))

        upd = None
        did_update = bool(train) and buf.size >= batch_size
        if did_update:
            params, opt_state, upd = fused(
                params, opt_state, buf, gen if update_gen is None else update_gen)
        metrics = dict(reduce_traj(traj), update=upd, did_update=did_update)
        return params, opt_state, metrics

    return chunk
