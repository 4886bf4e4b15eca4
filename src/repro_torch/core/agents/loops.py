"""Training loops: episode rollout + off-policy updates (Algorithm 1).

Port of ``repro.core.agents.loops`` (``train_sac`` / ``evaluate_sac``)
with the reference's stop/resume checkpoints (``checkpoint_dir``,
``checkpoint_every``, ``resume``) and its population mesh (``mesh``: the
``num_envs`` axis sharded over ranks, ``distribution.population``).
``TrainResult`` and the chunk bookkeeping are shared with the DQN and PPO
baselines (``dqn.train_dqn``, ``ppo.train_ppo``) and with
``scenario.train_population``.
Each chunk (reset, batched rollout of ``num_envs`` episodes, replay
write, ``num_envs * episode_len * updates_per_step`` gradient steps,
metric reduction) is one call of ``rollout.make_train_chunk``; its
reduced metrics come to the host once per chunk.

Tracks the paper's figure metrics: accumulated reward per episode (Figs.
3-4), information leaked (Figs. 5-6), and distinct states explored (Fig.
7, packed key of the discretized observation).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import train_state as TS
from repro_torch.core.agents import action_space as A
from repro_torch.core.agents import rollout as R
from repro_torch.core.agents import sac as SAC
from repro_torch.core.env import MHSLEnv
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.distribution import collectives as C
from repro_torch.distribution import population as PD


@dataclass
class TrainResult:
    episode_reward: list = field(default_factory=list)
    episode_leak: list = field(default_factory=list)
    episode_violation: list = field(default_factory=list)
    states_explored: list = field(default_factory=list)  # cumulative distinct
    metrics: list = field(default_factory=list)
    # host seconds per chunk (each ends in the chunk's metric transfer,
    # which waits for the device) and whether the chunk updated
    chunk_seconds: list = field(default_factory=list)
    chunk_updated: list = field(default_factory=list)
    params: Optional[dict] = None


# transition fields persisted to the SAC replay buffer
SAC_FIELDS = ("obs", "obs_next", "hist", "hist_mask", "action", "masks",
              "reward", "done")


def sac_example(env: MHSLEnv, cfg: SAC.SACConfig) -> Dict:
    """Single-transition tree defining the replay buffer layout."""
    adims = env.action_dims
    pair_dim = env.obs_dim + A.flat_dim(adims)
    d = env.device

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=d)

    i32, b = torch.int32, torch.bool
    return dict(
        obs=z((env.obs_dim,)),
        obs_next=z((env.obs_dim,)),
        hist=z((cfg.hist_len, pair_dim)),
        hist_mask=z((cfg.hist_len,)),
        action={"u": z((), i32), "size": z((), i32),
                "decoys": z((adims["decoys"],), i32),
                "p_tx": z((), i32), "p_d": z((), i32)},
        masks={k: z((adims[k],), b) for k in ("u", "size", "decoys", "p_tx", "p_d")},
        reward=z(()),
        done=z(()),
    )


def combine_key_lanes(packed: np.ndarray) -> np.ndarray:
    """(..., 2) uint32 key lanes -> (...,) uint64 keys ``(hi << 32) | lo``."""
    p = np.asarray(packed).astype(np.uint64)
    return (p[..., 0] << np.uint64(32)) | p[..., 1]


CHUNK_FIELDS = ("reward", "leak", "viol", "obs_keys")


def _chunk_metrics(result: TrainResult, seen: set, m, ep: int, episodes: int,
                   num_envs: int) -> None:
    """The chunk's one device->host transfer, then per-episode bookkeeping."""
    host_chunk_metrics(result, seen, {k: m[k].cpu().numpy() for k in CHUNK_FIELDS},
                       m["update"] if m["did_update"] else None, ep, episodes,
                       num_envs)


def host_chunk_metrics(result: TrainResult, seen: set, host, update, ep: int,
                       episodes: int, num_envs: int) -> None:
    """Per-episode bookkeeping of a chunk from its :data:`CHUNK_FIELDS`
    on the host; ``update`` is the chunk's dict of update metric means,
    or ``None`` where it did not update."""
    keys = combine_key_lanes(host["obs_keys"])  # (num_envs, T)
    for i in range(num_envs):
        if ep + i >= episodes:
            break
        seen.update(int(k) for k in np.unique(keys[i]))
        result.episode_reward.append(float(host["reward"][i]))
        result.episode_leak.append(float(host["leak"][i]))
        result.episode_violation.append(float(host["viol"][i]))
        result.states_explored.append(len(seen))
    if update is not None:
        result.metrics.append({k: float(v) for k, v in update.items()})


def traj_chunk_metrics(result: TrainResult, seen: set, traj, update, ep: int,
                       episodes: int, num_envs: int) -> None:
    """The bookkeeping of :func:`_chunk_metrics` from a raw ``(num_envs, T,
    ...)`` trajectory (the DQN and PPO loops), reduced on the device as
    the SAC chunk's metrics are. ``update`` is the chunk's dict of update
    metric means, or ``None`` where the chunk did not update."""
    m = dict(R.reduce_traj(traj), update=update, did_update=update is not None)
    _chunk_metrics(result, seen, m, ep, episodes, num_envs)


def check_run(env: MHSLEnv, num_envs: int, device: DeviceLike, who: str):
    """A trainer's arguments: at least one env, and ``device``, when
    given, naming the env's device."""
    if num_envs < 1:
        raise ValueError(f"num_envs must be >= 1, got {num_envs}")
    if device is not None and resolve_device(device) != env.device:
        raise ValueError(f"{who} on {device} needs an env on that device; "
                         f"the env is on {env.device}")


def check_mesh(env: MHSLEnv, mesh, who: str) -> None:
    """A trainer's ``mesh``: this rank inside it, on the env's device."""
    if mesh is None:
        return
    mesh.axis_index(mesh.axis_names[0])  # raises outside the mesh
    if not same_device(mesh.device, env.device):
        raise ValueError(f"{who}: the mesh places this rank on {mesh.device}, "
                         f"the env is on {env.device}")


def save_on_mesh(mesh, save, *args) -> None:
    """``save(*args)`` on the mesh's rank 0 (the state is whole on every
    rank), then a barrier so that no rank goes on before the files are
    complete. ``mesh=None``: just ``save``."""
    if mesh is None or mesh.rank == 0:
        save(*args)
    if mesh is not None:
        C.barrier(mesh)


CURVES = ("episode_reward", "episode_leak", "episode_violation",
          "states_explored")


def curves_state(result: TrainResult) -> Dict:
    """A result's four per-episode curves, for a checkpoint's host state."""
    return {k: getattr(result, k) for k in CURVES}


def restore_curves(result: TrainResult, saved: Dict) -> None:
    for k in CURVES:
        setattr(result, k, list(saved[k]))


def save_due(checkpoint_dir, checkpoint_every: int, ep: int, last_saved) -> bool:
    """Whether a chunk boundary at ``ep`` saves: the first boundary of a
    run, then every ``checkpoint_every`` episodes (the reference's rule)."""
    return bool(checkpoint_dir and checkpoint_every
                and (last_saved is None or ep - last_saved >= checkpoint_every))


def resumable(checkpoint_dir, resume: bool) -> bool:
    return bool(checkpoint_dir and resume
                and TS.latest_checkpoint_step(checkpoint_dir) is not None)


def train_sac(env: MHSLEnv, cfg: SAC.SACConfig, episodes: int = 200,
              seed: int = 0, warmup_episodes: int = 10,
              resample_positions: bool = False, num_envs: int = 1,
              scenario=None, device: DeviceLike = None, mesh=None,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
              resume: bool = True) -> TrainResult:
    """ICM-CA SAC training on the batched engine.

    Runs on ``env.device``; ``device``, when given, must name the same
    device (``cuda`` is the default of both). ``scenario`` overrides the
    env's default physics. ``num_envs`` envs roll out together; each
    chunk then takes ``num_envs * episode_len * updates_per_step``
    gradient steps. Warmup rounds up to chunk granularity: updates start
    with the first chunk that begins at or past ``warmup_episodes``. If
    ``episodes`` is not a multiple of ``num_envs`` the last chunk still
    trains on the whole population but only the first ``episodes``
    entries are reported. Without ``resample_positions`` every env of
    every chunk replays one geometry drawn at the start.

    Randomness: weights come from a CPU generator seeded with ``seed``;
    positions, actions, leakage draws and replay indices from a generator
    on the device seeded with ``seed + 1``.

    ``mesh`` (``launch.mesh.make_population_mesh``) shards the
    ``num_envs`` axis of positions, env states and rollouts over its
    population axes (``distribution.sharding.population_axes``; a
    population that does not divide is replicated). Every rank holds the
    same generators: each whole-population draw is made in full and each
    rank keeps its rows, so the streams are the unsharded run's. After
    the rollout the transitions are all-gathered in env order into a
    replay buffer every rank holds whole, and every rank runs the same
    updates on the same replay indices: agent parameters and optimizer
    state stay replicated, and every rank returns the whole result. (The
    reference shards its buffer along the capacity instead.) A 1-rank
    mesh is bit for bit ``mesh=None``.

    ``checkpoint_dir`` and ``checkpoint_every`` save the whole loop state
    at chunk boundaries every ``checkpoint_every`` episodes, and once at
    the end: params, optimizer state, replay storage, both generators'
    states and, without ``resample_positions``, the fixed positions (the
    ``.npz``); the episode counter, the four curves, the explored-state
    set and the replay ring's pointers (the ``.json``). With ``resume``
    (the default) the newest checkpoint in the directory is restored and
    training goes on from its episode; the resumed run is bit-identical
    to an uninterrupted one. A checkpoint of another run (seed, envs,
    warmup, resampling, ``cfg`` or ``scenario`` differ) is refused. On a
    mesh, rank 0 writes the checkpoint (the state is whole on every rank)
    and every rank reads it on resume; the mesh is not part of the run's
    fingerprint, so a run may resume on another mesh.
    """
    check_run(env, num_envs, device, "train_sac")
    check_mesh(env, mesh, "train_sac")
    adims = env.action_dims
    init_gen = torch.Generator().manual_seed(seed)
    params = SAC.init_agent(init_gen, env.obs_dim, adims, cfg, device=env.device)
    update, init_opt = SAC.make_update(adims, cfg)
    opt_state = init_opt(params)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)

    buf = R.buffer_init(cfg.buffer_size, sac_example(env, cfg))
    n_updates = cfg.updates_per_step * env.episode_len * num_envs
    chunk = R.make_train_chunk(
        env, R.uniform_policy(adims), R.sac_policy(adims, cfg), update,
        hist_len=cfg.hist_len, fields=SAC_FIELDS, batch_size=cfg.batch,
        n_updates=n_updates,
        gather=None if mesh is None else (
            lambda traj: PD.gather_population(traj, mesh, num_envs)),
    )
    # this rank's rows of every rollout draw (the generator itself when
    # there is no mesh)
    roll_gen = gen if mesh is None else PD.PopulationGenerator(
        gen, num_envs, PD.population_rows(mesh, num_envs))

    positions = R.make_positions(env, gen, num_envs, resample_positions,
                                 scenario)
    result = TrainResult()
    seen: set = set()
    meta = dict(seed=seed, num_envs=num_envs, warmup_episodes=warmup_episodes,
                resample_positions=resample_positions, cfg=repr(cfg),
                scenario=TS.pytree_fingerprint(scenario))

    def device_state():
        state = dict(params=params, opt_state=opt_state, buf=buf.data,
                     gen=TS.generator_leaf(gen),
                     init_gen=TS.generator_leaf(init_gen))
        if not resample_positions:  # the one geometry every env replays
            state["positions"] = tuple(x[:1] for x in positions())
        return state

    def save(ep_now: int) -> None:
        save_on_mesh(mesh, TS.save_train_checkpoint,
                     checkpoint_dir, ep_now, device_state(),
                     dict(ep=ep_now, meta=meta, **curves_state(result),
                          seen=sorted(seen), buf_ptr=buf.ptr, buf_size=buf.size))

    ep = 0
    last_saved = None
    if resumable(checkpoint_dir, resume):
        _, dev, host = TS.load_train_checkpoint(checkpoint_dir, device_state())
        ep = last_saved = TS.validate_resume(host, meta, episodes, checkpoint_dir)
        params, opt_state = dev["params"], dev["opt_state"]
        buf = R.BufferState(data=dev["buf"], ptr=host["buf_ptr"],
                            size=host["buf_size"])
        TS.restore_generator(gen, dev["gen"])
        TS.restore_generator(init_gen, dev["init_gen"])
        if not resample_positions:
            fixed = tuple(x.expand(num_envs, -1, -1) for x in dev["positions"])
            positions = lambda: fixed  # noqa: E731
        restore_curves(result, host)
        seen = set(host["seen"])
        if mesh is not None:  # every rank has read before any writes again
            C.barrier(mesh)

    while ep < episodes:
        if save_due(checkpoint_dir, checkpoint_every, ep, last_saved):
            save(ep)
            last_saved = ep
        t0 = time.perf_counter()
        params, opt_state, metrics = chunk(
            params, opt_state, buf,
            PD.shard_population(positions(), mesh, num_envs), roll_gen,
            ep >= warmup_episodes, scenario, update_gen=gen)
        _chunk_metrics(result, seen, metrics, ep, episodes, num_envs)
        result.chunk_seconds.append(time.perf_counter() - t0)
        result.chunk_updated.append(metrics["did_update"])
        ep += num_envs
    if checkpoint_dir and last_saved != ep:
        save(ep)

    result.params = params
    return result


@torch.no_grad()
def evaluate_sac(env: MHSLEnv, params, cfg: SAC.SACConfig, episodes: int = 20,
                 seed: int = 1000, scenario=None) -> Dict[str, float]:
    """Policy evaluation: all ``episodes`` run as one batched population,
    each with a fresh geometry. Returns mean reward and leak per episode."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    st0 = env.reset(env.sample_positions(gen, episodes, scenario), scenario)
    _, traj = R.rollout_episode(env, R.sac_policy(env.action_dims, cfg),
                                params, st0, gen, cfg.hist_len, scenario)
    return {
        "reward": float(traj["reward"].sum()) / episodes,
        "leak": float(traj["leak"].sum()) / episodes,
    }
