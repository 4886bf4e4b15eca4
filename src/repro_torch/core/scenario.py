"""Scenario parameters as a runtime value, and scenario sweeps.

Port of ``repro.core.scenario``: the env's static structure (U devices,
E_max eavesdroppers, S stages, number of power levels) stays on
``MHSLEnv`` and fixes every tensor shape; the dynamic physics lives in
``ScenarioParams``, a NamedTuple of f32 tensors passed as an argument
through ``channel -> leakage -> env -> rollout -> trainers``.

A sweep is a stacked ``ScenarioParams`` (leading axis N, from
:func:`scenario_grid` and :func:`stack_scenarios`). The population
rollout and evaluator run its scenarios in turn, each replaying the same
episode draws: one ``torch.Generator`` re-seeded with the same seed per
scenario. They take one agent for all scenarios, or with
``share_params=False`` a stacked one per scenario (leading axis N), as
:func:`train_population` makes them. ``train_population`` trains one
ICM-CA SAC agent per scenario in lockstep: each chunk runs every
scenario's rollout, replay write and updates in turn, on the reference's
sharing of draws (the geometry and the rollout noise shared, weights and
replay indices per scenario); on a population mesh each rank runs its
share of the scenarios. Nothing compiles, so the reference's
``jit_cache_size`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.channel import NetworkConfig
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class ScenarioParams(NamedTuple):
    """Dynamic physics of one MHSL scenario (all leaves f32 tensors)."""

    monitor_prob: Tensor  # (E,) per-eavesdropper q_e
    eave_mask: Tensor  # (E,) 1.0 = active, 0.0 = padded-out eavesdropper
    know_eave_locations: Tensor  # () 1.0 = l_M observed, 0.0 = blinded
    gamma_t: Tensor  # () per-iteration delay budget (s)
    gamma_e: Tensor  # () per-iteration energy budget (J)
    bandwidth_hz: Tensor  # () B
    noise_w: Tensor  # () N0 * B in watts
    rayleigh_o: Tensor  # () o
    power_levels: Tensor  # (P,) discrete transmit powers (W)
    leak_scale: Tensor  # () leakage reward scale
    area_m: Tensor  # () deployment area side length
    f_cpu_hz: Tensor  # () f^B device CPU clock
    theta_chip: Tensor  # () vartheta chip energy coefficient
    lambda_f: Tensor  # () Eq. 8 complexity multiplier (seed applied 1.0)
    lambda_b: Tensor  # () Eq. 9 complexity multiplier (seed applied 1.0)
    hop_bandwidth_hz: Tensor  # (max_split - 1,)
    hop_latency_s: Tensor  # (max_split - 1,)
    state_cycles_per_bit: Tensor  # ()

    @property
    def num_eaves(self) -> int:
        return self.monitor_prob.shape[-1]

    @property
    def num_power_levels(self) -> int:
        return self.power_levels.shape[-1]

    @property
    def num_hops(self) -> int:
        return self.hop_bandwidth_hz.shape[-1]


def scenario_from_net(net: NetworkConfig, *, know_eave_locations: bool = True,
                      leak_scale: float = 1.0,
                      device: DeviceLike = None) -> ScenarioParams:
    """The dynamic-physics tuple matching a Table-I config, in f32 on
    ``device`` (``cuda`` by default). ``lambda_f``/``lambda_b`` are 1.0, as
    in the reference (the seed env never applied ``NetworkConfig.lambda_f``
    to Eqs. 8-9)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    e = net.num_eaves
    return ScenarioParams(
        monitor_prob=torch.full((e,), net.monitor_prob, dtype=torch.float32,
                                device=dev),
        eave_mask=torch.ones((e,), dtype=torch.float32, device=dev),
        know_eave_locations=f32(1.0 if know_eave_locations else 0.0),
        gamma_t=f32(net.gamma_t),
        gamma_e=f32(net.gamma_e),
        bandwidth_hz=f32(net.bandwidth_hz),
        noise_w=f32(net.noise_w),
        rayleigh_o=f32(net.rayleigh_o),
        power_levels=f32(net.power_levels),
        leak_scale=f32(leak_scale),
        area_m=f32(net.area_m),
        f_cpu_hz=f32(net.f_cpu_hz),
        theta_chip=f32(net.theta_chip),
        lambda_f=f32(1.0),
        lambda_b=f32(1.0),
        hop_bandwidth_hz=f32(net.hop_bandwidth_hz),
        hop_latency_s=f32(net.hop_latency_s),
        state_cycles_per_bit=f32(net.state_cycles_per_bit),
    )


def replace_param(base: ScenarioParams, name: str, value) -> ScenarioParams:
    """Replace one field, broadcasting scalars to the field's shape
    (e.g. ``monitor_prob=0.3`` -> ``full((E,), 0.3)``)."""
    ref = getattr(base, name)
    val = torch.as_tensor(value, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.expand(ref.shape).clone()})


def scale_param(base: ScenarioParams, name: str, scale) -> ScenarioParams:
    """Scale one field elementwise, keeping its dtype."""
    ref = getattr(base, name)
    val = ref * torch.as_tensor(scale, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.to(ref.dtype)})


def shift_param(base: ScenarioParams, name: str, delta) -> ScenarioParams:
    """Shift one field elementwise, keeping its dtype."""
    ref = getattr(base, name)
    val = ref + torch.as_tensor(delta, dtype=ref.dtype, device=ref.device)
    return base._replace(**{name: val.to(ref.dtype)})


def with_active_eaves(base: ScenarioParams, count: int) -> ScenarioParams:
    """Only the first ``count`` eavesdroppers active; the rest are padding
    (zero monitoring, zero observation)."""
    e = base.num_eaves
    if not 0 <= count <= e:
        raise ValueError(f"count must be in [0, {e}], got {count}")
    mask = (torch.arange(e, device=base.eave_mask.device) < count)
    return base._replace(eave_mask=mask.to(base.eave_mask.dtype))


# ---------------------------------------------------------------------------
# grid construction + stacking
# ---------------------------------------------------------------------------


def scenario_grid(base: ScenarioParams, **axes: Sequence) -> List[ScenarioParams]:
    """Cartesian product over named parameter axes.

    ``scenario_grid(base, monitor_prob=[0.3, 0.6], gamma_e=[50.0, 75.0])``
    yields 4 scenarios in row-major order of the keyword arguments. The
    special axis ``active_eaves`` takes integer counts and varies
    ``eave_mask`` (padded-E sweep).
    """
    names = list(axes)
    out = []
    for combo in itertools.product(*(axes[n] for n in names)):
        sp = base
        for name, value in zip(names, combo):
            if name == "active_eaves":
                sp = with_active_eaves(sp, int(value))
            else:
                sp = replace_param(sp, name, value)
        out.append(sp)
    return out


def stack_scenarios(scenarios: Sequence[ScenarioParams]) -> ScenarioParams:
    """Stack N scenarios into one batched tuple (leading axis N)."""
    if not scenarios:
        raise ValueError("need at least one scenario")
    return ScenarioParams(*(torch.stack(xs) for xs in zip(*scenarios)))


def num_scenarios(stacked: ScenarioParams) -> int:
    return int(stacked.monitor_prob.shape[0])


def unstack_scenarios(stacked: ScenarioParams) -> List[ScenarioParams]:
    """The N scenarios of a stacked tuple, in order."""
    return [ScenarioParams(*(x[i] for x in stacked))
            for i in range(num_scenarios(stacked))]


# ---------------------------------------------------------------------------
# population rollout / evaluation: one episode batch per scenario
# ---------------------------------------------------------------------------


def _rollouts(env, policy, hist_len, params, seed, num_envs, scenarios,
              share_params=True, extra_record=None):
    """Each scenario's ``(num_envs, T, ...)`` trajectory, in turn, all from
    the same draws: a generator on the env's device re-seeded with
    ``seed`` per scenario draws the positions of ``num_envs`` fresh
    geometries, then every step's policy and leakage noise, as
    ``loops.evaluate_sac`` does. Without ``share_params``, scenario ``s``
    runs slice ``s`` of the stacked ``params`` (the reference's
    ``in_axes=0``); ``extra_record`` goes to ``rollout_episode``."""
    from repro_torch.core.agents import rollout as R
    from repro_torch.tree import tree_index

    for s, sp in enumerate(unstack_scenarios(scenarios)):
        gen = torch.Generator(device=env.device).manual_seed(seed)
        st0 = env.reset(env.sample_positions(gen, num_envs, sp), sp)
        p = params if share_params else tree_index(params, s)
        yield R.rollout_episode(env, policy, p, st0, gen, hist_len, sp,
                                extra_record)[1]


def make_population_rollout(env, policy, hist_len: int, *,
                            share_params: bool = True, extra_record=None):
    """Rollout of one shared agent over every scenario of a sweep.

    Returns ``run(params, seed, num_envs, scenarios)`` where ``scenarios``
    is a stacked ``ScenarioParams`` with leading axis N; trajectory leaves
    come back ``(N, num_envs, T, ...)``. Every scenario replays the same
    episode draws (a controlled comparison). ``share_params=False`` takes
    one agent per scenario, stacked on a leading N axis (as
    :func:`train_population` makes them). ``extra_record(st, action, st2,
    info) -> dict`` appends fields to every step's record
    (``rollout.rollout_episode``), stacked ``(N, num_envs, T, ...)``.
    """
    from repro_torch.tree import tree_stack

    def run(params, seed: int, num_envs: int, scenarios: ScenarioParams):
        return tree_stack(list(_rollouts(env, policy, hist_len, params, seed,
                                         num_envs, scenarios, share_params,
                                         extra_record)))

    return run


def make_population_evaluator(env, policy, hist_len: int = 1, *,
                              share_params: bool = True, leakage_model=None):
    """Evaluation of one shared agent over every scenario of a sweep.

    Returns ``evaluate(params, seed, episodes, scenarios)`` ->
    ``{"reward", "leak", "viol"}``, each an ``(N,)`` float64 tensor on the
    host: per scenario the total of the episode batch over episodes and
    steps divided by ``episodes``, with ``evaluate_sac``'s arithmetic (an
    f32 sum of the ``(episodes, T)`` trajectory field on the device,
    divided on the host). ``leakage_model`` overrides the env's
    :class:`~repro_torch.core.leakage.LeakageModel` for this evaluation.
    ``share_params=False`` takes stacked per-scenario params.
    """
    if leakage_model is not None:
        env = dataclasses.replace(env, leakage_model=leakage_model)
    keys = ("reward", "leak", "viol")

    def evaluate(params, seed: int, episodes: int, scenarios: ScenarioParams):
        sums = {k: [] for k in keys}
        for traj in _rollouts(env, policy, hist_len, params, seed, episodes,
                              scenarios, share_params):
            for k in keys:
                sums[k].append(traj[k].sum())
        return {k: torch.stack(v).cpu().double() / episodes
                for k, v in sums.items()}

    return evaluate


def evaluate_population(env, policy, params, scenarios: ScenarioParams, *,
                        episodes: int = 20, seed: int = 1000,
                        hist_len: int = 1, share_params: bool = True,
                        leakage_model=None) -> Dict[str, np.ndarray]:
    """Evaluate ``params`` across a stacked scenario batch (a fresh
    geometry per episode, the same episode draws per scenario).

    The seeds mirror ``loops.evaluate_sac``, so a batch-of-1 sweep
    reproduces its numbers exactly. ``leakage_model`` swaps the leakage
    pricing for this evaluation (analytic by default).
    """
    ev = make_population_evaluator(env, policy, hist_len,
                                   share_params=share_params,
                                   leakage_model=leakage_model)
    out = ev(params, seed, episodes, scenarios)
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# population training: one SAC agent per scenario, trained in lockstep
# ---------------------------------------------------------------------------


@dataclass
class PopulationResult:
    """Per-scenario training curves and the agents' parameters, stacked
    on a leading scenario axis."""

    results: List[Any] = field(default_factory=list)  # List[loops.TrainResult]
    params: Any = None


def draw_seed(gen: torch.Generator) -> int:
    """One seed from a CPU generator (the population's run generator)."""
    return int(torch.randint(0, 2 ** 62, (), generator=gen))


def population_seeds(seed: int, n: int) -> Dict[str, Any]:
    """The seeds :func:`train_population` draws before its first chunk,
    and the run generator, positioned at the first chunk's seed: from a
    CPU generator seeded with ``seed``, in order, scenario by scenario its
    weight seed and its replay seed, then the geometry seed."""
    run = torch.Generator().manual_seed(seed)
    per = [(draw_seed(run), draw_seed(run)) for _ in range(n)]
    return dict(init=[a for a, _ in per], replay=[b for _, b in per],
                geometry=draw_seed(run), run=run)


def train_population(env, cfg, scenarios: ScenarioParams, *,
                     episodes: int = 200, seed: int = 0,
                     warmup_episodes: int = 10, num_envs: int = 1,
                     resample_positions: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 0, resume: bool = True,
                     device=None, mesh=None) -> PopulationResult:
    """Train one ICM-CA SAC agent per scenario of ``scenarios`` (stacked,
    leading axis N), all in lockstep.

    Each chunk runs every scenario's ``rollout.make_train_chunk`` in turn
    (rollout of ``num_envs`` episodes, replay write, ``num_envs *
    episode_len * updates_per_step`` gradient steps), then brings the
    reduced metrics of all scenarios to the host together. Chunking,
    warmup rounding and bookkeeping are ``loops.train_sac``'s.

    Randomness, as the reference shares it (:func:`population_seeds`):
    a CPU generator seeded with ``seed`` (the run generator) draws, per
    scenario in order, the seed of its weights (a CPU generator, as
    ``train_sac``'s) and the seed of its replay indices (a generator on
    the device, used by that scenario's updates only), then one geometry
    seed, then one rollout seed per chunk. Without
    ``resample_positions``, each scenario's one geometry comes from a
    device generator seeded with the geometry seed, so all scenarios share
    it; in each chunk, each scenario's rollout runs on a device generator
    seeded with the chunk's rollout seed (with ``resample_positions`` it
    draws the chunk's positions first), so the scenarios share the
    positions, the Gumbel action noise and the leakage noise, and differ
    by their physics and their agents.

    ``checkpoint_dir`` / ``checkpoint_every`` / ``resume`` behave as in
    ``loops.train_sac``: the stacked params, optimizer states and replay
    storage, the run generator's and every replay generator's states and
    the fixed geometry are saved at chunk boundaries with every scenario's
    curves, explored-state set and ring pointers, under a run fingerprint
    that includes the scenario stack's.

    ``mesh`` (``launch.mesh.make_population_mesh``, or any mesh whose
    population axes ``distribution.sharding.population_axes`` finds:
    ``"env"`` by name on a (stage x env) mesh, where ranks that share an
    env column compute the same scenarios) shards the scenario axis: each
    rank trains its share of the scenarios, every rank draws the same
    seeds, and the per-chunk metrics are all-gathered once per chunk
    after the last scenario, the stacked params at the end. The
    per-scenario math is unchanged, so a sharded run is bit for bit the
    unsharded one. A checkpoint gathers the whole state to the mesh's rank
    0, which writes it; on resume every rank reads it and keeps its
    scenarios.
    """
    from repro_torch.checkpoint import train_state as TS
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.agents import sac as SAC
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution import population as PD
    from repro_torch.tree import tree_index, tree_stack

    LP.check_run(env, num_envs, device, "train_population")
    LP.check_mesh(env, mesh, "train_population")
    n = num_scenarios(scenarios)
    mine = PD.population_rows(mesh, n)  # this rank's scenarios
    sps = unstack_scenarios(scenarios)
    adims = env.action_dims
    seeds = population_seeds(seed, n)
    run_gen = seeds["run"]
    params = [SAC.init_agent(torch.Generator().manual_seed(seeds["init"][s]),
                             env.obs_dim, adims, cfg, device=env.device)
              for s in mine]
    update, init_opt = SAC.make_update(adims, cfg)
    opt_state = [init_opt(p) for p in params]
    ugens = [torch.Generator(device=env.device).manual_seed(seeds["replay"][s])
             for s in mine]
    bufs = [R.buffer_init(cfg.buffer_size, LP.sac_example(env, cfg))
            for _ in mine]
    chunk = R.make_train_chunk(
        env, R.uniform_policy(adims), R.sac_policy(adims, cfg), update,
        hist_len=cfg.hist_len, fields=LP.SAC_FIELDS, batch_size=cfg.batch,
        n_updates=cfg.updates_per_step * env.episode_len * num_envs,
    )
    fixed = None
    if not resample_positions:
        fixed = [env.sample_positions(
            torch.Generator(device=env.device).manual_seed(seeds["geometry"]),
            1, sps[s]) for s in mine]

    def positions(i: int, rgen):
        """The chunk's positions of this rank's ``i``-th scenario."""
        if resample_positions:
            return env.sample_positions(rgen, num_envs, sps[mine[i]])
        return tuple(x.expand(num_envs, -1, -1) for x in fixed[i])

    def gather(tree):
        """Every scenario's rows from this rank's, stacked."""
        return PD.gather_population(tree_stack(tree), mesh, n)

    pop = PopulationResult(results=[LP.TrainResult() for _ in range(n)])
    seen: List[set] = [set() for _ in range(n)]
    meta = dict(seed=seed, num_envs=num_envs, num_scenarios=n,
                warmup_episodes=warmup_episodes,
                resample_positions=resample_positions, cfg=repr(cfg),
                scenario=TS.pytree_fingerprint(scenarios))

    def device_state():
        """The whole population's device state (a collective on a mesh)."""
        # generator states travel on the env's device (NCCL carries
        # nothing else) and come back to the host
        gens = gather([TS.generator_leaf(g).to(env.device) for g in ugens])
        state = dict(params=gather(params), opt_state=gather(opt_state),
                     buf=gather([b.data for b in bufs]),
                     run_gen=TS.generator_leaf(run_gen),
                     replay_gens=gens.cpu())
        if fixed is not None:
            state["positions"] = gather(fixed)
        return state

    def save(ep_now: int) -> None:
        # every ring of a population fills alike, so this rank's first
        # pointers are every scenario's
        LP.save_on_mesh(
            mesh, TS.save_train_checkpoint, checkpoint_dir, ep_now,
            device_state(),
            dict(ep=ep_now, meta=meta,
                 results=[LP.curves_state(r) for r in pop.results],
                 seen=[sorted(x) for x in seen],
                 buf_ptr=[bufs[0].ptr] * n, buf_size=[bufs[0].size] * n))

    ep = 0
    last_saved = None
    if LP.resumable(checkpoint_dir, resume):
        _, dev, host = TS.load_train_checkpoint(checkpoint_dir, device_state())
        ep = last_saved = TS.validate_resume(host, meta, episodes, checkpoint_dir)
        params = [tree_index(dev["params"], s) for s in mine]
        opt_state = [tree_index(dev["opt_state"], s) for s in mine]
        bufs = [R.BufferState(data=tree_index(dev["buf"], s),
                              ptr=host["buf_ptr"][s], size=host["buf_size"][s])
                for s in mine]
        TS.restore_generator(run_gen, dev["run_gen"])
        for g, s in zip(ugens, mine):
            TS.restore_generator(g, dev["replay_gens"][s])
        if fixed is not None:
            fixed = [tree_index(dev["positions"], s) for s in mine]
        for res, saved in zip(pop.results, host["results"]):
            LP.restore_curves(res, saved)
        seen = [set(x) for x in host["seen"]]
        if mesh is not None:  # every rank has read before any writes again
            C.barrier(mesh)

    while ep < episodes:
        if LP.save_due(checkpoint_dir, checkpoint_every, ep, last_saved):
            save(ep)
            last_saved = ep
        t0 = time.perf_counter()
        rseed = draw_seed(run_gen)
        train = ep >= warmup_episodes
        ms = []
        for i, s in enumerate(mine):
            rgen = torch.Generator(device=env.device).manual_seed(rseed)
            pos = positions(i, rgen)
            params[i], opt_state[i], m = chunk(params[i], opt_state[i], bufs[i],
                                               pos, rgen, train, sps[s],
                                               update_gen=ugens[i])
            ms.append(m)
        # one transfer per field for all scenarios, after the last chunk
        host = {k: gather([m[k] for m in ms]).cpu().numpy()
                for k in LP.CHUNK_FIELDS}
        upd = None
        if ms[0]["did_update"]:  # every scenario's buffer fills alike
            upd = {k: gather([m["update"][k] for m in ms]).cpu().tolist()
                   for k in ms[0]["update"]}
        secs = time.perf_counter() - t0
        for s in range(n):
            LP.host_chunk_metrics(
                pop.results[s], seen[s], {k: v[s] for k, v in host.items()},
                None if upd is None else {k: v[s] for k, v in upd.items()},
                ep, episodes, num_envs)
            pop.results[s].chunk_seconds.append(secs)
            pop.results[s].chunk_updated.append(ms[0]["did_update"])
        ep += num_envs
    if checkpoint_dir and last_saved != ep:
        save(ep)

    pop.params = gather(params)
    return pop
