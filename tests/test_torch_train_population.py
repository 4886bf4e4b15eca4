"""Population training on the port: ``train_population`` with one agent
per scenario, the sharing of its draws, per-scenario evaluation, and
stop/resume of ``train_sac`` and ``train_population``.

The port runs the scenarios in turn where the JAX package ``vmap``s them,
so the sharing of draws is built by hand (``scenario.population_seeds``):
the geometry and every rollout draw are shared, weights and replay
indices are per scenario. The tests hold that structure exactly: two
identical scenarios give identical warmup episodes and different agents,
and scenario 1 of a run rebuilt by hand from the documented seeds gives
the same curves and params bit for bit. The stacked update is held to
the JAX package's ``jax.vmap`` of the same update on the same per-scenario
replay-index matrices (drawn with numpy) at ``rtol 1e-4``, as
``tests/test_torch_sac.py`` holds one agent. Resumed runs are bit-identical
to uninterrupted ones; a checkpoint of another run is refused.
Small SAC (hidden 16, features 4, attention 8, batch 8) on the CPU.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.agents import rollout as JR  # noqa: E402
from repro.core.agents import sac as JSAC  # noqa: E402
from repro.core.agents.loops import _sac_example, _SAC_FIELDS  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro.core.profiles import resnet101_profile  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.checkpoint import train_state as TS  # noqa: E402
from repro_torch.core import scenario as SC  # noqa: E402
from repro_torch.core.agents import loops as LP  # noqa: E402
from repro_torch.core.agents import rollout as R  # noqa: E402
from repro_torch.core.agents import sac as SAC  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.tree import tree_index, tree_leaves, tree_map, tree_stack  # noqa: E402

CFG = SAC.SACConfig(hidden=16, feat_dim=4, attn_dim=8, batch=8, buffer_size=300,
                    updates_per_step=1)
KW = dict(warmup_episodes=2, seed=5, num_envs=2)


@pytest.fixture(scope="module")
def env():
    return MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")


def _grid(env, **axes):
    return SC.stack_scenarios(SC.scenario_grid(env.scenario(), **axes))


@pytest.fixture(scope="module")
def blind(env):
    return _grid(env, know_eave_locations=[1.0, 0.0])


@pytest.fixture(scope="module")
def pop(env, blind):
    return SC.train_population(env, CFG, blind, episodes=6, **KW)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_lockstep_shapes_and_curves(env, blind, pop):
    assert len(pop.results) == 2
    for res in pop.results:
        assert len(res.episode_reward) == 6 == len(res.states_explored)
        assert all(np.isfinite(res.episode_reward + res.episode_leak))
        assert res.states_explored == sorted(res.states_explored)
        assert res.chunk_updated == [False, True, True]
        assert len(res.metrics) == 2
    for leaf in tree_leaves(pop.params):
        assert leaf.shape[0] == 2 and leaf.device.type == "cpu"
    # the blinded observation differentiates the runs once the agents act
    assert pop.results[0].episode_reward != pop.results[1].episode_reward
    with pytest.raises(ValueError, match="num_envs"):
        SC.train_population(env, CFG, blind, episodes=2, num_envs=0)


def test_identical_scenarios_share_draws_not_agents(env):
    """Two copies of one scenario: the warmup episodes are identical (the
    shared geometry and rollout draws), the agents are not (per-scenario
    initial weights and replay indices)."""
    twin = SC.stack_scenarios([env.scenario(), env.scenario()])
    p = SC.train_population(env, CFG, twin, episodes=6, **KW)
    a, b = p.results
    assert a.episode_reward[:2] == b.episode_reward[:2]
    assert a.episode_leak[:2] == b.episode_leak[:2]
    assert a.states_explored[:2] == b.states_explored[:2]
    p0, p1 = tree_index(p.params, 0), tree_index(p.params, 1)
    assert not any(torch.equal(x, y) for x, y in zip(tree_leaves(p0), tree_leaves(p1)))
    assert a.episode_reward != b.episode_reward


def test_scenario_rebuilt_by_hand_from_the_seeds(env, blind, pop):
    """Scenario 1 of the run, trained alone from the seeds the docstring
    of ``train_population`` names, gives the same curves and params."""
    seeds = SC.population_seeds(KW["seed"], 2)
    sp = SC.unstack_scenarios(blind)[1]
    adims = env.action_dims
    params = SAC.init_agent(torch.Generator().manual_seed(seeds["init"][1]),
                            env.obs_dim, adims, CFG, device="cpu")
    update, init_opt = SAC.make_update(adims, CFG)
    opt = init_opt(params)
    replay = torch.Generator().manual_seed(seeds["replay"][1])
    buf = R.buffer_init(CFG.buffer_size, LP.sac_example(env, CFG))
    chunk = R.make_train_chunk(
        env, R.uniform_policy(adims), R.sac_policy(adims, CFG), update,
        hist_len=CFG.hist_len, fields=LP.SAC_FIELDS, batch_size=CFG.batch,
        n_updates=CFG.updates_per_step * env.episode_len * 2)
    geometry = env.sample_positions(
        torch.Generator().manual_seed(seeds["geometry"]), 1, sp)
    positions = tuple(x.expand(2, -1, -1) for x in geometry)
    res, seen = LP.TrainResult(), set()
    for ep in range(0, 6, 2):
        rollout = torch.Generator().manual_seed(SC.draw_seed(seeds["run"]))
        params, opt, m = chunk(params, opt, buf, positions, rollout,
                               ep >= KW["warmup_episodes"], sp, update_gen=replay)
        LP._chunk_metrics(res, seen, m, ep, 6, 2)
    want = pop.results[1]
    assert res.episode_reward == want.episode_reward
    assert res.episode_leak == want.episode_leak
    assert res.states_explored == want.states_explored
    assert _same(params, tree_index(pop.params, 1))


def test_stacked_update_matches_jax_vmap():
    """Four joint updates of two stacked agents, each on its own replay
    indices (numpy-drawn matrices), against ``jax.vmap`` of the JAX update
    scan: params, AdamW moments and metric means at rtol 1e-4."""
    jenv = JEnv(profile=resnet101_profile(batch=1))
    dims = jenv.action_dims
    small = dict(hidden=32, feat_dim=8, attn_dim=8, batch=16)
    jcfg = JSAC.SACConfig(**small)
    tcfg = SAC.SACConfig(**small)
    buf = JR.buffer_init(512, _sac_example(jenv, jcfg))
    st0 = JR.make_batched_reset(jenv)(jax.random.split(jax.random.PRNGKey(5), 6))
    _, traj = JR.make_batched_rollout(jenv, JR.uniform_policy(dims), jcfg.hist_len)(
        None, st0, jax.random.split(jax.random.PRNGKey(6), 6))
    buf = JR.buffer_add(buf, JR.flatten_transitions(traj, _SAC_FIELDS))
    rows = int(buf.size)
    data = jax.tree.map(lambda x: x[:rows], buf.data)

    params = jax.vmap(lambda k: JSAC.init_agent(k, jenv.obs_dim, dims, jcfg))(
        jax.random.split(jax.random.PRNGKey(1), 2))
    jupd, jinit = JSAC.make_update(dims, jcfg)
    jopt = jax.vmap(jinit)(params)
    idx = np.random.default_rng(7).integers(0, rows, (2, 4, jcfg.batch))

    def scan(p, o, ix):
        def body(c, row):
            p, o, m = jupd(*c, jax.tree.map(lambda x: x[row], data))
            return (p, o), m
        (p, o), ms = jax.lax.scan(body, (p, o), ix)
        return p, o, jax.tree.map(jnp.mean, ms)

    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tparams = W.population_params_from_jax(np_tree(params), "cpu")
    topt = W.population_opt_state_from_jax(np_tree(jopt), "cpu")
    jp, jo, jm = jax.jit(jax.vmap(scan))(params, jopt, jnp.asarray(idx))

    tupd, _ = SAC.make_update(dims, tcfg)
    tbuf = R.BufferState(data=tree_map(lambda x: torch.from_numpy(np.array(x)), data),
                         size=rows)
    out_p, out_o, out_m = [], [], []
    for s in range(2):
        p, o, ms = tree_index(tparams, s), tree_index(topt, s), []
        for row in idx[s]:
            p, o, m = tupd(p, o, R.buffer_gather(tbuf, torch.from_numpy(row)))
            ms.append(m)
        out_p.append(p)
        out_o.append(o)
        out_m.append(R.metric_means(ms))
    got_p = W.population_params_to_numpy(tree_stack(out_p))
    got_o = W.population_opt_state_to_numpy(tree_stack(out_o))

    def close(got, want, what, atol):
        flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
        for path, w in flat_w:
            g = got
            for k in path:
                g = (getattr(g, k.name) if hasattr(k, "name")
                     else g[getattr(k, "key", getattr(k, "idx", None))])
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=atol,
                                       err_msg=f"{what}{jax.tree_util.keystr(path)}")

    close(got_p, jp, "params", 1e-6)
    for head in ("actor", "critic", "icm"):
        np.testing.assert_array_equal(got_o[head].step, [4, 4])
        close(got_o[head].mu, jo[head].mu, f"mu {head}", 1e-5)
    for k in jm:
        np.testing.assert_allclose([float(m[k]) for m in out_m], np.asarray(jm[k]),
                                   rtol=1e-4, err_msg=k)


def test_evaluate_population_per_scenario_agents(env, blind, pop):
    """``share_params=False`` runs scenario s on slice s of the stacked
    params: each point equals ``evaluate_sac`` of that agent on that
    scenario."""
    policy = R.sac_policy(env.action_dims, CFG)
    got = SC.evaluate_population(env, policy, pop.params, blind, episodes=3,
                                 seed=11, hist_len=CFG.hist_len, share_params=False)
    for s, sp in enumerate(SC.unstack_scenarios(blind)):
        want = LP.evaluate_sac(env, tree_index(pop.params, s), CFG, episodes=3,
                               seed=11, scenario=sp)
        assert got["reward"][s] == want["reward"] and got["leak"][s] == want["leak"]
    run = SC.make_population_rollout(env, policy, CFG.hist_len, share_params=False)
    traj = run(pop.params, 11, 3, blind)
    assert traj["reward"].shape == (2, 3, env.episode_len)
    assert torch.equal(traj["reward"].sum((1, 2)) / 3,
                       torch.tensor(got["reward"], dtype=torch.float64).float())


def test_train_sac_resume_is_bit_identical(env, tmp_path):
    ref = LP.train_sac(env, CFG, episodes=8, **KW)
    ck = os.fspath(tmp_path / "sac")
    part = LP.train_sac(env, CFG, episodes=4, checkpoint_dir=ck, checkpoint_every=2, **KW)
    assert part.episode_reward == ref.episode_reward[:4]
    assert TS.latest_checkpoint_step(ck) == 4
    res = LP.train_sac(env, CFG, episodes=8, checkpoint_dir=ck, checkpoint_every=4, **KW)
    for k in LP.CURVES:
        assert getattr(res, k) == getattr(ref, k), k
    assert _same(res.params, ref.params)
    assert TS.latest_checkpoint_step(ck) == 8
    # a fresh run ignores the checkpoint, and so repeats the reference
    fresh = LP.train_sac(env, CFG, episodes=4, checkpoint_dir=ck, resume=False, **KW)
    assert fresh.episode_reward == ref.episode_reward[:4]


def test_train_sac_resume_with_resampled_positions(env, tmp_path):
    kw = dict(KW, resample_positions=True)
    ref = LP.train_sac(env, CFG, episodes=6, **kw)
    ck = os.fspath(tmp_path / "sac")
    LP.train_sac(env, CFG, episodes=2, checkpoint_dir=ck, **kw)
    res = LP.train_sac(env, CFG, episodes=6, checkpoint_dir=ck, **kw)
    assert res.episode_reward == ref.episode_reward
    assert _same(res.params, ref.params)


def test_train_population_resume_is_bit_identical(env, blind, pop, tmp_path):
    ck = os.fspath(tmp_path / "pop")
    SC.train_population(env, CFG, blind, episodes=4, checkpoint_dir=ck,
                        checkpoint_every=2, **KW)
    assert TS.latest_checkpoint_step(ck) == 4
    res = SC.train_population(env, CFG, blind, episodes=6, checkpoint_dir=ck,
                              checkpoint_every=2, **KW)
    for s in range(2):
        for k in LP.CURVES:
            assert getattr(res.results[s], k) == getattr(pop.results[s], k), (s, k)
    assert _same(res.params, pop.params)


def test_resume_refuses_another_run(env, blind, tmp_path):
    ck = os.fspath(tmp_path / "sac")
    LP.train_sac(env, CFG, episodes=2, checkpoint_dir=ck, **KW)
    with pytest.raises(ValueError, match="cannot resume"):
        LP.train_sac(env, CFG, episodes=4, checkpoint_dir=ck, **dict(KW, seed=6))
    with pytest.raises(ValueError, match="past the requested"):
        LP.train_sac(env, CFG, episodes=1, checkpoint_dir=ck, **KW)
    ck = os.fspath(tmp_path / "pop")
    SC.train_population(env, CFG, blind, episodes=2, checkpoint_dir=ck, **KW)
    with pytest.raises(ValueError, match="cannot resume"):
        SC.train_population(env, CFG, blind, episodes=4, checkpoint_dir=ck,
                            **dict(KW, seed=6))
    other = _grid(env, know_eave_locations=[1.0, 0.5])
    with pytest.raises(ValueError, match="cannot resume"):
        SC.train_population(env, CFG, other, episodes=4, checkpoint_dir=ck, **KW)


def test_fig6_and_fig8_drivers_on_the_cpu(tmp_path, monkeypatch):
    """Both drivers at two warmup episodes (no updates) on the CPU: their
    JSON and derived numbers; fig 8 resumes from its checkpoint; fig 6
    refuses the empirical leakage model."""
    from repro_torch.figures import common, fig6_eavesdroppers, fig8_no_location

    monkeypatch.setattr(common, "OUT_DIR", os.fspath(tmp_path / "out"))
    ck = os.fspath(tmp_path / "ck")
    d8 = fig8_no_location.main(num_envs=2, device="cpu", episodes=2, warmup=2,
                               checkpoint_dir=ck)
    assert len(d8["known_curve"]) == 2 == len(d8["blind_curve"])
    assert np.isfinite(d8["reward_drop_pct"])
    assert TS.latest_checkpoint_step(os.path.join(ck, "fig8", "pop")) == 2
    again = fig8_no_location.main(num_envs=2, device="cpu", episodes=2, warmup=2,
                                  checkpoint_dir=ck)
    assert again["known_curve"] == d8["known_curve"]
    d6 = fig6_eavesdroppers.main(num_envs=2, device="cpu", episodes=2, warmup=2)
    assert sorted(d6["rows"]) == [1, 2, 3, 4]
    assert all(set(r) == {"icm_ca", "sac", "ppo"} for r in d6["rows"].values())
    assert np.isfinite(d6["reduction_vs_sac_at_E4_pct"])
    assert sorted(os.listdir(tmp_path / "out")) == ["fig6_eavesdroppers.json",
                                                    "fig8_no_location.json"]
    # the attacker-measured EmpiricalLeakage prices the same sweep
    d6e = fig6_eavesdroppers.main(num_envs=2, device="cpu", episodes=2, warmup=2,
                                  leakage="empirical", smoke=True)
    assert d6e["leakage"] == "empirical" and sorted(d6e["rows"]) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in d6e["rows"].values() for v in r.values())


def test_launcher_passes_the_checkpoint_flags(monkeypatch):
    """The launcher hands ``--checkpoint-dir``, ``--checkpoint-every`` and
    ``--fresh`` to ``train_sac`` (whose checkpoints the tests above hold)."""
    from repro_torch.launch import train_mhsl_rl as LAUNCH

    class Stop(Exception):
        pass

    seen = {}

    def trainer(env, cfg, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(LAUNCH.LP, "train_sac", trainer)
    base = ["--reduced", "--device", "cpu", "--episodes", "4"]
    with pytest.raises(Stop):
        LAUNCH.main(base + ["--checkpoint-dir", "ck", "--checkpoint-every", "3",
                            "--fresh"])
    assert (seen["checkpoint_dir"], seen["checkpoint_every"], seen["resume"]) == (
        "ck", 3, False)
    with pytest.raises(Stop):
        LAUNCH.main(base)
    assert (seen["checkpoint_dir"], seen["resume"]) == (None, True)
