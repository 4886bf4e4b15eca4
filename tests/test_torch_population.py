"""Scenario sweeps on the port: ``scenario_grid`` / ``stack_scenarios``
against the JAX package's, and ``evaluate_population`` against
``evaluate_sac`` and against per-scenario rollouts.

The grids are compared leaf by leaf, exactly (f32 casts of the same
values). The population evaluator runs each scenario on a generator
re-seeded with the same seed, so its numbers are held exactly: against
``evaluate_sac`` for a batch of one, and against rollouts made by hand
with the generator re-seeded per scenario. The agent is a small SAC on
the CPU (hidden 32, feature and attention width 8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import channel as JCH  # noqa: E402
from repro.core import scenario as JSC  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import scenario as TSC  # noqa: E402
from repro_torch.core.agents import loops as LP  # noqa: E402
from repro_torch.core.agents import rollout as R  # noqa: E402
from repro_torch.core.agents import sac as SAC  # noqa: E402
from repro_torch.core.agents.ppo import PPOConfig, init_ppo, ppo_policy  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.leakage import AnalyticLeakage  # noqa: E402
from repro_torch.core.profiles import resnet101_profile  # noqa: E402
from repro_torch.tree import tree_stack  # noqa: E402

QS = [0.3, 0.45, 0.6, 0.75, 0.9]
EPISODES = 6


@pytest.fixture(scope="module")
def env():
    return MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")


@pytest.fixture(scope="module")
def agent(env):
    cfg = SAC.SACConfig(hidden=32, feat_dim=8, attn_dim=8)
    params = SAC.init_agent(torch.Generator().manual_seed(3), env.obs_dim,
                            env.action_dims, cfg, device="cpu")
    return cfg, params


GRIDS = {
    "monitor_prob": dict(monitor_prob=QS),
    "two_axes": dict(monitor_prob=[0.3, 0.8], gamma_e=[50.0, 75.0]),
    "active_eaves": dict(active_eaves=[0, 1, 2], gamma_t=[4.0, 8.0]),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_scenario_grid_and_stack_match(grid):
    js = JSC.scenario_from_net(JCH.NetworkConfig(), leak_scale=1.5)
    ts = TSC.scenario_from_net(TCH.NetworkConfig(), leak_scale=1.5, device="cpu")
    jg, tg = JSC.scenario_grid(js, **GRIDS[grid]), TSC.scenario_grid(ts, **GRIDS[grid])
    assert len(tg) == len(jg)
    for j, t in zip(jg, tg):
        for f in js._fields:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), err_msg=f)
    jst, tst = JSC.stack_scenarios(jg), TSC.stack_scenarios(tg)
    assert TSC.num_scenarios(tst) == JSC.num_scenarios(jst) == len(jg)
    for f in js._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for i, t in enumerate(TSC.unstack_scenarios(tst)):
        for f in ts._fields:
            assert torch.equal(getattr(t, f), getattr(tg[i], f)), f
    with pytest.raises(ValueError):
        TSC.stack_scenarios([])


def test_batch_of_one_equals_evaluate_sac(env, agent):
    cfg, params = agent
    for seed in (1000, 7):
        ev = LP.evaluate_sac(env, params, cfg, episodes=EPISODES, seed=seed)
        pop = TSC.evaluate_population(
            env, R.sac_policy(env.action_dims, cfg), params,
            TSC.stack_scenarios([env.scenario()]), episodes=EPISODES, seed=seed,
            hist_len=cfg.hist_len)
        assert set(pop) == {"reward", "leak", "viol"}
        assert pop["reward"].shape == (1,)
        assert pop["reward"][0] == ev["reward"] and pop["leak"][0] == ev["leak"]


def test_scenarios_equal_separate_rollouts(env, agent):
    """Each scenario of a sweep equals a rollout made by hand on a
    generator re-seeded with the sweep's seed, field by field."""
    cfg, params = agent
    policy = R.sac_policy(env.action_dims, cfg)
    grid = TSC.scenario_grid(env.scenario(), monitor_prob=[0.3, 0.9],
                             gamma_t=[2.0, 8.0])
    run = TSC.make_population_rollout(env, policy, cfg.hist_len)
    traj = run(params, 11, EPISODES, TSC.stack_scenarios(grid))
    assert traj["reward"].shape == (4, EPISODES, env.episode_len)
    ev = TSC.make_population_evaluator(env, policy, cfg.hist_len)(
        params, 11, EPISODES, TSC.stack_scenarios(grid))
    for i, sp in enumerate(grid):
        gen = torch.Generator().manual_seed(11)
        st0 = env.reset(env.sample_positions(gen, EPISODES, sp), sp)
        _, want = R.rollout_episode(env, policy, params, st0, gen,
                                    cfg.hist_len, sp)
        for k in ("obs", "reward", "leak", "viol", "done"):
            assert torch.equal(traj[k][i], want[k]), k
        for k in ("u", "size", "decoys", "p_tx", "p_d"):
            assert torch.equal(traj["action"][k][i], want["action"][k]), k
        for k in ("reward", "leak", "viol"):
            assert ev[k][i] == float(want[k].sum()) / EPISODES, k


@pytest.mark.parametrize("who", ["sac", "ppo"])
def test_leak_is_monotone_in_q(env, agent, who):
    """Under shared draws the actions do not depend on q (it is not in the
    observation) and ``monitor < q`` is monotone: leak never falls as q
    rises, exactly, for the SAC agent and for PPO."""
    if who == "sac":
        cfg, params = agent
        policy, hist_len = R.sac_policy(env.action_dims, cfg), cfg.hist_len
    else:
        params = init_ppo(torch.Generator().manual_seed(4), env.obs_dim,
                          env.action_dims, PPOConfig(), device="cpu")
        policy, hist_len = ppo_policy(env.action_dims), 1
    scenarios = TSC.stack_scenarios(TSC.scenario_grid(env.scenario(),
                                                      monitor_prob=QS))
    out = TSC.evaluate_population(env, policy, params, scenarios,
                                  episodes=EPISODES, hist_len=hist_len)
    assert out["leak"].shape == (len(QS),)
    assert np.all(np.diff(out["leak"]) >= 0.0)
    assert out["leak"][-1] > out["leak"][0]
    # the rewards differ only through the leak
    np.testing.assert_array_equal(out["viol"], out["viol"][0])


def test_leakage_model_override_and_refusals(env, agent):
    """``leakage_model=`` prices the evaluation with another model (halved
    layer values halve the leak exactly); per-scenario agents
    (``share_params=False``) that are copies of one agent give the shared
    agent's numbers; extra records raise."""
    cfg, params = agent
    policy = R.sac_policy(env.action_dims, cfg)
    scenarios = TSC.stack_scenarios(TSC.scenario_grid(env.scenario(),
                                                      monitor_prob=[0.5, 0.9]))

    class Halved(AnalyticLeakage):
        def layer_values(self, leak_norm):
            return leak_norm * 0.5

    kw = dict(episodes=EPISODES, hist_len=cfg.hist_len)
    base = TSC.evaluate_population(env, policy, params, scenarios, **kw)
    half = TSC.evaluate_population(env, policy, params, scenarios,
                                   leakage_model=Halved(), **kw)
    np.testing.assert_array_equal(half["leak"], base["leak"] * 0.5)
    assert env.leakage_model is None
    copies = tree_stack([params, params])
    per = TSC.evaluate_population(env, policy, copies, scenarios,
                                  share_params=False, **kw)
    for k in base:
        np.testing.assert_array_equal(per[k], base[k])
    with pytest.raises(NotImplementedError):
        TSC.make_population_rollout(env, policy, 1, extra_record=lambda *a: {})
