"""Parity of the port's agents with the JAX package's: the sequential SAC
update, ``intrinsic_reward``, ``select_action``, ``gae``, the DQN and PPO
baselines, ``sgd_momentum`` and the host ``ReplayBuffer``; short DQN and
PPO runs and the figure drivers on the CPU.

Inputs are drawn with numpy from a seed, or are the reference's own
draws (replay batches of real JAX rollouts, Gumbel noise, explore
uniforms and categorical indices), and are fed to both sides with the
same parameters (``repro_torch.weights``). The JAX side goes through
``jax.jit``.

Tolerances: the sequential update after 8 steps, parameters ``rtol 1e-4``
(``atol 1e-6``) and AdamW moments ``rtol 1e-4`` (``atol 1e-5``), as the
joint update's test; ``intrinsic_reward`` and the PPO loss ``rtol 2e-5``;
one DQN step and the PPO epochs-pass update ``rtol 1e-4``; ``gae`` ``rtol
1e-6`` with ``atol 1e-6`` (a few f32 ulps of the O(1) terms it sums: XLA
may fuse a multiply-add where torch rounds twice); ``sgd_momentum``
``rtol 1e-6``; actions (``select_action``, the DQN policy, ``flat_mask``,
``unflatten_action``) and ``ReplayBuffer`` samples bit-equal.
"""
import importlib.util
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.agents import action_space as JA  # noqa: E402
from repro.core.agents import dqn as JDQN  # noqa: E402
from repro.core.agents import ppo as JPPO  # noqa: E402
from repro.core.agents import rollout as JR  # noqa: E402
from repro.core.agents import sac as JSAC  # noqa: E402
from repro.core.agents.buffer import ReplayBuffer as JReplayBuffer  # noqa: E402
from repro.core.agents.loops import _sac_example, _SAC_FIELDS  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro.core.profiles import resnet101_profile as jresnet  # noqa: E402
from repro.nn import init_mlp as jinit_mlp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import sgd_momentum as jsgd  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core.agents import action_space as TA  # noqa: E402
from repro_torch.core.agents import dqn as TDQN  # noqa: E402
from repro_torch.core.agents import ppo as TPPO  # noqa: E402
from repro_torch.core.agents import rollout as TR  # noqa: E402
from repro_torch.core.agents import sac as TSAC  # noqa: E402
from repro_torch.core.agents.buffer import ReplayBuffer as TReplayBuffer  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.profiles import resnet101_profile  # noqa: E402
from repro_torch.figures import band as B  # noqa: E402
from repro_torch.optim import adamw, sgd_momentum  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

SMALL = dict(hidden=32, feat_dim=8, attn_dim=8, batch=16)


def _tt(tree):
    """numpy tree -> torch tree (copies: JAX hands out read-only arrays)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, rtol, atol=1e-6, what=""):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", getattr(p, "name", None)))]
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def env():
    return JEnv(profile=jresnet(batch=1))


@pytest.fixture(scope="module")
def tenv():
    return MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")


@pytest.fixture(scope="module")
def replay(env):
    """A buffer of real uniform-policy JAX transitions, as numpy trees."""
    cfg = JSAC.SACConfig(**SMALL)
    buf = JR.buffer_init(512, _sac_example(env, cfg))
    rollout = JR.make_batched_rollout(env, JR.uniform_policy(env.action_dims),
                                      cfg.hist_len)
    st0 = JR.make_batched_reset(env)(jax.random.split(jax.random.PRNGKey(5), 6))
    _, traj = rollout(None, st0, jax.random.split(jax.random.PRNGKey(6), 6))
    buf = JR.buffer_add(buf, JR.flatten_transitions(traj, _SAC_FIELDS))
    size = int(buf.size)
    return jax.tree.map(lambda x: np.asarray(x)[:size], buf.data)


# ---------------------------------------------------------------------------
# SAC: the sequential update, intrinsic_reward, select_action
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_icm,use_ca", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_sequential_update_matches_jax(env, replay, use_icm, use_ca):
    """8 sequential three-backward updates (critic, then the actor against
    the updated critic's advantage, then the ICM) from the same params,
    AdamW state and replay-index matrix: parameters and AdamW moments at
    rtol 1e-4. The inputs are the joint update's test's (init key 1,
    index rng 2). A port that took the chunk-start critic for the
    advantage misses this by far more than the tolerance (the actor's
    first moments by up to 1.3e-3). Adam's first step moves an element by
    lr g / (|g| + 1e-8), so an element whose gradient is near 1e-8 turns
    float noise into a visible difference: at init key 11 one GRU weight
    of the ICM ends 4e-5 apart, in the joint update as in this one."""
    data = replay
    dims = env.action_dims
    impl = "pallas" if use_icm and use_ca else "ref"
    flags = dict(use_icm=use_icm, use_ca=use_ca, joint_update=False)
    jcfg = JSAC.SACConfig(**SMALL, **flags, ca_impl=impl)
    params = JSAC.init_agent(jax.random.PRNGKey(1), env.obs_dim, dims, jcfg)
    jupd, jinit = JSAC.make_update(dims, jcfg)
    jopt = jinit(params)
    tupd, _ = TSAC.make_update(dims, TSAC.SACConfig(**SMALL, **flags))
    tparams = W.sac_params_from_jax(_np(params), "cpu")
    topt = W.sac_opt_state_from_jax(_np(jopt), "cpu")

    idx = np.random.default_rng(2).integers(0, len(data["obs"]), (8, jcfg.batch))
    tbuf = TR.BufferState(data=_tt(data), size=len(data["obs"]))
    for row in idx:
        params, jopt, jm = jupd(params, jopt, jax.tree.map(lambda x: x[row], data))
        tparams, topt, tm = tupd(tparams, topt,
                                 TR.buffer_gather(tbuf, torch.from_numpy(row)))
    _close_tree(tparams, _np(params), rtol=1e-4, atol=1e-6, what="params")
    heads = ("actor", "critic") + (("icm",) if use_icm else ())
    for head in heads:
        assert int(topt[head].step) == int(jopt[head].step) == 8
        _close_tree(topt[head].mu, _np(jopt[head].mu), rtol=1e-4, atol=1e-5,
                    what=f"mu {head}")
        _close_tree(topt[head].nu, _np(jopt[head].nu), rtol=1e-4, atol=1e-5,
                    what=f"nu {head}")
    if not use_icm:
        assert topt["icm"] == ()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_intrinsic_reward_matches_jax(env, replay):
    dims = env.action_dims
    cfg = JSAC.SACConfig(**SMALL)
    params = JSAC.init_agent(jax.random.PRNGKey(3), env.obs_dim, dims, cfg)
    idx = np.random.default_rng(4).integers(0, len(replay["obs"]), 32)
    batch = jax.tree.map(lambda x: x[idx], replay)
    want = jax.jit(lambda p, b: JSAC.intrinsic_reward(p, b, dims, cfg))(
        params["icm"], batch)
    got = TSAC.intrinsic_reward(W.sac_params_from_jax(_np(params["icm"]), "cpu"),
                                _tt(batch), dims, TSAC.SACConfig(**SMALL))
    for name, g, w in zip(("r_total", "r_c", "l_i", "l_f"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_ca", [True, False])
def test_select_action_matches_jax(env, replay, use_ca):
    """One env's action at B = 1 from the same observation, history and
    masks, with JAX's own Gumbel noise (``A.sample`` splits its key into
    the five heads): bit-equal to the reference's ``select_action``."""
    dims = env.action_dims
    jcfg = JSAC.SACConfig(**SMALL, use_ca=use_ca)
    params = JSAC.init_agent(jax.random.PRNGKey(8), env.obs_dim, dims, jcfg)
    tparams = W.sac_params_from_jax(_np(params), "cpu")
    tcfg = TSAC.SACConfig(**SMALL, use_ca=use_ca)
    shapes = TA.head_shapes(dims)
    for t in range(12):
        row = jax.tree.map(lambda x: x[t * 3], replay)
        key = jax.random.PRNGKey(100 + t)
        want = JSAC.select_action(params, key, row["obs"], row["hist"],
                                  row["hist_mask"], row["masks"], dims, jcfg)
        ks = jax.random.split(key, 5)
        gumbel = _tt({h: jax.random.gumbel(k, shapes[h])
                      for h, k in zip(TA.HEADS, ks)})
        r = _tt(row)
        got = TSAC.select_action(tparams, gumbel, r["obs"], r["hist"],
                                 r["hist_mask"], r["masks"], dims, tcfg)
        for h in TA.HEADS:
            np.testing.assert_array_equal(got[h].numpy(), np.asarray(want[h]),
                                          err_msg=f"step {t} {h}")


# ---------------------------------------------------------------------------
# rollout helpers: gae, the scan and fused updates
# ---------------------------------------------------------------------------


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((5, 7)).astype(np.float32)
    v = rng.standard_normal((5, 7)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b: JR.gae(a, b, 0.95, 0.9)))(r, v)
    got = TR.gae(torch.from_numpy(r), torch.from_numpy(v), 0.95, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_fused_update_means_metrics_over_steps():
    """``make_fused_update`` takes ``n_updates`` steps on rows of the
    filled slots and reports each metric's mean over them."""
    buf = TR.buffer_init(16, {"x": torch.zeros(())})
    TR.buffer_add(buf, {"x": torch.arange(10.0)})

    def update_fn(p, o, batch):
        return p + 1, o, {"sum": batch["x"].sum(), "max": batch["x"].max()}

    fused = TR.make_fused_update(update_fn, 4, 5)
    p, o, m = fused(torch.zeros(()), None, buf, torch.Generator().manual_seed(0))
    assert float(p) == 5.0
    assert 0.0 <= float(m["max"]) <= 9.0 and float(m["sum"]) <= 36.0
    run = TR.make_scan_updates(update_fn, 3)
    p, _, m = run(torch.zeros(()), None, {"x": torch.arange(4.0)})
    assert float(p) == 3.0 and float(m["sum"]) == 6.0


# ---------------------------------------------------------------------------
# DQN
# ---------------------------------------------------------------------------


def test_dqn_flat_mask_and_unflatten_match_jax(env, tenv, replay):
    masks = jax.tree.map(lambda x: x[:40], replay["masks"])
    want = jax.vmap(lambda m: JDQN.flat_mask(env, m))(masks)
    got = TDQN.flat_mask(tenv, _tt(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = int(np.prod(JDQN.flat_dims(env)))
    assert TDQN.flat_dims(tenv) == JDQN.flat_dims(env) and got.shape[-1] == n
    idx = np.random.default_rng(1).integers(0, n, 40).astype(np.int32)
    want = jax.vmap(lambda i, m: JDQN.unflatten_action(i, env, m))(idx, masks)
    got = TDQN.unflatten_action(torch.from_numpy(idx), tenv, _tt(masks))
    for h in TA.HEADS:
        np.testing.assert_array_equal(got[h].numpy(), np.asarray(want[h]), err_msg=h)


def test_dqn_policy_matches_jax_under_shared_draws(env, tenv, replay):
    """The epsilon-greedy policy with JAX's own draws (the explore uniform
    and the masked categorical index its key gives): actions, flat
    indices and flat masks bit-equal, at an epsilon that mixes both."""
    n = 40
    obs = replay["obs"][:n]
    masks = jax.tree.map(lambda x: x[:n], replay["masks"])
    dims = JDQN.flat_dims(env)
    q = jinit_mlp(jax.random.PRNGKey(2), [env.obs_dim, 32, 32, int(np.prod(dims))])
    bundle = {"q": q, "eps": jnp.float32(0.5)}
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    want_a, want_x = jax.jit(jax.vmap(JDQN._dqn_policy(env),
                                      in_axes=(None, 0, 0, None, None, 0)))(
        bundle, keys, obs, None, None, masks)

    def draws(key, m):
        k_explore, k_rand = jax.random.split(key)
        fm = JDQN.flat_mask(env, m)
        return (jax.random.uniform(k_explore),
                jax.random.categorical(k_rand, jnp.where(fm, 0.0, JA.NEG)))

    explore_u, rand_idx = jax.vmap(draws)(keys, masks)
    assert 0 < int((np.asarray(explore_u) < 0.5).sum()) < n
    got_a, got_x = TDQN.epsilon_greedy(
        {"q": W.dqn_params_from_jax(_np(q), "cpu"), "eps": 0.5}, tenv,
        _tt(obs), _tt(masks), _tt(explore_u), _tt(rand_idx))
    for h in TA.HEADS:
        np.testing.assert_array_equal(got_a[h].numpy(), np.asarray(want_a[h]), err_msg=h)
    np.testing.assert_array_equal(got_x["a"].numpy(), np.asarray(want_x["a"]))
    np.testing.assert_array_equal(got_x["fm"].numpy(), np.asarray(want_x["fm"]))


def test_dqn_update_and_target_sync_match_jax(env, replay):
    """Two Q-learning steps with ``target_update=2``: no sync after the
    first, the target equal to the updated Q-net after the second; the Q
    params, target, AdamW moments and losses at rtol 1e-4."""
    n_actions = int(np.prod(JDQN.flat_dims(env)))
    cfg = JDQN.DQNConfig(hidden=32, batch=16, target_update=2)
    q = jinit_mlp(jax.random.PRNGKey(4), [env.obs_dim, 32, 32, n_actions])
    target = jinit_mlp(jax.random.PRNGKey(5), [env.obs_dim, 32, 32, n_actions])
    jopt = jadamw(cfg.lr)
    jupd = jax.jit(JDQN._make_dqn_update(cfg, jopt))
    topt_fn = adamw(cfg.lr)
    tupd = TDQN.make_dqn_update(TDQN.DQNConfig(hidden=32, batch=16, target_update=2),
                                topt_fn)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        i = rng.integers(0, len(replay["obs"]), 16)
        batches.append(dict(
            obs=replay["obs"][i], obs_next=replay["obs_next"][i],
            a=rng.integers(0, n_actions, 16).astype(np.int32),
            mask_next=(rng.uniform(size=(16, n_actions)) > 0.3).astype(np.float32),
            reward=replay["reward"][i], done=replay["done"][i]))
    jb = {"q": q, "target": target, "gs": jnp.zeros((), jnp.int32)}
    jo = jopt.init(q)
    tb = {"q": W.dqn_params_from_jax(_np(q), "cpu"),
          "target": W.dqn_params_from_jax(_np(target), "cpu"), "gs": 0}
    to = W.model_opt_state_from_jax(_np(jo), "cpu")
    for step, batch in enumerate(batches):
        jb, jo, jl = jupd(jb, jo, batch)
        tb, to, tl = tupd(tb, to, _tt(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        _close_tree(tb["q"], _np(jb["q"]), rtol=1e-4, what=f"q {step}")
        _close_tree(tb["target"], _np(jb["target"]), rtol=1e-4, what=f"target {step}")
        assert tb["gs"] == int(jb["gs"]) == step + 1
    _close_tree(tb["target"], _np(jb["q"]), rtol=1e-4, what="synced")
    _close_tree(to.mu, _np(jo.mu), rtol=1e-4, atol=1e-5, what="mu")


def test_train_dqn_on_cpu(tenv):
    """Three chunks of 4 envs: the first (28 transitions) does not fill a
    batch of 32, the next two update (28 steps each); finite metrics,
    twelve episodes, Q params on the CPU."""
    res = TDQN.train_dqn(tenv, TDQN.DQNConfig(hidden=32, batch=32, target_update=20),
                         episodes=12, num_envs=4, device="cpu")
    assert res.chunk_updated == [False, True, True]
    assert len(res.episode_reward) == 12 and len(res.metrics) == 2
    vals = [m["loss"] for m in res.metrics] + res.episode_reward + res.episode_leak
    assert np.isfinite(vals).all()
    assert res.states_explored == sorted(res.states_explored)
    for leaf in jax.tree.leaves(W.dqn_params_to_numpy(res.params)):
        assert np.isfinite(leaf).all()


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ppo_batch(env):
    """JAX PPO params and one normalised batch of 4 JAX rollout episodes
    (log-probs and values recorded by ``ppo_policy``, GAE per env)."""
    cfg = JPPO.PPOConfig(hidden=32)
    params = JPPO.init_ppo(jax.random.PRNGKey(1), env.obs_dim, env.action_dims, cfg)
    rollout = JR.make_batched_rollout(env, JPPO.ppo_policy(env.action_dims), 1)
    st0 = JR.make_batched_reset(env)(jax.random.split(jax.random.PRNGKey(2), 4))
    _, traj = rollout(params, st0, jax.random.split(jax.random.PRNGKey(3), 4))
    adv, ret = jax.vmap(lambda r, v: JR.gae(r, v, cfg.gamma, cfg.lam))(
        traj["reward"], traj["v"])
    batch = JR.flatten_transitions(dict(traj, adv=adv, ret=ret), TPPO.PPO_FIELDS)
    batch["logp_old"] = batch.pop("logp")
    batch["adv"] = (batch["adv"] - batch["adv"].mean()) / (batch["adv"].std() + 1e-6)
    return params, _np(batch), _np(traj)


def test_ppo_policy_records_and_normalisation_match_jax(env, ppo_batch):
    """The port's log-prob and value of the JAX rollout's actions and its
    GAE-then-normalise step against the reference's."""
    params, batch, traj = ppo_batch
    tp = W.ppo_params_from_jax(_np(params), "cpu")
    logits = TPPO.ppo_logits(tp, _tt(traj["obs"]), _tt(traj["masks"]),
                             env.action_dims)
    lp = TA.log_prob(logits, _tt(traj["action"]))
    np.testing.assert_allclose(lp.numpy(), traj["logp"], rtol=2e-5, atol=2e-5)
    cfg = TPPO.PPOConfig(hidden=32)
    adv, ret = TR.gae(*_tt((traj["reward"], traj["v"])), cfg.gamma, cfg.lam)
    np.testing.assert_allclose(TPPO.normalize_adv(adv.reshape(-1)).numpy(),
                               batch["adv"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.reshape(-1).numpy(), batch["ret"], rtol=1e-6,
                               atol=1e-6)


def test_ppo_loss_and_epochs_update_match_jax(env, ppo_batch):
    """``ppo_loss`` against the reference's loss terms (its update's
    metrics are the loss at the step's starting params), then 4 epochs
    on the shared batch: params, AdamW moments and the epoch-mean metrics
    at rtol 1e-4."""
    params, batch, _ = ppo_batch
    dims = env.action_dims
    jcfg = JPPO.PPOConfig(hidden=32, epochs=4)
    tcfg = TPPO.PPOConfig(hidden=32, epochs=4)
    jupd, jinit = JPPO.make_ppo_update(dims, jcfg)
    jo = jinit(params)
    _, _, jm1 = jupd(params, jo, batch)
    tp = W.ppo_params_from_jax(_np(params), "cpu")
    tb = _tt(batch)
    loss, (pg, vloss, ent) = TPPO.ppo_loss(tp, tb, dims, tcfg)
    for name, g in (("loss", loss), ("pg", pg), ("v", vloss), ("ent", ent)):
        np.testing.assert_allclose(float(g), float(jm1[name]), rtol=2e-5,
                                   atol=1e-6, err_msg=name)

    jp, jo, jm = JR.make_scan_updates(jupd, jcfg.epochs)(params, jo, batch)
    tupd, tinit = TPPO.make_ppo_update(dims, tcfg)
    tp2, to, tm = TR.make_scan_updates(tupd, tcfg.epochs)(tp, tinit(tp), tb)
    _close_tree(tp2, _np(jp), rtol=1e-4, atol=1e-6, what="params")
    _close_tree(to.mu, _np(jo.mu), rtol=1e-4, atol=1e-6, what="mu")
    assert int(to.step) == int(jo.step) == 4
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_train_ppo_on_cpu(tenv):
    """Chunks of 2 envs gather into batches of 4 episodes: every second
    chunk updates (4 epochs each); finite metrics, twelve episodes."""
    res = TPPO.train_ppo(tenv, TPPO.PPOConfig(hidden=32, episodes_per_batch=4),
                         episodes=12, num_envs=2, device="cpu")
    assert res.chunk_updated == [False, True] * 3
    assert len(res.episode_reward) == 12 and len(res.metrics) == 3
    assert set(res.metrics[0]) == {"loss", "pg", "v", "ent"}
    vals = [v for m in res.metrics for v in m.values()] + res.episode_reward
    assert np.isfinite(vals).all()
    for leaf in jax.tree.leaves(W.ppo_params_to_numpy(res.params)):
        assert np.isfinite(leaf).all()


# ---------------------------------------------------------------------------
# sgd_momentum, ReplayBuffer
# ---------------------------------------------------------------------------


def test_sgd_momentum_matches_jax():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                          params) for _ in range(4)]
    jo_fn, to_fn = jsgd(0.05, 0.8), sgd_momentum(0.05, 0.8)
    jp, tp = params, _tt(params)
    js, ts = jo_fn.init(jp), to_fn.init(tp)
    for g in grads:
        ju, js = jo_fn.update(g, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = to_fn.update(_tt(g), ts, tp)
        tp = tree_map(lambda p, u: p + u, tp, tu)
    _close_tree(tp, _np(jp), rtol=1e-6, what="params")
    _close_tree(ts.mu, _np(js.mu), rtol=1e-6, what="mu")
    assert int(ts.step) == int(js.step) == 4


def test_replay_buffer_matches_jax_under_one_generator(replay):
    """The host buffer wraps its ring like the reference's and, under one
    numpy generator, samples the same rows, handed over as CPU tensors."""
    example = jax.tree.map(lambda x: x[0], replay)
    jbuf, tbuf = JReplayBuffer(24, example), TReplayBuffer(24, example)
    for t in range(30):
        item = jax.tree.map(lambda x: x[t], replay)
        jbuf.add(item)
        tbuf.add(item)
    assert (tbuf.size, tbuf.ptr) == (jbuf.size, jbuf.ptr) == (24, 6)
    want = jbuf.sample(np.random.default_rng(7), 10)
    got = tbuf.sample(np.random.default_rng(7), 10, device="cpu")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(tree_map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


# ---------------------------------------------------------------------------
# figure drivers, band configuration
# ---------------------------------------------------------------------------


def test_figure_drivers_run_on_cpu(tmp_path, monkeypatch):
    """fig 3, 4 and 7 end to end at 2 episodes of 2 envs, inside warmup
    (no gradient step): each writes its JSON with the device named."""
    from repro_torch.figures import common, fig3_convergence, fig4_algorithms
    from repro_torch.figures import fig7_exploration

    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    kw = dict(num_envs=2, device="cpu", episodes=2, warmup=2)
    d3 = fig3_convergence.main(**kw)
    assert set(d3["final_reward"]) == {"icm_ca", "no_icm", "no_ca"}
    d4 = fig4_algorithms.main(**kw)
    assert set(d4["final_reward"]) == {"icm_ca", "ppo", "dqn"}
    d7 = fig7_exploration.main(**kw)
    assert len(d7["icm_ca_states"]) == 2
    for name in ("fig3_convergence", "fig4_algorithms", "fig7_exploration"):
        with open(tmp_path / f"{name}.json") as f:
            assert json.load(f)["device"] == "cpu"


def test_band_reference_is_the_configuration_chip_smoke_runs():
    """``tests/data/torch_band_reference.json`` was made at the bands the
    port runs: its card configuration is the one ``chip_smoke.py``'s band
    phase trains, its cpu one ``tests/test_torch_band.py``'s, and it holds
    every arm at every seed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", B.REFERENCE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ref = B.load_reference()
    assert chip_smoke.band_config() is B.CARD_BAND
    for name, band in (("card", B.CARD_BAND), ("cpu", B.CPU_BAND)):
        assert ref[name]["config"] == json.loads(json.dumps(band)), name
        assert list(ref[name]["arms"]) == band["arms"]
        for rows in ref[name]["arms"].values():
            assert [r["seed"] for r in rows] == band["seeds"]
            assert all(np.isfinite([r[m] for m in B.METRICS]).all() for r in rows)
