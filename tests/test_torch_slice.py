"""The port's slice as a whole: ``train_sac`` -> ``evaluate_sac`` on the
CPU at a tiny configuration, the port's isolation from JAX, its device
rule, and the weight carry-over with the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.core.agents import sac as JSAC  # noqa: E402
from repro_torch import device as D  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core.agents import loops as LP  # noqa: E402
from repro_torch.core.agents import sac as TSAC  # noqa: E402
from repro_torch.core.channel import sample_positions  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.profiles import resnet101_profile  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = dict(hidden=32, feat_dim=8, attn_dim=8, batch=32, buffer_size=2000)
DIMS = {"u": 6, "size": 4, "decoys": 6, "p_tx": 4, "p_d": 4}


@pytest.mark.parametrize("use_icm_ca", [True, False], ids=["icm_ca", "plain"])
def test_train_and_evaluate_on_cpu(use_icm_ca):
    """Two chunks of 4 envs (one warmup, one updating 56 steps): finite
    per-episode metrics and update losses, params on the CPU, and a
    finite evaluation, with the ICM and the CA actor on and off.
    Host-side control flow: the reference's lax.cond gates (warmup flag,
    buffer fill) are plain ifs in the port, so the warm-up chunk reports
    no update and the next one does."""
    env = MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")
    cfg = TSAC.SACConfig(**TINY, use_icm=use_icm_ca, use_ca=use_icm_ca)
    res = LP.train_sac(env, cfg, episodes=8, warmup_episodes=4, num_envs=4,
                       device="cpu")
    assert res.chunk_updated == [False, True]
    assert len(res.metrics) == 1
    icm_keys = {"icm_inv_loss", "icm_fwd_loss"} if use_icm_ca else set()
    assert set(res.metrics[0]) == {"critic_loss", "actor_loss", "r_c"} | icm_keys
    vals = (list(res.metrics[0].values()) + res.episode_reward
            + res.episode_leak + res.episode_violation)
    assert len(res.episode_reward) == 8
    assert np.isfinite(vals).all()
    assert res.states_explored == sorted(res.states_explored)
    for leaf in jax.tree.leaves(W.sac_params_to_numpy(res.params)):
        assert np.isfinite(leaf).all()
    ev = LP.evaluate_sac(env, res.params, cfg, episodes=4)
    assert set(ev) == {"reward", "leak"} and np.isfinite(list(ev.values())).all()


def test_batched_rollout_routes_through_the_kernel_wrapper(monkeypatch):
    """Kernel routing differs from JAX: the port's rollout is batched, so
    each rollout step calls the kernel wrapper (JAX's vmapped rollout
    always takes the reference path). The value is the reference's:
    cross_attention and the wrapper agree on the current-state row."""
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.agents.attention import cross_attention
    from repro_torch.kernels import ca_attention as CA

    env = MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")
    calls = []
    real = CA.ca_attention

    def counting(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(CA, "ca_attention", counting)
    cfg = TSAC.SACConfig(**TINY)
    params = TSAC.init_agent(torch.Generator().manual_seed(0), env.obs_dim,
                             env.action_dims, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    st0 = env.reset(env.sample_positions(gen, 3))
    _, traj = R.rollout_episode(env, R.sac_policy(env.action_dims, cfg),
                                params, st0, gen, cfg.hist_len)
    assert calls == [3] * env.episode_len
    obs, hist, hmask = (traj[k][:, 5] for k in ("obs", "hist", "hist_mask"))
    masks = {k: v[:, 5] for k, v in traj["masks"].items()}
    kern = TSAC.actor_logits(params, obs, hist, hmask, masks, env.action_dims, cfg)
    assert len(calls) == env.episode_len + 1
    x = cross_attention(params["actor"]["ca"], obs, hist, hmask)
    ref = TSAC._head_logits(params, x, masks, env.action_dims)
    for k in kern:
        np.testing.assert_allclose(kern[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_actor_logits_refuses_an_unbatched_obs():
    """The kernel wrapper takes a batch: an unbatched observation raises
    instead of taking a plain route."""
    cfg = TSAC.SACConfig(**TINY)
    env = MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")
    params = TSAC.init_agent(torch.Generator().manual_seed(0), env.obs_dim,
                             env.action_dims, cfg, device="cpu")
    pair_dim = params["actor"]["ca"]["wk"].shape[0]
    masks = {k: torch.ones(v.shape[1:], dtype=v.dtype)
             for k, v in env.action_masks(env.reset(env.sample_positions(
                 torch.Generator().manual_seed(0), 1))).items()}
    with pytest.raises(ValueError):
        TSAC.actor_logits(params, torch.zeros(env.obs_dim),
                          torch.zeros(cfg.hist_len, pair_dim),
                          torch.ones(cfg.hist_len), masks, env.action_dims, cfg)


def test_train_sac_refuses_a_device_other_than_the_envs():
    env = MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")
    with pytest.raises(ValueError):
        LP.train_sac(env, TSAC.SACConfig(**TINY), episodes=1, device="meta")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    """Isolation: no module of src/repro_torch, and not chip_smoke.py,
    imports jax or anything of the JAX package ``repro``."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        D.resolve_device()
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        MHSLEnv(profile=resnet101_profile(batch=1))
    # constructors default to the card too
    with pytest.raises(RuntimeError):
        TSAC.init_agent(torch.Generator().manual_seed(0), 28, DIMS,
                        TSAC.SACConfig(**TINY))
    with pytest.raises(RuntimeError):
        sample_positions(torch.Generator(), 1, 6, 2, 100.0)
    assert D.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert D.resolve_device() == torch.device("cuda")


def test_weights_round_trip_jax_layout():
    """JAX params and AdamW state carry to the port and back unchanged."""
    dims = {"u": 6, "size": 4, "decoys": 6, "p_tx": 4, "p_d": 4}
    cfg = JSAC.SACConfig(hidden=16, feat_dim=4, attn_dim=8)
    params = JSAC.init_agent(jax.random.PRNGKey(0), 28, dims, cfg)
    _, init_opt = JSAC.make_update(dims, cfg)
    opt = init_opt(params)
    np_params = jax.tree.map(np.asarray, params)
    tparams = W.sac_params_from_jax(np_params, "cpu")
    back = W.sac_params_to_numpy(tparams)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)
    assert tparams["actor"]["trunk"]["layers"][0]["w"].shape == (28 + 8, 16)
    topt = W.sac_opt_state_from_jax(jax.tree.map(np.asarray, opt), "cpu")
    assert topt["actor"].step.dtype == torch.int32
    back = W.sac_opt_state_to_numpy(topt)
    for head in ("actor", "critic", "icm"):
        jax.tree.map(np.testing.assert_array_equal, tuple(back[head]),
                     tuple(jax.tree.map(np.asarray, opt[head])))
    # a port agent has the reference's layout leaf for leaf
    tfresh = TSAC.init_agent(torch.Generator().manual_seed(0), 28, dims,
                             TSAC.SACConfig(hidden=16, feat_dim=4, attn_dim=8),
                             device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), np_params)
    assert jax.tree.map(lambda x: tuple(x.shape), W.sac_params_to_numpy(tfresh)) == shapes
