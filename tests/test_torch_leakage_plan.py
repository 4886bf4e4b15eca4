"""Parity of the rest of the port's leakage model with the JAX package's:
the ``LeakageModel`` protocol, ``plan_hop_geometry``,
``evaluate_leakage`` (expected and sampled), Corollaries 1 and 2, and the
env's ``leakage_model`` field.

Inputs are drawn with numpy from a seed; the Monte-Carlo uniforms are the
reference's own, rebuilt per hop and per eavesdropper with the same
``fold_in``/``split``/``uniform`` calls as
``repro.core.leakage.AnalyticLeakage.evaluate``. Tolerances: rtol 1e-5,
atol 1e-7 (f32 evaluation order differs between XLA and torch); episode
values of the default leakage model against an explicit
``AnalyticLeakage()``: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import leakage as JLK  # noqa: E402
from repro.core import profiles as JPR  # noqa: E402
from repro.core import scenario as JSC  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import leakage as TLK  # noqa: E402
from repro_torch.core import profiles as TPR  # noqa: E402
from repro_torch.core import scenario as TSC  # noqa: E402
from repro_torch.core.env import MHSLEnv as TEnv  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


def _jax_leak_draws(key, num_eaves, num_means):
    """The uniforms ``AnalyticLeakage.sample_leakage`` draws from ``key``:
    per eavesdropper e, fold_in(key, e) -> split -> (snr (D+1,), monitor)."""
    snr, mon = [], []
    for e in range(num_eaves):
        ks, km = jax.random.split(jax.random.fold_in(key, e))
        snr.append(np.asarray(jax.random.uniform(ks, (num_means,),
                                                 minval=1e-12, maxval=1.0)))
        mon.append(np.asarray(jax.random.uniform(km)))
    return np.stack(snr), np.stack(mon)


def _plan_case(seed, s=4, u=6, e=2):
    rng = np.random.default_rng(seed)
    return dict(
        boundaries=np.sort(rng.choice(np.arange(1, 35), s - 1, replace=False)).tolist()
        + [35],
        devices=np.concatenate([rng.permutation(u)[: s - 1], [u]]).tolist(),
        dev_pos=rng.uniform(0, 800.0, (u + 1, 2)).astype(np.float32),
        eav_pos=rng.uniform(0, 800.0, (e, 2)).astype(np.float32),
        p_tx=rng.choice([0.1, 0.2, 0.5, 1.0], s - 1).astype(np.float32),
        decoy_p=(rng.choice([0.1, 0.5, 1.0], (s - 1, u + 1))
                 * (rng.uniform(size=(s - 1, u + 1)) > 0.5)).astype(np.float32),
    )


GEOMETRY_FIELDS = ("p_tx", "dist_tx_e", "decoy_p", "decoy_dist_e",
                   "boundary_layer")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("broadcast", [False, True])
def test_plan_hop_geometry_matches(seed, broadcast):
    """Per-hop geometry of a plan; ``broadcast`` passes a scalar trainer
    power and one (D,) decoy vector for every hop."""
    c = _plan_case(seed)
    if broadcast:
        c["p_tx"], c["decoy_p"] = c["p_tx"][0], c["decoy_p"][0]
    jg = JLK.plan_hop_geometry(**c)
    tg = TLK.plan_hop_geometry(**{k: torch.as_tensor(np.asarray(v))
                                  for k, v in c.items()})
    assert tg.num_hops == jg.num_hops == 3
    for f in GEOMETRY_FIELDS:
        _close(getattr(tg, f), getattr(jg, f), err_msg=f)
    np.testing.assert_array_equal(tg.boundary_layer.numpy(), jg.boundary_layer)
    # numpy inputs on an explicit device give the same geometry
    tn = TLK.plan_hop_geometry(**c, device="cpu")
    for f in GEOMETRY_FIELDS:
        assert torch.equal(getattr(tn, f), getattr(tg, f)), f


@pytest.mark.parametrize("active", [2, 1])
def test_evaluate_leakage_matches(active):
    """``evaluate_leakage`` through the protocol: the Eq. 30 expectation,
    and one Monte-Carlo draw per hop from the reference's per-hop folded
    keys; with both eavesdroppers active, and with one padded out."""
    jm = JLK.AnalyticLeakage.for_profile(JPR.resnet101_profile(batch=1))
    tm = TLK.AnalyticLeakage.for_profile(TPR.resnet101_profile(batch=1))
    js = JSC.with_active_eaves(JSC.scenario_from_net(JCH.NetworkConfig()), active)
    ts = TSC.with_active_eaves(
        TSC.scenario_from_net(TCH.NetworkConfig(), device="cpu"), active)
    for seed in range(3):
        c = _plan_case(10 + seed)
        jg = JLK.plan_hop_geometry(**c)
        tg = TLK.plan_hop_geometry(**c, device="cpu")
        _close(TLK.evaluate_leakage(tm, ts, tg), JLK.evaluate_leakage(jm, js, jg))
        key = jax.random.PRNGKey(100 + seed)
        per_hop = [_jax_leak_draws(jax.random.fold_in(key, h), 2, 8)
                   for h in range(tg.num_hops)]
        draws = TLK.LeakDraws(torch.as_tensor(np.stack([d[0] for d in per_hop])),
                              torch.as_tensor(np.stack([d[1] for d in per_hop])))
        _close(TLK.evaluate_leakage(tm, ts, tg, draws=draws),
               JLK.evaluate_leakage(jm, js, jg, key=key))


def test_analytic_leakage_is_a_leakage_model():
    assert isinstance(TLK.AnalyticLeakage(), TLK.LeakageModel)
    assert isinstance(TLK.AnalyticLeakage.for_profile(
        TPR.resnet101_profile(batch=1)), TLK.LeakageModel)
    assert not isinstance(object(), TLK.LeakageModel)


# (bits, d_tx_rx, d_decoy, B_T, B_E): the interior regime, and a tight
# energy budget that clamps Corollary 1's decoy and Corollary 2's decoys
COROLLARY_CASES = {
    "interior": (2e6, 150.0, 120.0, 1.5, 3.0),
    "clamped": (8e6, 280.0, 90.0, 1.0, 0.05),
}


@pytest.mark.parametrize("regime", sorted(COROLLARY_CASES))
def test_optimal_powers_match(regime):
    bits, d_rx, d_dec, b_t, b_e = COROLLARY_CASES[regime]
    jn, tn = JCH.NetworkConfig(), TCH.NetworkConfig()
    j1 = JLK.optimal_powers_single_decoy(np.float32(bits), np.float32(d_rx),
                                         np.float32(d_dec), np.float32(b_t),
                                         np.float32(b_e), jn)
    t1 = TLK.optimal_powers_single_decoy(bits, d_rx, d_dec, b_t, b_e, tn)
    for t, j in zip(t1, j1):
        _close(t, j)
    assert (float(t1[1]) == 0.0) == (regime == "clamped")
    _close(t1[0] + t1[1], b_e / b_t)  # the energy identity, both regimes
    dd_e = np.asarray([100.0, 250.0, 400.0], np.float32)
    j2 = JLK.optimal_powers_single_eave(np.float32(bits), np.float32(d_rx), dd_e,
                                        np.float32(b_t), np.float32(b_e), jn)
    t2 = TLK.optimal_powers_single_eave(bits, d_rx, torch.as_tensor(dd_e), b_t,
                                        b_e, tn)
    for t, j in zip(t2, j2):
        _close(t, j)
    assert bool((t2[1] == 0).all()) == (regime == "clamped")


# ---------------------------------------------------------------------------
# the env's leakage_model field
# ---------------------------------------------------------------------------


class _HalvedJ(JLK.AnalyticLeakage):
    def layer_values(self, leak_norm):
        return leak_norm * 0.5


class _HalvedT(TLK.AnalyticLeakage):
    def layer_values(self, leak_norm):
        return leak_norm * 0.5


def _episode(env, n_env=4, seed=0, jenv=None):
    """A 7-step episode under fixed actions and the reference's leakage
    draws: per-step (reward, leak) of the port's env, and of ``jenv`` when
    given."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    st = env.reset(env.sample_positions(gen, n_env))
    jst = jstep = None
    if jenv is not None:
        jstep = jax.jit(jenv.step)
        jst = [jenv.reset(jax.random.PRNGKey(0))._replace(
            dev_pos=jnp.asarray(st.dev_pos[i].numpy()),
            eav_pos=jnp.asarray(st.eav_pos[i].numpy()))
            for i in range(n_env)]
    out, jout = [], []
    for t in range(env.episode_len):
        act = {
            "u": rng.permutation(env.U)[:n_env].astype(np.int32),
            "size": rng.integers(0, 4, n_env).astype(np.int32),
            "decoys": rng.integers(0, 2, (n_env, env.U)).astype(np.int32),
            "p_tx": rng.integers(0, 4, n_env).astype(np.int32),
            "p_d": rng.integers(0, 4, n_env).astype(np.int32),
        }
        keys = [jax.random.PRNGKey(1000 * t + i) for i in range(n_env)]
        snr, mon = zip(*(_jax_leak_draws(k, env.E, env.U + 2) for k in keys))
        draws = TLK.LeakDraws(torch.as_tensor(np.stack(snr)),
                              torch.as_tensor(np.stack(mon)))
        st, r, _, info = env.step(st, {k: torch.as_tensor(v) for k, v in act.items()},
                                  draws)
        out.append((r, info["leak"]))
        if jenv is not None:
            steps = [jstep(s, {k: jnp.asarray(v[i]) for k, v in act.items()},
                           keys[i]) for i, s in enumerate(jst)]
            jst = [s[0] for s in steps]
            jout.append((np.stack([s[1] for s in steps]),
                         np.stack([s[3]["leak"] for s in steps])))
    return out, jout


def test_env_leakage_model_field_prices_step():
    """The default model prices an episode bit for bit as an explicit
    ``AnalyticLeakage()``; a model with halved layer values halves every
    hop's leak exactly and changes the rewards, as the JAX env's field
    does with the same model."""
    prof = TPR.resnet101_profile(batch=1)
    base = TEnv(profile=prof, device="cpu")
    default, _ = _episode(base)
    explicit, _ = _episode(dataclasses.replace(
        base, leakage_model=TLK.AnalyticLeakage()))
    for (r0, l0), (r1, l1) in zip(default, explicit):
        assert torch.equal(r0, r1) and torch.equal(l0, l1)
    jenv = JEnv(profile=JPR.resnet101_profile(batch=1), leakage_model=_HalvedJ())
    halved, jhalved = _episode(dataclasses.replace(base, leakage_model=_HalvedT()),
                               jenv=jenv)
    assert any(float(l0.sum()) > 0 for _, l0 in default)
    for (r0, l0), (r1, l1), (jr, jl) in zip(default, halved, jhalved):
        assert torch.equal(l1, l0 * 0.5)
        _close(r1, jr)
        _close(l1, jl)
    assert any(not torch.equal(r0, r1) for (r0, _), (r1, _) in zip(default, halved))
