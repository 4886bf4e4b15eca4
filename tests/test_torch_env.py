"""Parity of the port's MHSL physics and env with the JAX package's.

Inputs are drawn with numpy from a seed, or are the reference's own
draws (positions from ``env.reset``, the leakage uniforms recomputed
with the same ``fold_in``/``split``/``uniform`` calls as
``repro.core.leakage.sample_leakage``), and fed to both sides.

Tolerances: profile tables bit-equal; physics and env values
``rtol 1e-5`` (f32 evaluation order differs between XLA and torch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

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

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_leak_draws(key, num_eaves, num_means):
    """The uniforms ``repro.core.leakage.sample_leakage`` draws from
    ``key``: per eavesdropper e, fold_in(key, e) -> split -> (snr (D+1,),
    monitor ())."""
    snr, mon = [], []
    for e in range(num_eaves):
        ks, km = jax.random.split(jax.random.fold_in(key, e))
        snr.append(np.asarray(jax.random.uniform(ks, (num_means,),
                                                 minval=1e-12, maxval=1.0)))
        mon.append(np.asarray(jax.random.uniform(km)))
    return np.stack(snr), np.stack(mon)


@pytest.fixture(scope="module")
def envs():
    return (JEnv(profile=JPR.resnet101_profile(batch=1)),
            TEnv(profile=TPR.resnet101_profile(batch=1), device="cpu"))


# ---------------------------------------------------------------------------
# profiles, channel, scenario, leakage
# ---------------------------------------------------------------------------


def test_profile_table_bit_equal():
    jp, tp = JPR.resnet101_profile(batch=1), TPR.resnet101_profile(batch=1)
    for f in ("param_bytes", "act_bytes", "grad_bytes", "fwd_flops",
              "bwd_flops", "leak_value"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    jt, tt = JPR.profile_table(jp), TPR.profile_table(tp)
    for f in ("act_bits", "grad_bits", "leak_norm", "fwd_cum", "bwd_cum",
              "kind", "state_bits", "state_cum"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    assert TPR.profile_digest(tp) == JPR.profile_digest(jp)


def test_env_constants_are_f32_casts_of_the_tables(envs):
    """Float32 constants: the env casts the float64 tables to f32 like the
    reference's jnp.asarray (torch.as_tensor alone would keep float64)."""
    jenv, tenv = envs
    for j, t in zip(jenv._consts(), tenv._consts):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_scenario_from_net_and_edits_match():
    net = JCH.NetworkConfig()
    tnet = TCH.NetworkConfig()
    js = JSC.scenario_from_net(net, know_eave_locations=False, leak_scale=2.5)
    ts = TSC.scenario_from_net(tnet, know_eave_locations=False, leak_scale=2.5,
                               device="cpu")
    assert ts._fields == js._fields
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    pairs = [
        (JSC.replace_param(js, "monitor_prob", 0.3),
         TSC.replace_param(ts, "monitor_prob", 0.3)),
        (JSC.scale_param(js, "bandwidth_hz", 0.6),
         TSC.scale_param(ts, "bandwidth_hz", 0.6)),
        (JSC.shift_param(js, "hop_latency_s", 0.01),
         TSC.shift_param(ts, "hop_latency_s", 0.01)),
        (JSC.with_active_eaves(js, 1), TSC.with_active_eaves(ts, 1)),
    ]
    for j, t in pairs:
        for f in js._fields:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), err_msg=f)
    with pytest.raises(ValueError):
        TSC.with_active_eaves(ts, 3)


def test_channel_functions_match():
    rng = np.random.default_rng(0)
    net = JCH.NetworkConfig()
    js = JSC.scenario_from_net(net)
    ts = TSC.scenario_from_net(TCH.NetworkConfig(), device="cpu")
    for _ in range(4):
        p = np.float32(rng.choice([0.1, 0.2, 0.5, 1.0]))
        d = np.float32(rng.uniform(0.5, 900.0))
        ip = (rng.uniform(size=7) * (rng.uniform(size=7) > 0.5)).astype(np.float32)
        idist = rng.uniform(0.5, 900.0, size=7).astype(np.float32)
        bw = np.float32(rng.uniform(2e5, 2e6))
        for jn, tn in ((net, TCH.NetworkConfig()), (js, ts)):
            _close(TCH.data_rate(_t(p), _t(d), _t(ip), _t(idist), tn),
                   JCH.data_rate(p, d, ip, idist, jn))
            _close(TCH.data_rate(_t(p), _t(d), _t(ip), _t(idist), tn, _t(bw)),
                   JCH.data_rate(p, d, ip, idist, jn, bw))
        bits = np.float32(rng.uniform(1e5, 1e8))
        flops = np.float32(rng.uniform(1e8, 1e11))
        rate = np.float32(rng.uniform(0.5, 1e7))
        _close(TCH.tx_time(_t(bits), _t(rate)), JCH.tx_time(bits, rate))
        _close(TCH.channel_gain(_t(idist), ts.rayleigh_o),
               JCH.channel_gain(idist, js.rayleigh_o))
        for tf, jf in ((TCH.compute_time_fwd, JCH.compute_time_fwd),
                       (TCH.compute_time_bwd, JCH.compute_time_bwd)):
            _close(tf(_t(flops), ts, lam=ts.lambda_f), jf(flops, js, lam=js.lambda_f))
        _close(TCH.compute_energy(_t(flops), ts), JCH.compute_energy(flops, js))
        st = TSC.replace_param(ts, "state_cycles_per_bit", 3.0)
        sj = JSC.replace_param(js, "state_cycles_per_bit", 3.0)
        _close(TCH.state_time(_t(bits), st), JCH.state_time(bits, sj))
        _close(TCH.state_energy(_t(bits), st), JCH.state_energy(bits, sj))
    a = rng.uniform(0, 800, (5, 2)).astype(np.float32)
    b = rng.uniform(0, 800, (3, 2)).astype(np.float32)
    _close(TCH.pairwise_dist(_t(a), _t(b)), JCH.pairwise_dist(a, b))
    gen = torch.Generator().manual_seed(0)
    dev, eav = TCH.sample_positions(gen, 4, 6, 2, ts.area_m, device="cpu")
    assert dev.shape == (4, 6, 2) and eav.shape == (4, 2, 2)
    assert float(dev.min()) >= 0.0 and float(dev.max()) <= 800.0


def _leak_case(rng, e=2, d=7):
    return dict(
        p_tx=np.float32(rng.choice([0.1, 0.2, 0.5, 1.0])),
        dist_tx_e=rng.uniform(0.5, 900.0, e).astype(np.float32),
        decoy_p=(rng.choice([0.1, 0.5, 1.0], d)
                 * (rng.uniform(size=d) > 0.4)).astype(np.float32),
        decoy_dist_e=rng.uniform(0.5, 900.0, (d, e)).astype(np.float32),
        q_e=np.array([0.8, 0.6], np.float32)[:e],
        delta=np.float32(rng.uniform(0.1, 1.0)),
    )


def test_leakage_functions_match():
    """Theorem 1, Eq. 30 and the Monte-Carlo draw fed the reference's own
    uniforms, one case at a time and batched over a leading axis."""
    rng = np.random.default_rng(1)
    cases = [_leak_case(rng) for _ in range(6)]
    keys = [jax.random.PRNGKey(i) for i in range(6)]
    draws = [_jax_leak_draws(k, 2, 8) for k in keys]
    for c, k, (snr, mon) in zip(cases, keys, draws):
        args = (c["p_tx"], c["dist_tx_e"], c["decoy_p"], c["decoy_dist_e"])
        targs = tuple(_t(a) for a in args)
        _close(TLK.capture_probability(*targs), JLK.capture_probability(*args))
        _close(TLK.expected_leakage(*targs, _t(c["q_e"]), _t(c["delta"])),
               JLK.expected_leakage(*args, c["q_e"], c["delta"]))
        _close(TLK.sample_leakage(TLK.LeakDraws(_t(snr), _t(mon)), *targs,
                                  _t(c["q_e"]), _t(c["delta"])),
               JLK.sample_leakage(k, *args, c["q_e"], c["delta"]))
    # batched: leading axis over the cases
    stack = {f: _t(np.stack([c[f] for c in cases])) for f in cases[0]}
    got = TLK.sample_leakage(
        TLK.LeakDraws(_t(np.stack([d[0] for d in draws])),
                      _t(np.stack([d[1] for d in draws]))),
        stack["p_tx"], stack["dist_tx_e"], stack["decoy_p"],
        stack["decoy_dist_e"], stack["q_e"], stack["delta"])
    want = [JLK.sample_leakage(k, c["p_tx"], c["dist_tx_e"], c["decoy_p"],
                               c["decoy_dist_e"], c["q_e"], c["delta"])
            for c, k in zip(cases, keys)]
    _close(got, np.stack(want))


def test_analytic_evaluate_matches():
    """AnalyticLeakage.evaluate over a hop batch: the expectation, and one
    draw per hop from the reference's per-hop folded keys."""
    rng = np.random.default_rng(2)
    prof = JPR.resnet101_profile(batch=1)
    cases = [_leak_case(rng) for _ in range(3)]
    geo = {f: np.stack([c[f] for c in cases])
           for f in ("p_tx", "dist_tx_e", "decoy_p", "decoy_dist_e")}
    layers = np.array([3, 10, 30], np.int32)
    jg = JLK.HopGeometry(boundary_layer=layers, **geo)
    tg = TLK.HopGeometry(boundary_layer=_t(layers).long(),
                         **{k: _t(v) for k, v in geo.items()})
    jm = JLK.AnalyticLeakage.for_profile(prof)
    tm = TLK.AnalyticLeakage.for_profile(TPR.resnet101_profile(batch=1))
    js = JSC.scenario_from_net(JCH.NetworkConfig())
    ts = TSC.scenario_from_net(TCH.NetworkConfig(), device="cpu")
    _close(tm.evaluate(ts, tg), jm.evaluate(js, jg))
    key = jax.random.PRNGKey(7)
    per_hop = [_jax_leak_draws(jax.random.fold_in(key, h), 2, 8) for h in range(3)]
    draws = TLK.LeakDraws(_t(np.stack([d[0] for d in per_hop])),
                          _t(np.stack([d[1] for d in per_hop])))
    _close(tm.evaluate(ts, tg, draws), jm.evaluate(js, jg, key=key))


# ---------------------------------------------------------------------------
# the env: reset from positions, observe, masks, a whole episode
# ---------------------------------------------------------------------------

SCENARIOS = {
    "default": [],
    # tight budgets (violation penalties fire), one active eavesdropper,
    # blinded eavesdropper locations
    "tight": [("gamma_e", 2.0), ("gamma_t", 0.5), ("know_eave_locations", 0.0),
              ("monitor_prob", 0.95)],
}


def _scenarios(jenv, tenv, name):
    js, ts = jenv.scenario(), tenv.scenario()
    for field, value in SCENARIOS[name]:
        js = JSC.replace_param(js, field, value)
        ts = TSC.replace_param(ts, field, value)
    if name == "tight":
        js, ts = JSC.with_active_eaves(js, 1), TSC.with_active_eaves(ts, 1)
    return js, ts


def _fixed_actions(rng, n_env, env):
    """A 7-step action sequence per env: distinct trainer devices for the
    assignment steps, random sizes / decoys / power levels."""
    u_dim, p_dim = env.U, env.num_power_levels
    steps = []
    perms = np.stack([rng.permutation(u_dim) for _ in range(n_env)])
    for t in range(env.episode_len):
        steps.append({
            "u": perms[:, t % u_dim].astype(np.int32),
            "size": rng.integers(0, 4, n_env).astype(np.int32),
            "decoys": rng.integers(0, 2, (n_env, u_dim)).astype(np.int32),
            "p_tx": rng.integers(0, p_dim, n_env).astype(np.int32),
            "p_d": rng.integers(0, p_dim, n_env).astype(np.int32),
        })
    return steps


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_env_episode_matches_jax(envs, scenario):
    """Reset from the reference's positions, then a whole 7-step episode
    under fixed actions and the reference's leakage draws: observations,
    masks, rewards, infos and every state field agree (rtol 1e-5)."""
    jenv, tenv = envs
    js, ts = _scenarios(jenv, tenv, scenario)
    n_env = 4
    rng = np.random.default_rng(11)
    jstep = jax.jit(jenv.step)
    jobs = jax.jit(jenv.observe)
    jmask = jax.jit(jenv.action_masks)

    jst = [jenv.reset(jax.random.PRNGKey(40 + i), js) for i in range(n_env)]
    dev = _t(np.stack([np.asarray(s.dev_pos)[: jenv.U] for s in jst]))
    eav = _t(np.stack([np.asarray(s.eav_pos) for s in jst]))
    tst = tenv.reset((dev, eav), ts)
    _close(tst.dev_pos, np.stack([np.asarray(s.dev_pos) for s in jst]))

    actions = _fixed_actions(rng, n_env, jenv)
    for t, act in enumerate(actions):
        jo = np.stack([np.asarray(jobs(s, js)) for s in jst])
        _close(tenv.observe(tst, ts), jo, err_msg=f"obs step {t}")
        tm = tenv.action_masks(tst)
        for i, s in enumerate(jst):
            jm = jmask(s)
            for k in jm:
                np.testing.assert_array_equal(tm[k][i].numpy(), np.asarray(jm[k]),
                                              err_msg=f"mask {k} step {t}")
        keys = [jax.random.PRNGKey(1000 * t + i) for i in range(n_env)]
        snr, mon = zip(*(_jax_leak_draws(k, jenv.E, jenv.U + 2) for k in keys))
        draws = TLK.LeakDraws(_t(np.stack(snr)), _t(np.stack(mon)))
        tact = {k: _t(v) for k, v in act.items()}
        tst, tr, tdone, tinfo = tenv.step(tst, tact, draws, ts)
        outs = [jstep(s, {k: v[i] for k, v in act.items()}, keys[i], js)
                for i, s in enumerate(jst)]
        jst = [o[0] for o in outs]
        _close(tr, [o[1] for o in outs], err_msg=f"reward step {t}")
        np.testing.assert_array_equal(tdone.numpy(), [bool(o[2]) for o in outs])
        for k in ("leak", "t_hop", "e_hop", "rate", "tx", "rx", "decoy_p"):
            _close(tinfo[k], np.stack([np.asarray(o[3][k]) for o in outs]),
                   err_msg=f"info {k} step {t}")
        for f in jst[0]._fields:
            _close(getattr(tst, f), np.stack([np.asarray(getattr(s, f)) for s in jst]),
                   err_msg=f"state {f} step {t}")
    assert bool(tst.done.all())
