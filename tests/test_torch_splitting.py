"""Parity of the port's split planner (``repro_torch.core.splitting``,
``MHSLEnv.make_split_oracle``, ``repro_torch.core.transport``) with the
JAX package's.

Inputs are drawn with numpy from a seed and fed to both sides.
Tolerances:
- the host reference (``stage_sums``, ``boundary_bits``,
  ``plan_cost_parts``, ``plan_cost``, the transport model): rtol 1e-6.
  Both sides take the float64 stage sums and Python-float accumulation;
  each hop's rate and time are f32 on both, where the log2 of XLA and
  torch may differ by an ulp (measured 5e-8 relative).
- the batched scorer and the oracle: rtol 1e-5, against JAX and against
  ``plan_cost``. The scorer subtracts f32 cumulative tables, as the JAX
  scorer does (measured 2.4e-7 against JAX here).
- enumerations, ``plan_devices_up``, feasibility masks and the
  bubble fraction: exact. The synchronous 1F1B model at M = 1 against the
  port's own ``plan_cost``: rtol 1e-12 (the same float64 terms).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import profiles as JPR  # noqa: E402
from repro.core import scenario as JSC  # noqa: E402
from repro.core import splitting as JSP  # noqa: E402
from repro.core import transport as JTR  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import profiles as TPR  # noqa: E402
from repro_torch.core import scenario as TSC  # noqa: E402
from repro_torch.core import splitting as TSP  # noqa: E402
from repro_torch.core import transport as TTR  # noqa: E402
from repro_torch.core.env import MHSLEnv as TEnv  # noqa: E402

HOST_RTOL = 1e-6
SCORER_RTOL = 1e-5
ARCHS = ["qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-370m", "jamba-v0.1-52b"]


def _reduced(get_config, arch, layers=8):
    """The arch at reduced widths and ``layers`` blocks (the pattern of a
    hybrid repeated)."""
    r = get_config(arch).reduced()
    pattern = None if r.block_pattern is None else r.block_pattern * (layers // 2)
    return replace(r, num_layers=layers, block_pattern=pattern)


def _profiles(name):
    """(JAX, port) profile pair: ResNet-101 or a reduced zoo arch."""
    if name == "resnet101":
        return JPR.resnet101_profile(batch=1), TPR.resnet101_profile(batch=1)
    return (JPR.transformer_profile(_reduced(jget_config, name), batch=1, seq=64),
            TPR.transformer_profile(_reduced(tget_config, name), batch=1, seq=64))


def _nets(**kw):
    return JCH.NetworkConfig(**kw), TCH.NetworkConfig(**kw)


def _inputs(s, u, seed=0):
    """Positions, an assignment on devices 0..S-2 then the server, a power
    ladder and one 0.2 W decoy (device S)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 800.0, (u + 1, 2))
    devices = tuple(range(s - 1)) + (u,)
    p_tx = np.linspace(0.2, 1.0, s - 1)
    decoy = np.zeros((s - 1, u + 1))
    decoy[:, s] = 0.2
    return pos, devices, p_tx, decoy


# hop ladders: uniform links, and heterogeneous bandwidths with latency
LINKS = {"uniform": {}, "ladder": dict(hop_bandwidth=(1e6, 4e5, 7e5),
                                       hop_latency=3e-3)}


# ---------------------------------------------------------------------------
# host reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet101", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b"])
def test_stage_sums_and_boundary_bits_match(name):
    jp, tp = _profiles(name)
    for b in (JSP.even_boundaries(jp.num_layers, 3), (1, 2, jp.num_layers)):
        for field in ("param_bytes", "fwd_flops", "bwd_flops"):
            np.testing.assert_allclose(TSP.stage_sums(tp, b, field),
                                       JSP.stage_sums(jp, b, field),
                                       rtol=HOST_RTOL)
        for field in ("act_bytes", "grad_bytes"):
            np.testing.assert_allclose(TSP.boundary_bits(tp, b, field),
                                       JSP.boundary_bits(jp, b, field),
                                       rtol=HOST_RTOL)


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("state", [0.0, 0.01])
@pytest.mark.parametrize("name", ["resnet101", *ARCHS])
def test_plan_cost_parts_and_plan_cost_match(name, state, link):
    """Per-stage / per-hop breakdown and totals, with state pricing on and
    off, on uniform links and on a heterogeneous hop ladder."""
    jp, tp = _profiles(name)
    jn, tn = _nets(state_cycles_per_bit=state, **LINKS[link])
    pos, devices, p_tx, decoy = _inputs(4, jn.num_devices, seed=3)
    L = jp.num_layers
    for b in (JSP.even_boundaries(L, 4), (1, 2, 3, L), (L - 3, L - 2, L - 1, L)):
        jplan, tplan = JSP.SplitPlan(b, devices), TSP.SplitPlan(b, devices)
        jparts = JSP.plan_cost_parts(jp, jplan, pos, p_tx, decoy, jn)
        tparts = TSP.plan_cost_parts(tp, tplan, pos, p_tx, decoy, tn)
        for k in jparts:
            np.testing.assert_allclose(tparts[k], jparts[k], rtol=HOST_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(TSP.plan_cost(tp, tplan, pos, p_tx, decoy, tn),
                                   JSP.plan_cost(jp, jplan, pos, p_tx, decoy, jn),
                                   rtol=HOST_RTOL)


@pytest.mark.parametrize("L,s", [(6, 2), (9, 3), (10, 4), (7, 7)])
def test_enumeration_helpers_match_exactly(L, s):
    assert list(TSP.enumerate_boundaries(L, s)) == list(JSP.enumerate_boundaries(L, s))
    tb, jb = TSP.stack_boundaries(L, s), JSP.stack_boundaries(L, s)
    assert tb.dtype == jb.dtype == np.int32
    np.testing.assert_array_equal(tb, jb)
    assert TSP.even_boundaries(L, s) == JSP.even_boundaries(L, s)


def test_plan_devices_up_matches_exactly():
    rng = np.random.default_rng(4)
    devices = rng.integers(0, 7, (20, 4)).astype(np.int32)
    for mask in (np.ones(7), (rng.uniform(size=7) > 0.3).astype(np.float32),
                 np.zeros(7, bool)):
        got = TSP.plan_devices_up(devices, torch.as_tensor(mask))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JSP.plan_devices_up(devices, mask)))
        np.testing.assert_array_equal(
            TSP.plan_devices_up(devices[0], mask).numpy(),
            np.asarray(JSP.plan_devices_up(devices[0], mask)))


# ---------------------------------------------------------------------------
# batched scorer
# ---------------------------------------------------------------------------


def _score_both(jp, tp, bounds, devices, pos, p_tx, decoy, jnet, tnet):
    jt, je = JSP.score_plans(jp, bounds, devices, pos, p_tx, decoy, jnet)
    tt, te = TSP.score_plans(tp, bounds, devices, pos, p_tx, decoy, tnet,
                             device="cpu")
    assert tt.dtype == te.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=SCORER_RTOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=SCORER_RTOL)
    return tt.numpy(), te.numpy()


def _plan_costs(tp, bounds, devices, pos, p_tx, decoy, net):
    return np.asarray([
        TSP.plan_cost(tp, TSP.SplitPlan(tuple(int(x) for x in b), devices),
                      pos, p_tx, decoy, net) for b in bounds])


@pytest.mark.parametrize("link", sorted(LINKS))
def test_score_plans_full_enumeration_matches(link):
    """Every plan of the L 10, S 3 enumeration against the JAX scorer and
    against the port's ``plan_cost``."""
    jp, tp = _profiles("resnet101")
    kw = dict(LINKS[link])
    if "hop_bandwidth" in kw:
        kw["hop_bandwidth"] = kw["hop_bandwidth"][:2]
    jn, tn = _nets(max_split=3, **kw)
    pos, devices, p_tx, decoy = _inputs(3, jn.num_devices)
    bounds = JSP.stack_boundaries(10, 3)
    t, e = _score_both(jp, tp, bounds, np.asarray(devices), pos, p_tx, decoy,
                       jn, tn)
    ref = _plan_costs(tp, bounds, devices, pos, p_tx, decoy, tn)
    np.testing.assert_allclose(t, ref[:, 0], rtol=SCORER_RTOL)
    np.testing.assert_allclose(e, ref[:, 1], rtol=SCORER_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_priced_score_plans_match(arch):
    """State-priced reduced arch profiles: the full S 3 enumeration against
    JAX and ``plan_cost``, and the pricing bites (every plan dearer)."""
    jp, tp = _profiles(arch)
    jn0, tn0 = _nets(max_split=3)
    jn, tn = _nets(max_split=3, state_cycles_per_bit=0.01)
    pos, devices, p_tx, decoy = _inputs(3, jn.num_devices, seed=1)
    bounds = JSP.stack_boundaries(tp.num_layers, 3)
    t, e = _score_both(jp, tp, bounds, np.asarray(devices), pos, p_tx, decoy,
                       jn, tn)
    ref = _plan_costs(tp, bounds, devices, pos, p_tx, decoy, tn)
    np.testing.assert_allclose(t, ref[:, 0], rtol=SCORER_RTOL)
    np.testing.assert_allclose(e, ref[:, 1], rtol=SCORER_RTOL)
    t0, e0 = _score_both(jp, tp, bounds, np.asarray(devices), pos, p_tx, decoy,
                         jn0, tn0)
    assert np.all(t > t0) and np.all(e > e0)


def test_score_plans_per_plan_inputs_and_scenario_match():
    """The reference's broadcasts: per-plan devices ``(N, S)``, powers
    ``(N, S-1)`` and decoys ``(N, S-1, U+1)``; and a ``ScenarioParams``
    (bandwidth, lambdas, latency edited) in place of the config."""
    jp, tp = _profiles("resnet101")
    jn, tn = _nets()
    u = jn.num_devices
    rng = np.random.default_rng(5)
    bounds = JSP.stack_boundaries(12, 4)
    n = bounds.shape[0]
    pos = rng.uniform(0, 800.0, (u + 1, 2))
    devices = np.stack([np.concatenate([rng.permutation(u)[:3], [u]])
                        for _ in range(n)]).astype(np.int32)
    p_tx = rng.choice([0.1, 0.2, 0.5, 1.0], (n, 3))
    decoy = rng.choice([0.0, 0.2, 0.5], (n, 3, u + 1))
    _score_both(jp, tp, bounds, devices, pos, p_tx, decoy, jn, tn)
    edits = [("bandwidth_hz", 2e6), ("lambda_f", 1.7), ("lambda_b", 0.6),
             ("hop_latency_s", 0.004), ("state_cycles_per_bit", 0.02)]
    js, ts = JSC.scenario_from_net(jn), TSC.scenario_from_net(tn, device="cpu")
    for field, value in edits:
        js = JSC.replace_param(js, field, value)
        ts = TSC.replace_param(ts, field, value)
    _score_both(jp, tp, bounds, devices, pos, p_tx, decoy, js, ts)


def test_hop_count_is_checked():
    """A plan with more hops than the link model raises, in the scorer and
    in ``plan_cost``."""
    tp = TPR.resnet101_profile(batch=1)
    net = TCH.NetworkConfig(max_split=2)
    u = net.num_devices
    bounds = np.asarray([[4, 8, tp.num_layers]])
    args = (np.asarray([0, 1, u]), np.zeros((u + 1, 2)), np.full(2, 0.5),
            np.zeros((2, u + 1)))
    with pytest.raises(ValueError, match="link model has 1 hops"):
        TSP.make_plan_scorer(tp, "cpu")(bounds, *args, net)
    with pytest.raises(ValueError, match="link model has 1 hops"):
        TSP.plan_cost(tp, TSP.SplitPlan((4, 8, tp.num_layers), (0, 1, u)),
                      *args[1:], net)


def test_score_plans_caches_one_scorer_per_profile_and_device():
    """The cache key holds the device: a call on another device builds its
    own scorer (with tables on that device) and never reuses the CPU one;
    an equal-content profile rebuilt reuses its device's scorer."""
    tp = TPR.resnet101_profile(batch=1)
    net = TCH.NetworkConfig()
    pos, devices, p_tx, decoy = _inputs(4, net.num_devices)
    bounds = TSP.stack_boundaries(8, 4)
    TSP._SCORER_CACHE.clear()
    t_cpu, _ = TSP.score_plans(tp, bounds, devices, pos, p_tx, decoy, net,
                               device="cpu")
    t_meta, _ = TSP.score_plans(tp, bounds, devices, pos, p_tx, decoy, net,
                                device="meta")
    assert t_cpu.device.type == "cpu" and t_meta.device.type == "meta"
    digest = TPR.profile_digest(tp)
    assert set(TSP._SCORER_CACHE) == {(digest, torch.device("cpu")),
                                      (digest, torch.device("meta"))}
    cpu_scorer = TSP._SCORER_CACHE[(digest, torch.device("cpu"))]
    TSP.score_plans(TPR.resnet101_profile(batch=1), bounds, devices, pos, p_tx,
                    decoy, net, device="cpu")
    assert TSP._SCORER_CACHE[(digest, torch.device("cpu"))] is cpu_scorer
    assert len(TSP._SCORER_CACHE) == 2


# ---------------------------------------------------------------------------
# the env's split oracle
# ---------------------------------------------------------------------------


def test_split_oracle_matches_jax():
    """The full ResNet-101 enumeration through both oracles: delay, energy
    and feasibility; a device mask with the assignment's device down
    makes every plan infeasible (one with an idle device down changes
    nothing); a scenario with huge budgets makes every plan feasible."""
    jenv = JEnv(profile=JPR.resnet101_profile(batch=1))
    tenv = TEnv(profile=TPR.resnet101_profile(batch=1), device="cpu")
    pos, devices, p_tx, decoy = _inputs(tenv.S, tenv.U, seed=2)
    # budgets around the enumeration's delays, so both verdicts occur
    js = JSC.replace_param(jenv.scenario(), "gamma_t", 30.0)
    ts = TSC.replace_param(tenv.scenario(), "gamma_t", 30.0)
    jo, to = jenv.make_split_oracle(), tenv.make_split_oracle()
    dev_pos = torch.as_tensor(pos, dtype=torch.float32)
    for jmask, tmask in ((None, None), (np.eye(7)[1] == 0, np.eye(7)[1] == 0),
                         (np.eye(7)[4] == 0, np.eye(7)[4] == 0)):
        j = jo(jnp.asarray(pos), np.asarray(devices), p_tx, decoy, js,
               device_mask=jmask)
        t = to(dev_pos, np.asarray(devices), p_tx, decoy, ts,
               device_mask=None if tmask is None else torch.as_tensor(tmask))
        np.testing.assert_array_equal(t["boundaries"].numpy(), j["boundaries"])
        np.testing.assert_allclose(t["delay"].numpy(), np.asarray(j["delay"]),
                                   rtol=SCORER_RTOL)
        np.testing.assert_allclose(t["energy"].numpy(), np.asarray(j["energy"]),
                                   rtol=SCORER_RTOL)
        tf, jf = t["feasible"].numpy(), np.asarray(j["feasible"])
        edge = np.abs(np.asarray(j["delay"]) - 30.0) <= 30.0 * SCORER_RTOL
        np.testing.assert_array_equal(tf[~edge], jf[~edge])
        if tmask is not None and not tmask[1]:
            assert not tf.any()
    n_feasible = int(t["feasible"].sum())
    assert 0 < n_feasible < len(tf)
    big = TSC.replace_param(TSC.replace_param(ts, "gamma_t", 1e9), "gamma_e", 1e9)
    assert bool(to(dev_pos, devices, p_tx, decoy, big)["feasible"].all())


# ---------------------------------------------------------------------------
# the 1F1B transport model
# ---------------------------------------------------------------------------


def _transport_setup(s, **link):
    jn, tn = _nets(num_devices=8, max_split=max(s, 4), **link)
    jp, tp = _profiles("resnet101")
    pos, devices, p_tx, decoy = _inputs(s, 8, seed=6)
    bounds = tuple(int(b) for b in np.linspace(4, tp.num_layers, s))
    return jp, tp, bounds, devices, pos, p_tx, decoy, jn, tn


@pytest.mark.parametrize("s", [2, 4])
def test_transport_model_and_simulator_match(s):
    """``plan_transport_model``, ``tick_costs`` and ``simulate_1f1b``
    (sync and overlap, M 1 and 4) against JAX on a heterogeneous ladder;
    the bubble fraction exactly."""
    jp, tp, bounds, devices, pos, p_tx, decoy, jn, tn = _transport_setup(
        s, hop_bandwidth=(1e6, 5e5, 7e5), hop_latency=1e-3)
    jm = JTR.plan_transport_model(jp, JSP.SplitPlan(bounds, devices), pos,
                                  p_tx, decoy, jn)
    tm = TTR.plan_transport_model(tp, TSP.SplitPlan(bounds, devices), pos,
                                  p_tx, decoy, tn)
    for f in ("t_comp_fwd", "t_comp_bwd", "t_tx_fwd", "t_tx_bwd", "hop_latency"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   rtol=HOST_RTOL, err_msg=f)
    for m in (1, 4):
        for got, want in zip(TTR.tick_costs(tm, m), JTR.tick_costs(jm, m)):
            np.testing.assert_allclose(got, want, rtol=HOST_RTOL)
        for transport in ("sync", "overlap"):
            g = TTR.simulate_1f1b(tm, m, transport=transport)
            w = JTR.simulate_1f1b(jm, m, transport=transport)
            assert g["ticks"] == w["ticks"] and g["transport"] == transport
            for k in ("total_s", "compute_s", "transport_s", "per_tick_s"):
                np.testing.assert_allclose(g[k], w[k], rtol=HOST_RTOL, err_msg=k)
            assert g["bubble_fraction"] == w["bubble_fraction"]
    with pytest.raises(ValueError):
        TTR.simulate_1f1b(tm, 2, transport="eager")


@pytest.mark.parametrize("s", [2, 4])
def test_sync_m1_equals_plan_cost(s):
    """At one microbatch the synchronous model is the port's Eq. 10 delay
    (rtol 1e-12), with a ``NetworkConfig`` and with a ``ScenarioParams``."""
    _, tp, bounds, devices, pos, p_tx, decoy, _, tn = _transport_setup(
        s, hop_bandwidth=(1e6, 5e5, 1e6 / 3), hop_latency=1e-3)
    plan = TSP.SplitPlan(bounds, devices)
    for net in (tn, TSC.scenario_from_net(tn, device="cpu")):
        t_ref, _ = TSP.plan_cost(tp, plan, pos, p_tx, decoy, net)
        model = TTR.plan_transport_model(tp, plan, pos, p_tx, decoy, net)
        sim = TTR.simulate_1f1b(model, 1, transport="sync")
        np.testing.assert_allclose(sim["total_s"], t_ref, rtol=1e-12)
