"""The port's fault injection against the JAX package's
``repro.core.faults``, the faulted transport and fault-injected serving.

Mirrors ``tests/test_faults.py``, the faulted cases of
``tests/test_transport.py``, ``test_requeue_front_preserves_order`` of
``tests/test_service_properties.py`` and ``tests/test_chaos.py``'s
serving cases. ``sample_fault_schedule`` takes the reference's own
uniforms (its ``split`` into six keys, each drawn with ``uniform``; its
``bernoulli`` is ``uniform < p``) and must give its schedule bit for
bit. Bitwise where the reference claims bitwise: fault-free
degradation and transport, and the tokens of faulted serving. The
faulted transport against the reference's: ``JAX_RTOL`` 1e-6 (measured
1.6e-7 on one hop: the two ``plan_cost_parts`` evaluate the f32
scenario's link terms in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.core import faults as JF  # noqa: E402
from repro.core import scenario as JSC  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.core.channel import NetworkConfig as JNet  # noqa: E402
from repro.core.splitting import SplitPlan as JPlan  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core.channel import NetworkConfig  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.profiles import resnet101_profile  # noqa: E402
from repro_torch.core.scenario import scenario_from_net  # noqa: E402
from repro_torch.core.splitting import SplitPlan, plan_cost  # noqa: E402
from repro_torch.core.transport import (faulted_transport_model,  # noqa: E402
                                        plan_transport_model, simulate_1f1b,
                                        simulate_1f1b_faulted)
from repro_torch.serving import (Request, RequestQueue, ServeConfig,  # noqa: E402
                                 ServingService, poisson_trace)

CPU = "cpu"
JAX_RTOL = 1e-6


@pytest.fixture(scope="module")
def env():
    return MHSLEnv(profile=resnet101_profile(batch=1), device=CPU)


def _setup(s, *, num_devices=8, jax_side=False):
    kw = dict(num_devices=num_devices, max_split=max(s, 4),
              hop_bandwidth=tuple(1e6 / (k + 1) for k in range(max(s, 4) - 1)),
              hop_latency=1e-3)
    net = (JNet if jax_side else NetworkConfig)(**kw)
    prof = resnet101_profile(batch=1)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, net.area_m, (net.num_devices + 1, 2))
    devices = tuple(range(s - 1)) + (net.num_devices,)
    bounds = tuple(int(b) for b in np.linspace(4, prof.num_layers, s))
    plan = (JPlan if jax_side else SplitPlan)(bounds, devices)
    p_tx = np.full(s - 1, 0.5)
    decoy = np.zeros((s - 1, net.num_devices + 1))
    decoy[:, -1] = 0.1
    return prof, plan, pos, p_tx, decoy, net


def _leaves_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# schedule construction and replay


SAMPLE_KW = dict(num_devices=5, num_hops=3, horizon_s=2.0, num_windows=2,
                 outage_prob=0.5, outage_len_s=(0.1, 0.4),
                 bandwidth_scale=(0.5, 0.9), latency_add_s=(0.0, 2e-3),
                 slowdown=(1.0, 2.0))


def _jax_fault_draws(key, num_devices, num_hops, num_windows):
    ks = jax.random.split(key, 6)
    shape = (num_devices, num_windows)
    u = [jax.random.uniform(k, s) for k, s in zip(
        ks, (shape, shape, shape, (num_hops,), (num_hops,), (num_devices,)))]
    return F.FaultDraws(*(torch.from_numpy(np.asarray(x)) for x in u))


@pytest.mark.parametrize("seed", [7, 8])
def test_sampled_schedule_matches_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    ref = JF.sample_fault_schedule(key, **SAMPLE_KW)
    kw = dict(SAMPLE_KW)
    draws = _jax_fault_draws(key, kw.pop("num_devices"), kw.pop("num_hops"),
                             kw["num_windows"])
    got = F.sample_fault_schedule(draws, SAMPLE_KW["num_devices"],
                                  SAMPLE_KW["num_hops"], **kw)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isfinite(got.outage_start.numpy()).any()


def test_sampled_schedule_is_replayable():
    kw = dict(SAMPLE_KW)
    d, h = kw.pop("num_devices"), kw.pop("num_hops")
    a = F.sample_fault_schedule(torch.Generator().manual_seed(7), d, h, **kw)
    b = F.sample_fault_schedule(torch.Generator().manual_seed(7), d, h, **kw)
    c = F.sample_fault_schedule(torch.Generator().manual_seed(8), d, h, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    assert a.num_devices == 5 and a.num_hops == 3 and a.num_windows == 2


def test_make_schedule_validation_and_jax_values():
    with pytest.raises(ValueError, match="not in"):
        F.make_schedule(2, 1, outages=[(5, 0.0, 1.0)], device=CPU)
    with pytest.raises(ValueError, match="empty"):
        F.make_schedule(2, 1, outages=[(0, 1.0, 1.0)], device=CPU)
    with pytest.raises(ValueError, match="num_windows"):
        F.make_schedule(2, 1, outages=[(0, 0.0, 1.0), (0, 2.0, 3.0)],
                        num_windows=1, device=CPU)
    kw = dict(outages=[(2, 3.0, 4.0), (0, 1.0, 2.0), (2, 0.5, 1.5)],
              hop_latency_add_s=[1e-3, 0.0], compute_slowdown=[1.0, 3.0, 1.5])
    assert _leaves_equal([x.numpy() for x in F.make_schedule(3, 2, **kw, device=CPU)],
                         JF.make_schedule(3, 2, **kw))
    assert _leaves_equal([x.numpy() for x in F.reference_schedule(4, 3, device=CPU)],
                         JF.reference_schedule(4, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            F.fault_free(2, 1)


def test_device_up_half_open_windows_and_recovery():
    outs = [(0, 1.0, 2.0), (0, 3.0, 4.0), (1, 1.5, 2.5)]
    s = F.make_schedule(3, 2, outages=outs, device=CPU)
    ref = JF.make_schedule(3, 2, outages=outs)
    up = lambda t: F.device_up(s, t).tolist()  # noqa: E731
    assert up(0.99) == [True, True, True]
    assert up(1.0) == [False, True, True]    # start is inclusive
    assert up(1.75) == [False, False, True]
    assert up(2.0) == [True, False, True]    # end is exclusive
    assert up(3.5) == [False, True, True]    # second window
    for t in (0.0, 1.0, 1.75, 2.0, 2.4, 3.5, 9.0):
        assert up(t) == np.asarray(JF.device_up(ref, t)).tolist()
        for devs in ([0, 1], [2], None):
            assert float(F.next_recovery(s, t, devs)) == float(
                JF.next_recovery(ref, t, None if devs is None else np.array(devs)))
    assert float(F.next_recovery(s, 1.75, np.array([0, 1]))) == 2.5
    assert float(F.next_recovery(s, 0.5, np.array([0, 1]))) == 0.5
    assert float(F.outage_stall(s, 1.0, np.array([0]))) == pytest.approx(1.0)
    assert float(F.outage_stall(s, 0.0, np.array([2]))) == 0.0


def test_fault_clock_mapping():
    tickc = F.FaultClock(tick_seconds=0.02)
    assert tickc.time_of(5, now=99.0) == pytest.approx(0.1)
    assert tickc.ticks_until(0.08, 0.18) == 5
    assert tickc.ticks_until(0.08, 0.08) == 1   # always progress
    wallc = F.FaultClock()
    assert wallc.time_of(5, now=99.0) == 99.0
    assert wallc.ticks_until(0.0, 10.0) == 1


# ---------------------------------------------------------------------------
# scenario degradation


def test_degrade_fault_free_is_bit_exact_noop(env):
    sp = env.scenario()
    sp2 = F.degrade_scenario(sp, F.fault_free(env.U + 1, env.S - 1, device=CPU))
    assert all(torch.equal(a, b) for a, b in zip(sp, sp2))


def test_degrade_scenario_hop_count_mismatch(env):
    with pytest.raises(ValueError, match="hops"):
        F.degrade_scenario(env.scenario(), F.fault_free(env.U + 1, env.S, device=CPU))


def test_degrade_scenario_scales_links_as_jax(env):
    h = env.S - 1
    kw = dict(hop_bandwidth_scale=[0.5, 0.7, 0.9][:h] + [0.5] * (h - 3),
              hop_latency_add_s=[1e-3] * h)
    sp2 = F.degrade_scenario(env.scenario(), F.make_schedule(env.U + 1, h, **kw,
                                                             device=CPU))
    jsp = JSC.scenario_from_net(JNet())
    ref = JF.degrade_scenario(jsp, JF.make_schedule(env.U + 1, h, **kw))
    np.testing.assert_array_equal(sp2.hop_bandwidth_hz.numpy(),
                                  np.asarray(ref.hop_bandwidth_hz))
    np.testing.assert_array_equal(sp2.hop_latency_s.numpy(),
                                  np.asarray(ref.hop_latency_s))


# ---------------------------------------------------------------------------
# Eq. 10 consistency of the faulted executor accounting


@pytest.mark.parametrize("s", [2, 4])
def test_faulted_m1_sync_matches_plan_cost_under_degraded_scenario(s):
    prof, plan, pos, p_tx, decoy, net = _setup(s)
    sp = scenario_from_net(net, device=CPU)
    h = max(s, 4) - 1
    sched = F.make_schedule(net.num_devices + 1, h, hop_bandwidth_scale=[0.7] * h,
                            hop_latency_add_s=[2e-3] * h, device=CPU)
    t_ref, _ = plan_cost(prof, plan, pos, p_tx, decoy, F.degrade_scenario(sp, sched))
    model = faulted_transport_model(prof, plan, pos, p_tx, decoy, sp, sched)
    sim = simulate_1f1b(model, 1, transport="sync")
    np.testing.assert_allclose(sim["total_s"], float(t_ref), rtol=1e-12)


def test_faulted_model_fault_free_is_exact():
    prof, plan, pos, p_tx, decoy, net = _setup(4)
    sp = scenario_from_net(net, device=CPU)
    sched = F.fault_free(net.num_devices + 1, 3, device=CPU)
    base = plan_transport_model(prof, plan, pos, p_tx, decoy, sp)
    faulted = faulted_transport_model(prof, plan, pos, p_tx, decoy, sp, sched)
    for f in ("t_comp_fwd", "t_comp_bwd", "t_tx_fwd", "t_tx_bwd", "hop_latency"):
        np.testing.assert_array_equal(getattr(base, f), getattr(faulted, f))
    a = simulate_1f1b(base, 4)
    b = simulate_1f1b_faulted(base, 4, sched, plan.devices)
    assert b["total_s"] == a["total_s"] and b["stall_s"] == 0.0
    np.testing.assert_array_equal(a["per_tick_s"], b["per_tick_s"])


def test_straggler_scales_assigned_stage_compute():
    prof, plan, pos, p_tx, decoy, net = _setup(4)
    sp = scenario_from_net(net, device=CPU)
    slow = [1.0] * (net.num_devices + 1)
    slow[plan.devices[1]] = 3.0   # stage 1's device straggles
    sched = F.make_schedule(net.num_devices + 1, 3, compute_slowdown=slow, device=CPU)
    base = plan_transport_model(prof, plan, pos, p_tx, decoy, sp)
    faulted = faulted_transport_model(prof, plan, pos, p_tx, decoy, sp, sched)
    np.testing.assert_allclose(faulted.t_comp_fwd[1], base.t_comp_fwd[1] * 3.0)
    np.testing.assert_array_equal(faulted.t_comp_fwd[[0, 2, 3]],
                                  base.t_comp_fwd[[0, 2, 3]])
    np.testing.assert_array_equal(faulted.t_tx_fwd, base.t_tx_fwd)


def test_outage_stalls_add_exactly():
    """An outage opening at tick 1's start on stage 0's device stalls it
    to the window's end; total = fault-free total + stall."""
    prof, plan, pos, p_tx, decoy, net = _setup(3)
    sp = scenario_from_net(net, device=CPU)
    model = plan_transport_model(prof, plan, pos, p_tx, decoy, sp)
    base = simulate_1f1b(model, 2, transport="sync")
    t1 = float(base["per_tick_s"][0])
    sched = F.make_schedule(net.num_devices + 1, 2,
                            outages=[(plan.devices[0], t1, t1 + 0.5)], device=CPU)
    sim = simulate_1f1b_faulted(model, 2, sched, plan.devices, transport="sync")
    np.testing.assert_allclose(sim["per_tick_stall_s"][1], 0.5, rtol=1e-6)
    np.testing.assert_allclose(sim["stall_s"], 0.5, rtol=1e-6)
    np.testing.assert_allclose(sim["total_s"], base["total_s"] + 0.5, rtol=1e-6)


@pytest.mark.parametrize("transport", ["sync", "overlap"])
def test_faulted_transport_matches_jax(transport):
    """Degraded links, a straggler and two outage windows: the faulted
    model's terms and the faulted simulation against the reference's on
    the same inputs."""
    prof, plan, pos, p_tx, decoy, net = _setup(4)
    jprof, jplan, _, _, _, jnet = _setup(4, jax_side=True)
    # windows over the fault-free starts of ticks 1 (stage 1's device) and
    # 3 (the server)
    start = np.cumsum(simulate_1f1b(plan_transport_model(
        prof, plan, pos, p_tx, decoy, net), 3, transport=transport)["per_tick_s"])
    kw = dict(outages=[(1, 0.5 * start[0], start[0] + 2.0),
                       (8, start[2] + 3.0, start[2] + 9.0)],
              hop_bandwidth_scale=[0.6, 0.8, 0.9], hop_latency_add_s=[1e-3, 0.0, 3e-3],
              compute_slowdown=[1.0, 2.5] + [1.0] * 7)
    sched = F.make_schedule(net.num_devices + 1, 3, **kw, device=CPU)
    jsched = JF.make_schedule(net.num_devices + 1, 3, **kw)
    model = faulted_transport_model(prof, plan, pos, p_tx, decoy,
                                    scenario_from_net(net, device=CPU), sched)
    ref = JT.faulted_transport_model(jprof, jplan, pos, p_tx, decoy,
                                     JSC.scenario_from_net(jnet), jsched)
    for f in ("t_comp_fwd", "t_comp_bwd", "t_tx_fwd", "t_tx_bwd", "hop_latency"):
        np.testing.assert_allclose(getattr(model, f), getattr(ref, f),
                                   rtol=JAX_RTOL, err_msg=f)
    sim = simulate_1f1b_faulted(model, 3, sched, plan.devices, transport=transport)
    jsim = JT.simulate_1f1b_faulted(ref, 3, jsched, plan.devices, transport=transport)
    assert sim["stall_s"] > 0
    for k in ("total_s", "stall_s", "compute_s", "transport_s", "bubble_fraction"):
        np.testing.assert_allclose(sim[k], jsim[k], rtol=JAX_RTOL, err_msg=k)
    np.testing.assert_allclose(sim["per_tick_stall_s"], jsim["per_tick_stall_s"],
                               rtol=JAX_RTOL)


def test_fault_injection_moves_the_oracle(env):
    """Scoring under sampled schedules (degraded links, their masks)
    through one oracle: degradation moves the delay, and a mask that
    kills a device of the assignment makes every plan infeasible."""
    oracle = env.make_split_oracle()
    st = env.reset(env.sample_positions(torch.Generator().manual_seed(0), 1))
    devices = torch.tensor(tuple(range(env.S - 1)) + (env.U,))
    sp = env.scenario()
    p_tx = torch.full((env.S - 1,), float(sp.power_levels[0]))
    decoy = torch.zeros((env.S - 1, env.U + 1))
    delays = []
    for i in range(3):
        sched = F.sample_fault_schedule(
            torch.Generator().manual_seed(i), env.U + 1, env.S - 1, horizon_s=1.0,
            bandwidth_scale=(0.4, 1.0), slowdown=(1.0, 2.0))
        out = oracle(st.dev_pos[0], devices, p_tx, decoy,
                     F.degrade_scenario(sp, sched),
                     device_mask=F.device_up(sched, 0.0))
        delays.append(out["delay"])
    assert any(not torch.equal(d, delays[0]) for d in delays[1:])
    dead = F.make_schedule(env.U + 1, env.S - 1, outages=[(0, 0.0, 1.0)], device=CPU)
    out = oracle(st.dev_pos[0], devices, p_tx, decoy, sp,
                 device_mask=F.device_up(dead, 0.5))
    assert not bool(out["feasible"].any())


# ---------------------------------------------------------------------------
# the serving queue and fault-injected serving


def _mk_queue(plens):
    reqs = [Request(rid=i, prompt=np.ones(p, np.int32), gen_target=1,
                    arrival_time=0.0) for i, p in enumerate(plens)]
    q = RequestQueue(reqs)
    q.advance(0.0)
    return q, reqs


def test_requeue_front_preserves_order():
    q, reqs = _mk_queue([2, 2, 2, 2])
    taken = q.pop(2)
    q.requeue_front(taken)
    assert [r.rid for r in q.peek(4)] == [0, 1, 2, 3]
    # evicted requests jump ahead of later arrivals
    q.pop(1)
    q.requeue_front([reqs[3]])
    assert [r.rid for r in q.peek(3)] == [3, 1, 2]


SERVE_KW = dict(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
                decode_chunk=2, fault_tick_s=0.02, max_retries=2,
                retry_backoff_s=0.005)


@pytest.fixture(scope="module")
def served():
    """``tests/test_chaos.py``'s pair on the port's reduced model: a
    fault-free run and a run under the reference schedule."""
    cfg = ServeConfig(**SERVE_KW)
    svc_free = ServingService(cfg, device=CPU)
    trace = poisson_trace(n_requests=7, rate_per_sec=50.0,
                          vocab_size=svc_free.model_cfg.vocab_size,
                          plen_range=(2, 8), gen_range=(2, 8), seed=3)
    free = svc_free.run(list(trace))
    svc = ServingService(cfg, svc_free.params, device=CPU)
    sched = F.reference_schedule(1, 1, tick_seconds=cfg.fault_tick_s, device=CPU)
    faulted = svc.run(list(trace), faults=sched)
    return trace, free, faulted


def test_serving_fault_injection_invariants(served):
    trace, free, faulted = served
    assert faulted["num_requests"] == len(trace) == free["num_requests"]
    assert faulted["fault_events"] >= 1
    assert faulted["recovery_ticks"] >= 1
    assert faulted["retries"] >= 1
    assert free["fault_events"] == 0 and free["evictions"] == 0
    assert free["recovery_ticks"] == 0 and free["expired"] == []
    # every completion bitwise the fault-free run's: untouched requests
    # by slot independence, evicted ones by request-keyed sampling
    for r in trace:
        assert np.array_equal(free["completions"][r.rid],
                              faulted["completions"][r.rid]), r.rid


def test_serving_under_faults_evicts_and_replans():
    """A pipelined service (2 stages) whose stage-1 device is down from
    the first tick for longer than the backoff: every in-flight request
    is evicted and requeued, the replanner is asked to route around the
    dead device, and the tokens still equal the fault-free run's."""
    cfg = ServeConfig(**dict(SERVE_KW, max_retries=1), boundaries=(1, 2))
    svc = ServingService(cfg, device=CPU)
    trace = poisson_trace(n_requests=4, rate_per_sec=1000.0,
                          vocab_size=svc.model_cfg.vocab_size, plen_range=(2, 8),
                          gen_range=(4, 8), seed=5)
    free = ServingService(cfg, svc.params, device=CPU).run(list(trace))

    class Replanner:
        def __init__(self):
            self.calls = []

        def replan(self, *, load, exclude_devices=()):
            self.calls.append((load, tuple(exclude_devices)))
            return {"excluded": tuple(exclude_devices)}

    rp = Replanner()
    svc.attach_replanner(rp)
    sched = F.make_schedule(2, 1, outages=[(1, 0.04, 0.2)], device=CPU)
    res = svc.run(list(trace), faults=sched)
    assert svc.stage_devices == (0, 1)
    assert res["fault_events"] >= 1 and res["evictions"] >= 1
    assert (0.0, (1,)) in rp.calls
    assert {r["excluded"] for r in res["replans"]} == {(1,)}
    for r in trace:
        assert np.array_equal(free["completions"][r.rid], res["completions"][r.rid])


def test_serving_deadline_expiry_under_faults():
    """A request whose deadline passes while it waits out an outage is
    dropped and reported; the others complete."""
    cfg = ServeConfig(num_slots=2, arrival_slots=2, prompt_pad=8, max_new=4,
                      decode_chunk=2, fault_tick_s=0.02, max_retries=1,
                      retry_backoff_s=0.005)
    svc = ServingService(cfg, device=CPU)
    v = svc.model_cfg.vocab_size
    rng = np.random.default_rng(0)
    mk = lambda rid, t, dl: Request(  # noqa: E731
        rid=rid, prompt=rng.integers(0, v, 4).astype(np.int32),
        gen_target=3, arrival_time=t, deadline=dl)
    # device 0 is down for ticks [0, 10): the service stalls 0.2 s of
    # virtual time before serving, past rid 1's deadline
    trace = [mk(0, 0.0, float("inf")), mk(1, 0.0, 0.1)]
    sched = F.make_schedule(1, 1, outages=[(0, 0.0, 0.2)], device=CPU)
    res = svc.run(trace, faults=sched)
    assert res["fault_events"] >= 1
    assert res["expired"] == [1]
    assert sorted(res["completions"]) == [0]
