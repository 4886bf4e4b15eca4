"""The port's serving engine, on the CPU: against the JAX package's
service, and bitwise against its own single-request reference.

* Greedy completions of ``generate_static`` and of the engine on a
  ``poisson_trace`` against the JAX package's ``ServingService`` on the
  same weights and trace, under the tie rule below.
* The engine bitwise equal to the port's ``generate_reference``, greedy
  and at temperature 0.7 (per-(request, token) counter draws); a slot
  reused after its KV ring is poisoned with large finite garbage; an
  eviction mid-flight; the scheduler and queue; ``check_servable``.
* ``ServeConfig`` read from one JSON file by both packages; the Poisson
  trace draw for draw; the ``OnlineReplanner`` decisions against JAX's
  with the geometry (``dev_pos``) shared; the replan cadence; the
  launcher on the CPU; entry points default to the card.

Tie rule (port vs JAX): tokens are compared up to the first mismatch. A
mismatch passes only if the JAX model's top-2 logit gap at that step,
recomputed by a teacher-forced f32 forward, is under ``TIE_ATOL``: two
f32 implementations that sum in other orders may split a near-tie
either way (their f32 logits differ by ~1e-6). Within the port, engine
vs reference, equality is exact.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.serving import ServingService as JServingService  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    OnlineReplanner, Request, RequestQueue, ServeConfig, ServingService,
    SingleDeviceRunner, SlotScheduler, decode_python_loop, evict_slots,
    generate_reference, generate_static, init_engine_state, make_engine_step,
    poisson_trace, sample_token)
from repro_torch.serving.batching import _row_sample, _uniform  # noqa: E402
from repro_torch.serving.runners import check_servable  # noqa: E402

TIE_ATOL = 1e-4
ENGINE_KW = dict(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
                 decode_chunk=2)


def _trace(vocab, n=7, seed=3, rate=50.0, plen=(2, 8), gen=(2, 8)):
    return poisson_trace(n_requests=n, rate_per_sec=rate, vocab_size=vocab,
                         plen_range=plen, gen_range=gen, seed=seed)


def _port_model(num_layers=2, seed=0):
    cfg = ServeConfig(num_layers=num_layers).model_config()
    params = TM.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cfg, params


def _tie_ok(jcfg, jparams, prompt, ref, got):
    """Tokens equal, or equal up to a step where the JAX model's top-2
    gap is under TIE_ATOL (the rest then follows another history)."""
    ref, got = np.asarray(ref), np.asarray(got)
    n = min(len(ref), len(got))
    bad = np.flatnonzero(ref[:n] != got[:n])
    if len(ref) != len(got) and not len(bad):
        return False
    if not len(bad):
        return True
    k = int(bad[0])
    seq = np.concatenate([np.asarray(prompt), ref[:k]]).astype(np.int32)
    logits, _, _ = JM.forward(jparams, jnp.asarray(seq[None]), jcfg,
                              compute_dtype=jnp.float32)
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    gap = float(top2[1] - top2[0])
    print(f"tie rule: mismatch at step {k}, JAX top-2 gap {gap:.3e}")
    return gap < TIE_ATOL


# ---------------------------------------------------------------------------
# against the JAX package's service
# ---------------------------------------------------------------------------


def test_greedy_completions_match_jax_service():
    """The same weights (JAX's, carried over) and the same Poisson trace:
    the port's engine and its ``generate_static`` give the JAX
    ``ServingService``'s greedy tokens."""
    jsvc = JServingService(JServeConfig(**ENGINE_KW))
    trace = _trace(jsvc.model_cfg.vocab_size)
    jres = jsvc.run(list(trace))
    params = W.model_params_from_jax(jax.tree.map(np.asarray, jsvc.params), "cpu")
    svc = ServingService(ServeConfig(**ENGINE_KW), params, device="cpu")
    res = svc.run(list(trace))
    assert res["num_requests"] == jres["num_requests"] == len(trace)
    prompts = np.zeros((len(trace), 8), np.int64)
    for i, r in enumerate(trace):
        prompts[i, :r.plen] = r.prompt
    toks, n_gen = generate_static(
        svc.runner, params, prompts, [r.plen for r in trace],
        [r.gen_target for r in trace], max_new=8,
        req_ids=[r.rid for r in trace])
    for i, r in enumerate(trace):
        ref = jres["completions"][r.rid]
        assert _tie_ok(jsvc.model_cfg, jsvc.params, r.prompt, ref,
                       res["completions"][r.rid]), r.rid
        assert _tie_ok(jsvc.model_cfg, jsvc.params, r.prompt, ref,
                       toks[i, :int(n_gen[i])].numpy()), r.rid


# ---------------------------------------------------------------------------
# the engine against the port's own reference, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_engine_bitwise_matches_reference(temperature):
    """7 requests through 3 slots (arrivals mid-flight, every slot
    reused): every completion equals ``generate_reference`` bitwise."""
    cfg = ServeConfig(temperature=temperature, **ENGINE_KW)
    svc = ServingService(cfg, device="cpu")
    trace = _trace(svc.model_cfg.vocab_size)
    res = svc.run(trace)
    assert res["num_requests"] == len(trace)
    assert 0.0 < res["slot_occupancy"] <= 1.0
    for r in trace:
        ref = generate_reference(
            svc.runner, svc.params, r.prompt, gen_target=r.gen_target,
            max_new=cfg.max_new, prompt_pad=cfg.prompt_pad,
            slots=cfg.num_slots, temperature=temperature,
            base_key=svc.base_key, req_id=r.rid)
        got = res["completions"][r.rid]
        assert len(got) == r.gen_target
        assert np.array_equal(got, ref.numpy()), (r.rid, got, ref)


def _admit_and_drain(step, params, state, rid, prompt, gen, p):
    ap = np.zeros((1, p), np.int64)
    ap[0, :len(prompt)] = prompt
    args = (ap, [len(prompt)], [gen], [rid])
    state, rep = step(params, state, *args, 1)
    while bool(rep["active"].any()):
        state, rep = step(params, state, *args, 0)
    slot = rep["req_id"].tolist().index(rid)
    return state, state.gen_buf[slot, :int(rep["n_gen"][slot])]


def test_slot_reuse_survives_poisoned_stale_cache():
    """Freed slots are NOT zeroed; correctness rests on stale FINITE
    values being masked into exact-zero attention weights. Every KV ring
    poisoned with 1e4 between requests: the next request still matches
    the reference bitwise."""
    cfg, params = _port_model()
    runner = SingleDeviceRunner(cfg, device="cpu")
    n, p, g = 2, 6, 6
    step = make_engine_step(runner, num_slots=n, arrival_slots=1,
                            prompt_pad=p, max_new=g, decode_chunk=3)
    state = init_engine_state(runner, n, p, g)
    rng = np.random.default_rng(5)
    state, _ = _admit_and_drain(step, params, state, 0,
                                rng.integers(0, cfg.vocab_size, 5), 4, p)
    state = state._replace(caches=tuple(
        {k: torch.full_like(v, 1e4) for k, v in c.items()} for c in state.caches))
    pr_b = rng.integers(0, cfg.vocab_size, 4)
    state, got = _admit_and_drain(step, params, state, 1, pr_b, 5, p)
    ref = generate_reference(runner, params, pr_b, gen_target=5, max_new=g,
                             prompt_pad=p, slots=n, req_id=1)
    assert torch.equal(got, ref)


def test_evict_slots_frees_without_touching_the_rest():
    """Evicting one slot mid-flight frees it (inactive, id -1, count 0),
    leaves its caches as they were, and the other slot's request still
    completes bitwise as its reference."""
    cfg, params = _port_model()
    runner = SingleDeviceRunner(cfg, device="cpu")
    n, p, g = 2, 6, 8
    step = make_engine_step(runner, num_slots=n, arrival_slots=2,
                            prompt_pad=p, max_new=g, decode_chunk=2)
    state = init_engine_state(runner, n, p, g)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 5), rng.integers(0, cfg.vocab_size, 3)]
    ap = np.zeros((2, p), np.int64)
    for i, pr in enumerate(prompts):
        ap[i, :len(pr)] = pr
    state, rep = step(params, state, ap, [5, 3], [8, 7], [10, 11], 2)
    assert rep["admitted"].tolist() == [True, True]
    before = [c["k"].clone() for c in state.caches]
    state = evict_slots(state, np.array([True, False]))
    assert state.active.tolist() == [False, True]
    assert state.req_id.tolist() == [-1, 11] and int(state.n_gen[0]) == 0
    assert all(torch.equal(a, c["k"]) for a, c in zip(before, state.caches))
    z = (np.zeros((2, p), np.int64), [1, 1], [1, 1], [-1, -1])
    while bool(state.active.any()):
        state, rep = step(params, state, *z, 0)
    got = state.gen_buf[1, :int(state.n_gen[1])]
    ref = generate_reference(runner, params, prompts[1], gen_target=7,
                             max_new=g, prompt_pad=p, slots=n, req_id=11)
    assert torch.equal(got, ref)


def test_generate_static_matches_python_loop():
    cfg, params = _port_model()
    runner = SingleDeviceRunner(cfg, device="cpu")
    rng = np.random.default_rng(1)
    b, p, g = 4, 6, 8
    plens = np.asarray([6, 3, 5, 2])
    prompts = rng.integers(0, cfg.vocab_size, (b, p)) * (np.arange(p)[None] < plens[:, None])
    gens = [8, 2, 5, 1]
    for t in (0.0, 0.7):
        fused, n_f = generate_static(runner, params, prompts, plens, gens,
                                     max_new=g, temperature=t)
        loop, n_l = decode_python_loop(runner, params, prompts, plens, gens,
                                       max_new=g, temperature=t)
        assert torch.equal(n_f, n_l) and torch.equal(fused, loop)


def test_counter_sampling_depends_on_request_and_token_only():
    """A row's draw is a function of (seed, request, token index): the
    same in any row order, different for another request, token or seed;
    uniforms inside (0, 1); and a categorical sampled this way follows
    its softmax (chi-square over 4 000 requests)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    rid = torch.tensor([3, 8, 1, 0, 42])
    tok = torch.tensor([0, 5, 2, 7, 1])
    a = _row_sample(logits, 7, rid, tok, 0.7)
    perm = torch.tensor([4, 2, 0, 3, 1])
    b = _row_sample(logits[perm], 7, rid[perm], tok[perm], 0.7)
    assert torch.equal(a[perm], b)
    u = _uniform(7, rid, tok, 64)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert not torch.equal(u, _uniform(8, rid, tok, 64))
    assert not torch.equal(u, _uniform(7, rid + 1, tok, 64))
    assert not torch.equal(u, _uniform(7, rid, tok + 1, 64))
    assert torch.equal(sample_token(logits, 7, 0.0), logits.argmax(-1))
    probs = np.asarray([0.1, 0.2, 0.3, 0.4])
    lg = torch.log(torch.from_numpy(probs).float()).expand(4000, 4)
    draws = _row_sample(lg, 1, torch.arange(4000), torch.zeros(4000, dtype=torch.long), 1.0)
    counts = np.bincount(draws.numpy(), minlength=4)
    chi2 = float(((counts - 4000 * probs) ** 2 / (4000 * probs)).sum())
    assert chi2 < 16.27  # p = 0.001 at 3 degrees of freedom


# ---------------------------------------------------------------------------
# host-side scheduler, queue, gates
# ---------------------------------------------------------------------------


def test_scheduler_packs_bounded_by_free_slots():
    q = RequestQueue([Request(rid=i, prompt=np.arange(3, dtype=np.int32),
                              gen_target=2, arrival_time=0.0)
                      for i in range(5)])
    q.advance(1.0)
    sched = SlotScheduler(arrival_slots=4, prompt_pad=8)
    reqs, ap, al, ag, ar, n_arr = sched.pack(q, free_slots=2)
    assert [r.rid for r in reqs] == [0, 1] and n_arr == 2
    assert ap.shape == (4, 8) and list(ar) == [0, 1, -1, -1]
    reqs, *_, n_arr = sched.pack(q, free_slots=99)  # capped by arrival_slots
    assert [r.rid for r in reqs] == [2, 3, 4] and n_arr == 3
    assert q.exhausted
    bad = RequestQueue([Request(rid=0, prompt=np.zeros(9, np.int32), gen_target=1)])
    bad.advance(0.0)
    with pytest.raises(ValueError, match="exceeds prompt_pad"):
        SlotScheduler(arrival_slots=1, prompt_pad=8).pack(bad, 1)
    assert bad.pending == 1  # nothing lost


def test_deadline_drops_queued_requests():
    """A request still queued past its deadline (its own, or ``arrival +
    deadline_s`` when that is sooner) is dropped and reported under
    ``expired``; the rest complete."""
    cfg = ServeConfig(num_slots=1, arrival_slots=1, prompt_pad=8, max_new=8,
                      decode_chunk=8, deadline_s=30.0)
    svc = ServingService(cfg, device="cpu")
    trace = [Request(rid=i, prompt=np.arange(1, 4, dtype=np.int32),
                     gen_target=8, arrival_time=0.0,
                     deadline=1e-9 if i == 2 else float("inf"))
             for i in range(3)]
    res = svc.run(trace)
    assert res["expired"] == [2] and sorted(res["completions"]) == [0, 1]
    svc = ServingService(dataclasses.replace(cfg, deadline_s=1e-9), device="cpu")
    res = svc.run(trace)
    assert res["expired"] == [0, 1, 2] and res["num_requests"] == 0
    # under a fault schedule (device 0 down for the first 0.05 s of the
    # virtual clock) the deadlines hold the same way
    from repro_torch.core.faults import make_schedule

    svc = ServingService(cfg, device="cpu")
    res = svc.run(trace, faults=make_schedule(1, 1, outages=[(0, 0.0, 0.05)],
                                              device="cpu"))
    assert res["fault_events"] >= 1
    assert res["expired"] == [2] and sorted(res["completions"]) == [0, 1]


def test_check_servable_moe_and_ssm_gates():
    from repro_torch.configs import get_config

    with pytest.raises(ValueError, match="SSM/hybrid"):
        check_servable(get_config("jamba-v0.1-52b").reduced())
    with pytest.raises(ValueError, match="SSM/hybrid"):
        check_servable(get_config("mamba2-370m").reduced())
    moe = get_config("qwen3-moe-30b-a3b").reduced()
    check_servable(moe)
    with pytest.raises(ValueError, match="dropless"):
        check_servable(dataclasses.replace(
            moe, moe=dataclasses.replace(moe.moe, dispatch="capacity")))


def test_serve_config_json_on_both_sides(tmp_path):
    """One JSON file configures both packages: the same fields, the same
    model config, the same overrides and the same unknown-key error."""
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"num_slots": 16, "boundaries": [1, 2],
                                "arch": "qwen3_moe_30b_a3b", "temperature": 0.7}))
    over = {k: ServeConfig.parse_override(k, v) for k, v in
            (("decode_chunk", "2"), ("reduced", "true"), ("wire_dtype", "bfloat16"))}
    jover = {k: JServeConfig.parse_override(k, v) for k, v in
             (("decode_chunk", "2"), ("reduced", "true"), ("wire_dtype", "bfloat16"))}
    assert over == jover
    cfg = ServeConfig.load(str(path), over)
    jcfg = JServeConfig.load(str(path), jover)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_slots, cfg.decode_chunk, cfg.boundaries) == (16, 2, (1, 2))
    assert dataclasses.asdict(cfg.model_config()) == dataclasses.asdict(jcfg.model_config())
    assert ServeConfig.parse_override("boundaries", "2,4") == (2, 4)
    for cls in (ServeConfig, JServeConfig):
        with pytest.raises(KeyError):
            cls.load(None, {"num_slotz": 4})


def test_poisson_trace_matches_jax():
    from repro.serving import poisson_trace as jtrace

    kw = dict(n_requests=12, rate_per_sec=5.0, vocab_size=64,
              plen_range=(2, 6), gen_range=(1, 4), seed=4)
    for a, b in zip(poisson_trace(**kw), jtrace(**kw)):
        assert (a.rid, a.gen_target, a.arrival_time) == (b.rid, b.gen_target, b.arrival_time)
        assert np.array_equal(a.prompt, b.prompt)


def test_idle_ticks_skip_the_prefill():
    """The prefill runs only on ticks with arrivals and a free slot, as
    the host counts them: a tick with no arrivals, or with arrivals but
    every slot busy, decodes without calling the runner's prefill, and
    the requests in flight still complete bitwise as their references."""
    cfg, params = _port_model()
    runner = SingleDeviceRunner(cfg, device="cpu")
    n, p, g = 2, 6, 8
    step = make_engine_step(runner, num_slots=n, arrival_slots=2,
                            prompt_pad=p, max_new=g, decode_chunk=2)
    calls = []
    prefill = runner.prefill
    runner.prefill = lambda *a: calls.append(1) or prefill(*a)
    state = init_engine_state(runner, n, p, g)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 4), rng.integers(0, cfg.vocab_size, 6)]
    ap = np.zeros((2, p), np.int64)
    for i, pr in enumerate(prompts):
        ap[i, :len(pr)] = pr
    state, _ = step(params, state, ap, [4, 6], [7, 8], [3, 4], 2, free_slots=n)
    assert len(calls) == 1
    z = (np.zeros((2, p), np.int64), [1, 1], [1, 1], [-1, -1])
    state, _ = step(params, state, *z, 0)
    state, _ = step(params, state, ap, [4, 6], [7, 8], [5, 6], 2, free_slots=0)
    assert len(calls) == 1
    assert state.req_id.tolist() == [3, 4]
    while bool(state.active.any()):
        state, _ = step(params, state, *z, 0)
    assert len(calls) == 1
    runner.prefill = prefill
    for slot, (pr, gen, rid) in enumerate(zip(prompts, (7, 8), (3, 4))):
        ref = generate_reference(runner, params, pr, gen_target=gen, max_new=g,
                                 prompt_pad=p, slots=n, req_id=rid)
        assert torch.equal(state.gen_buf[slot, :int(state.n_gen[slot])], ref)


# ---------------------------------------------------------------------------
# online re-planner
# ---------------------------------------------------------------------------


def _envs():
    from repro.core.env import MHSLEnv as JEnv
    from repro.core.profiles import resnet101_profile as jprof
    from repro_torch.core.env import MHSLEnv as TEnv
    from repro_torch.core.profiles import resnet101_profile as tprof

    return (JEnv(profile=jprof(batch=1)),
            TEnv(profile=tprof(batch=1), device="cpu"))


def test_replanner_matches_jax():
    """With the JAX replanner's geometry shared, the port's decisions
    (rotations of the trainer ring, a dead device excluded, drained
    energy) equal JAX's: the same plan and devices, delay and energy at
    the plan scorer's f32 gate."""
    from repro.serving import OnlineReplanner as JReplanner

    jenv, tenv = _envs()
    kw = dict(bandwidth_sensitivity=0.5, energy_drain=0.1,
              candidate_assignments="rotations")
    jr = JReplanner(jenv, **kw)
    tr = OnlineReplanner(tenv, **kw)
    assert tr.assignments == jr.assignments
    tr.dev_pos = torch.as_tensor(np.array(jr.dev_pos))
    for load, excl in ((0.0, ()), (0.4, (1,)), (0.9, (0, 2))):
        jd = jr.replan(load=load, exclude_devices=excl)
        td = tr.replan(load=load, exclude_devices=excl)
        for k in ("boundaries", "devices", "feasible", "any_feasible",
                  "num_plans", "excluded", "load"):
            assert td[k] == jd[k], (load, k)
        np.testing.assert_allclose(td["delay"], jd["delay"], rtol=2e-6)
        np.testing.assert_allclose(td["energy"], jd["energy"], rtol=2e-6)


def test_service_replan_cadence():
    cfg = ServeConfig(num_slots=2, arrival_slots=2, prompt_pad=8, max_new=4,
                      decode_chunk=4, replan_every=1)
    svc = ServingService(cfg, device="cpu")
    svc.attach_replanner(OnlineReplanner(_envs()[1]))
    res = svc.run(_trace(svc.model_cfg.vocab_size, n=3, gen=(1, 4)))
    assert res["num_requests"] == 3
    assert len(res["replans"]) == res["ticks"]
    assert all(len(r["boundaries"]) > 0 for r in res["replans"])


# ---------------------------------------------------------------------------
# launcher and devices
# ---------------------------------------------------------------------------


def test_launch_serve_main_on_cpu(tmp_path, capsys):
    """``launch.serve.main`` on the CPU, engine and static modes on one
    trace and config file: every request served, and the same tokens."""
    from repro_torch.launch import serve as LS

    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"num_slots": 3, "max_new": 6,
                                "prompt_pad": 8}))
    argv = ["--device", "cpu", "--config", str(path), "--requests", "5",
            "--rate", "40", "--set", "decode_chunk", "3", "--json"]
    eng = LS.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["num_requests"] == 5 and line["tokens_per_sec"] > 0
    st = LS.main(argv + ["--mode", "static"])
    assert eng["completions"].keys() == st["completions"].keys()
    for rid, toks in eng["completions"].items():
        assert np.array_equal(toks, st["completions"][rid])
    assert 0 < st["slot_occupancy"] <= 1


def test_serving_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the runners, the service, the static baseline and
    the launcher raise unless the caller asks for the CPU."""
    from repro_torch.launch import serve as LS
    from repro_torch.serving import PipelineRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig(num_layers=2)
    with pytest.raises(RuntimeError):
        SingleDeviceRunner(cfg.model_config())
    with pytest.raises(RuntimeError):
        PipelineRunner(cfg.model_config(), (1, 2))
    with pytest.raises(RuntimeError):
        ServingService(cfg)
    with pytest.raises(RuntimeError):
        LS.run_static(cfg, [])
    with pytest.raises(RuntimeError):
        LS.main(["--requests", "1"])
    with pytest.raises(RuntimeError):
        TM.init_caches(cfg.model_config(), 2, 8)
    assert SingleDeviceRunner(cfg.model_config(), device="cpu").device.type == "cpu"
