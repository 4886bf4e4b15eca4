"""The port's attacker population and EmpiricalLeakage against the JAX
package's ``repro.attack`` and ``repro.core.leakage.EmpiricalLeakage``.

Inputs are shared, never regenerated: the attacker's params and AdamW
state go across through ``repro_torch.weights``, pools are drawn with
numpy, and each chunk's draws are the reference's own, replayed with the
same ``split`` / ``randint`` / ``uniform`` calls as
``repro.attack.fsha.make_attack_chunk``. Tolerances were set from the
measured error (XLA and torch order f32 sums differently): one chunk
``TOL`` (rtol 1e-4, atol 1e-5); a trained population's scores and MSEs
``POP_TOL`` (atol 1e-4). Bitwise where the reference claims bitwise: a
population of one against the single chunk, and zero capture ignoring
the client pool. A population of N against N single chunks: ``POP_N``
(atol 1e-6), the batched matmuls summing in another order.
"""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import attack as JA  # noqa: E402
from repro.attack import fsha as JF  # noqa: E402
from repro.core import leakage as JLK  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import attack as TA  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.attack import fsha as TF  # noqa: E402
from repro_torch.attack import population as TP  # noqa: E402
from repro_torch.core import leakage as TLK  # noqa: E402
from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.profiles import profile_table, resnet101_profile  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_index, tree_leaves, tree_map  # noqa: E402

CFG_J = JF.AttackConfig(d_data=6, d_smash=6, feat_dim=8, hidden=8, batch=16)
CFG_T = TF.AttackConfig(**dataclasses.asdict(CFG_J))
POOL = 48
STEPS = 12
TOL = dict(rtol=1e-4, atol=1e-5)
POP_N = dict(rtol=0, atol=1e-6)
POP_TOL = dict(rtol=0, atol=1e-4)
DATA = Path(__file__).resolve().parent / "data" / "torch_attack_reference.json"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pools(seed, n=None):
    rng = np.random.default_rng(seed)
    shape = (POOL,) if n is None else (n, POOL)
    return {k: rng.standard_normal(shape + (d,)).astype(np.float32)
            for k, d in (("z_cli", CFG_J.d_smash), ("x_cli", CFG_J.d_data),
                         ("z_aux", CFG_J.d_smash), ("x_aux", CFG_J.d_data))}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_chunk_draws(keys, batch, pool):
    def one(k):
        ki, kc = jax.random.split(k)
        return jax.random.randint(ki, (batch,), 0, pool), jax.random.uniform(kc)

    return jax.vmap(one)(keys)


def _jax_draws(key, steps, batch, pool):
    """The draws ``make_attack_chunk`` takes from ``key``: split into
    ``steps`` step keys, each split into (randint, uniform), as its scan
    body does."""
    idx, u = _jax_chunk_draws(jax.random.split(key, steps), batch, pool)
    return TF.AttackDraws(idx=torch.from_numpy(np.asarray(idx)).long(),
                          u=torch.from_numpy(np.asarray(u, np.float32)))


def _close(a, b, tol, what=""):
    for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64), err_msg=what, **tol)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _torch_attacker(seed):
    params = TF.init_attacker(torch.Generator().manual_seed(seed), CFG_T, "cpu")
    return params, TF.init_attack_state(params, CFG_T)


@pytest.mark.parametrize("p_eff", [0.0, 0.7, 1.0])
def test_chunk_matches_jax(p_eff):
    """One attacker, ``STEPS`` alternating updates, on the same params,
    pools and draws: params, both AdamW states and the four metric traces
    within ``TOL``."""
    k_init, k_run = jax.random.split(jax.random.PRNGKey(3))
    jp = JF.init_attacker(k_init, CFG_J)
    js = JF.init_attack_state(jp, CFG_J)
    pools = _pools(1)
    jp2, js2, jm = JF.make_attack_chunk(CFG_J, STEPS)(
        jp, js, jax.tree.map(jnp.asarray, pools), jnp.float32(p_eff), k_run)
    tp, ts = W.attacker_params_from_jax(_np(jp), "cpu"), \
        W.attacker_opt_state_from_jax(_np(js), "cpu")
    tp2, ts2, tm = TF.make_attack_chunk(CFG_T, STEPS)(
        tp, ts, _t(pools), p_eff, _jax_draws(k_run, STEPS, CFG_J.batch, POOL))
    _close(tp2, _np(jp2), TOL, "params")
    np_state = W.attacker_opt_state_to_numpy(ts2)
    for a, b in zip(np_state, _np(js2)):
        assert int(a.step) == int(b.step) == STEPS
        _close(a.mu, b.mu, TOL, "mu")
        _close(a.nu, b.nu, TOL, "nu")
    for k in ("recon_mse", "adv", "disc", "cap"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), err_msg=k,
                                   **TOL)


def test_population_of_one_matches_single_chunk_bitwise():
    params, state = _torch_attacker(0)
    pools = _t(_pools(2))
    draws = TF.draw_attack(torch.Generator().manual_seed(4), STEPS, CFG_T.batch,
                           POOL, device="cpu")
    p1, s1, m1 = TF.make_attack_chunk(CFG_T, STEPS)(params, state, pools, 0.7, draws)
    stack = lambda t: tree_map(lambda a: a[None], t)  # noqa: E731
    states = tuple(st._replace(mu=stack(st.mu), nu=stack(st.nu)) for st in state)
    p2, s2, m2 = TF.make_population_attack_chunk(CFG_T, STEPS)(
        stack(params), states, stack(pools), torch.tensor([0.7]),
        TF.AttackDraws(*stack(tuple(draws))))
    assert _equal(p1, tree_index(p2, 0))
    assert all(_equal(a.mu, tree_index(b.mu, 0)) and _equal(a.nu, tree_index(b.nu, 0))
               for a, b in zip(s1, s2))
    assert _equal(m1, tree_index(m2, 0))


def test_population_of_n_matches_n_single_chunks():
    """Six attackers with their own pools, capture weights and draws, in
    one stacked chunk, against six single chunks: within ``POP_N``; the
    kernels a step launches do not depend on N (one ``baddbmm`` per
    dense layer over the stacked axis)."""
    n = 6
    params, state = TA.init_attacker_population(torch.Generator().manual_seed(1),
                                                CFG_T, n, "cpu")
    pools = _t(_pools(3, n))
    p_eff = torch.linspace(0.0, 1.0, n)
    draws = TF.draw_attack(torch.Generator().manual_seed(5), STEPS, CFG_T.batch,
                           POOL, n=n, device="cpu")
    pp, ps, pm = TA.make_population_attack_chunk(CFG_T, STEPS)(
        params, state, pools, p_eff, draws)
    chunk = TF.make_attack_chunk(CFG_T, STEPS)
    for i in range(n):
        one = tuple(st._replace(mu=tree_index(st.mu, i), nu=tree_index(st.nu, i))
                    for st in state)
        p1, _, m1 = chunk(tree_index(params, i), one, tree_index(pools, i),
                          float(p_eff[i]), TF.AttackDraws(*tree_index(tuple(draws), i)))
        for a, b in zip(tree_leaves(p1), tree_leaves(tree_index(pp, i))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **POP_N)
        assert torch.equal(m1["cap"], pm["cap"][i])


@pytest.mark.parametrize("n,d", [(1, 6), (14, 6), (46, 48)])
def test_ops_per_step_do_not_depend_on_the_population(n, d):
    """The torch ops a training step dispatches are the same at every
    population size and width: the stacked population adds no op per
    attacker."""
    acfg = TF.AttackConfig(d_data=d, d_smash=d, feat_dim=8, hidden=8, batch=16)
    assert TP.count_ops_per_step(acfg, n, device="cpu") == TP.count_ops_per_step(
        CFG_T, 1, device="cpu")


def test_zero_capture_ignores_client_pool_contents():
    """p_eff = 0: the captured pool's values do not reach training, bit for
    bit; with capture on the same change matters."""
    params, state = _torch_attacker(4)
    chunk = TF.make_attack_chunk(CFG_T, STEPS)
    draws = TF.draw_attack(torch.Generator().manual_seed(6), STEPS, CFG_T.batch,
                           POOL, device="cpu")
    pools_a = _t(_pools(5))
    pools_b = dict(pools_a, z_cli=pools_a["z_cli"] * -3.0 + 1.0,
                   x_cli=pools_a["x_cli"] * 5.0 - 2.0)
    pa, _, _ = chunk(params, state, pools_a, 0.0, draws)
    pb, _, _ = chunk(params, state, pools_b, 0.0, draws)
    assert _equal(pa["atk"], pb["atk"])
    pc, _, _ = chunk(params, state, pools_a, 1.0, draws)
    pd, _, _ = chunk(params, state, pools_b, 1.0, draws)
    assert not _equal(pc["atk"], pd["atk"])


def test_training_reduces_reconstruction_loss():
    params, state = _torch_attacker(2)
    pools = _t(_pools(7))
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (CFG_T.d_smash, CFG_T.d_data)).astype(np.float32))
    pools["x_cli"] = pools["z_cli"] @ w  # a learnable task: a linear readout
    pools["x_aux"] = pools["z_aux"] @ w
    draws = TF.draw_attack(torch.Generator().manual_seed(8), 150, CFG_T.batch,
                           POOL, device="cpu")
    p, _, m = TF.make_attack_chunk(CFG_T, 150)(params, state, pools, 1.0, draws)
    mse = m["recon_mse"].numpy()
    assert mse[-10:].mean() < 0.5 * mse[:10].mean()
    sc, _ = TF.attack_scores(p, pools["z_cli"], pools["x_cli"])
    assert float(sc) > 0.3


@pytest.fixture(scope="module")
def probe():
    """The depth-3 probe model's params on both sides, and tokens."""
    cfg_j = JA.tiny_attack_model_cfg(depth=3, d_model=32)
    cfg_t = TA.tiny_attack_model_cfg(depth=3, d_model=32)
    jp = jax.jit(j_init_params, static_argnums=1)(jax.random.PRNGKey(5), cfg_j)
    tp = W.model_params_from_jax(_np(jp), "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg_j.vocab_size, (2, 8))
    return cfg_j, cfg_t, jp, tp, tokens


def test_smashed_activations_match_jax_and_a_block_loop(probe):
    cfg_j, cfg_t, jp, tp, tokens = probe
    cuts = [1, 3]
    jx, jz = JF.smashed_activations(jp, cfg_j, jnp.asarray(tokens), cuts)
    tt = torch.from_numpy(tokens)
    x0, z = TF.smashed_activations(tp, cfg_t, tt, cuts)
    assert torch.equal(x0, tp["embed"][tt])
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    sig = TM.signature(cfg_t)
    x, outs = x0, []
    for layer in range(cfg_t.num_layers):
        x, _, _ = TM.block_apply(TM.layer_params(tp["slots"][0], layer), x, cfg_t,
                                 sig[0], positions=torch.arange(tt.shape[-1]))
        outs.append(x)
    for k, cut in enumerate(cuts):
        assert torch.equal(z[k], outs[cut - 1])
    assert TF.flatten_rows(z).shape == (len(cuts), 2 * 8, cfg_t.d_model)


def test_train_population_from_the_reference_draws():
    """The lower ``train_attacker_population_from`` fed every draw of the
    reference's ``train_attacker_population`` (depth 3, d 32, 2 cuts x 2
    scenarios, 20 steps): scores, final MSE and the ``recon_mse`` traces
    within ``POP_TOL``."""
    cfg_j = JA.tiny_attack_model_cfg(depth=3, d_model=32)
    cfg_t = TA.tiny_attack_model_cfg(depth=3, d_model=32)
    cuts, cw, steps, seed = [1, 2], [0.2, 0.9], 20, 3
    tt_shape, ev_shape = (4, 16), (2, 16)
    ref = JA.train_attacker_population(cfg_j, cuts=cuts, capture_weights=cw,
                                       steps=steps, seed=seed,
                                       train_tokens=tt_shape, eval_tokens=ev_shape)
    # the reference's draws, in its order
    k_cli, k_shadow, k_tok, k_init, k_train = jax.random.split(
        jax.random.PRNGKey(seed), 5)
    init = jax.jit(j_init_params, static_argnums=1)
    cli, shadow = init(k_cli, cfg_j), init(k_shadow, cfg_j)
    kt = jax.random.split(k_tok, 3)
    toks = [np.asarray(jax.random.randint(k, s, 0, cfg_j.vocab_size))
            for k, s in zip(kt, (tt_shape, tt_shape, ev_shape))]
    n = len(cuts) * len(cw)
    acfg_j = JF.AttackConfig(d_data=32, d_smash=32)
    jparams, jstate = JA.init_attacker_population(k_init, acfg_j, n)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k_train, jnp.arange(n))
    pool = int(np.prod(tt_shape))
    per = [_jax_draws(keys[i], steps, acfg_j.batch, pool) for i in range(n)]
    draws = TF.AttackDraws(idx=torch.stack([d.idx for d in per]),
                           u=torch.stack([d.u for d in per]))
    inp = TP.PopulationInputs(
        W.model_params_from_jax(_np(cli), "cpu"),
        W.model_params_from_jax(_np(shadow), "cpu"),
        tuple(torch.from_numpy(t) for t in toks),
        W.attacker_params_from_jax(_np(jparams), "cpu"),
        W.attacker_opt_state_from_jax(_np(jstate), "cpu"), draws)
    kw = dict(cuts=cuts, capture_weights=cw,
              acfg=TF.AttackConfig(d_data=32, d_smash=32), steps=steps)
    res, = TP.train_attacker_population_from(cfg_t, [inp], **kw)
    np.testing.assert_allclose(res.scores, ref.scores, **POP_TOL)
    np.testing.assert_allclose(res.final_mse, ref.final_mse, **POP_TOL)
    np.testing.assert_allclose(res.recon_mse, ref.recon_mse, **POP_TOL)
    assert res.scores.shape == (2, 2) and res.population == 4
    # two seeds' populations stacked into one: each as it trains alone
    other = TP.draw_population_inputs(cfg_t, 4, kw["acfg"], steps, 7, tt_shape,
                                      ev_shape, "cpu")
    both = TP.train_attacker_population_from(cfg_t, [inp, other], **kw)
    alone, = TP.train_attacker_population_from(cfg_t, [other], **kw)
    for a, b in ((both[0], res), (both[1], alone)):
        np.testing.assert_allclose(a.scores, b.scores, **POP_N)
        np.testing.assert_allclose(a.recon_mse, b.recon_mse, **POP_N)
        tree_map(lambda x, y: np.testing.assert_allclose(x.numpy(), y.numpy(), **POP_N),
                 b.params, a.params)


def test_activation_scorer_matches_jax():
    n, rows = 3, 10
    k = jax.random.PRNGKey(9)
    jparams, _ = JA.init_attacker_population(k, CFG_J, n)
    rng = np.random.default_rng(10)
    act = {"z": rng.standard_normal((n, rows, CFG_J.d_smash)).astype(np.float32),
           "x": rng.standard_normal((n, rows, CFG_J.d_data)).astype(np.float32)}
    ref = JA.make_activation_scorer(jparams)(jax.tree.map(jnp.asarray, act))
    tparams = W.attacker_params_from_jax(_np(jparams), "cpu")
    got = TA.make_activation_scorer(tparams)(_t(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    loop = [TF.attack_scores(tree_index(tparams, i), torch.from_numpy(act["z"][i]),
                             torch.from_numpy(act["x"][i]))[0] for i in range(n)]
    np.testing.assert_allclose(got.numpy(), torch.stack(loop).numpy(), **POP_N)


@pytest.mark.parametrize("q", [0.0, 0.3, 0.8])
def test_capture_weight_matches_jax(q):
    assert TA.capture_weight(q) == pytest.approx(JA.capture_weight(q), rel=1e-7)
    kw = dict(p_tx=0.3, dist_tx_e=120.0, decoy_p=(0.2, 0.5),
              decoy_dist_e=(90.0, 400.0))
    assert TA.capture_weight(q, **kw) == pytest.approx(JA.capture_weight(q, **kw),
                                                       rel=1e-7)


def test_empirical_interpolation_and_env_threading():
    """Mirrors ``tests/test_leakage_api.py``: the table and
    ``layer_values`` equal the reference's, and the env prices its reward
    with ``layer_values``."""
    emp = TLK.EmpiricalLeakage.from_scores([1, 2, 4], [0.6, 0.3, 0.1], 4)
    ref = JLK.EmpiricalLeakage.from_scores([1, 2, 4], [0.6, 0.3, 0.1], 4)
    assert isinstance(emp, TLK.LeakageModel)
    np.testing.assert_array_equal(emp.value_table, np.asarray(ref.value_table))
    assert np.allclose(emp.value_table[[0, 1, 3]], [0.6, 0.3, 0.1])
    vals = emp.layer_values(np.zeros(16))
    np.testing.assert_array_equal(vals, ref.layer_values(np.zeros(16)))
    assert vals.min() >= 0.1 - 1e-6 and vals.max() <= 0.6 + 1e-6
    assert np.all(np.diff(vals) <= 1e-6)
    prof = resnet101_profile(batch=1)
    env = MHSLEnv(profile=prof, leakage_model=emp, device="cpu")
    leak_norm = profile_table(prof).leak_norm
    assert len(leak_norm) >= 16
    np.testing.assert_array_equal(env._consts[2].numpy(),
                                  emp.layer_values(leak_norm))


def test_empirical_evaluate_scores_live_activations():
    """``evaluate`` with a ``score_fn`` on live activations prices each hop
    with the scorer's value, as the reference's; without activations it
    falls back to the table."""
    from repro.core import scenario as JSC
    from repro.core.channel import NetworkConfig as JNet
    from repro_torch.core import scenario as TSC
    from repro_torch.core.channel import NetworkConfig as TNet

    h = 3
    jparams, _ = JA.init_attacker_population(jax.random.PRNGKey(11), CFG_J, h)
    rng = np.random.default_rng(12)
    act = {"z": rng.standard_normal((h, 20, CFG_J.d_smash)).astype(np.float32),
           "x": rng.standard_normal((h, 20, CFG_J.d_data)).astype(np.float32)}
    # an untrained attacker's scores clip to 0: make x its reconstruction
    # plus noise, so that the scores are not
    rec = jax.vmap(JF.reconstruct)(jparams, jnp.asarray(act["z"]))
    act["x"] = (np.asarray(rec) + 0.3 * act["x"] * np.asarray(rec).std()).astype(np.float32)
    geo = dict(boundaries=[2, 5, 7, 8], devices=[0, 1, 2, 3],
               dev_pos=rng.uniform(0, 500, (6, 2)), eav_pos=rng.uniform(0, 500, (2, 2)),
               p_tx=0.5, decoy_p=rng.uniform(0, 0.3, 6))
    jemp = JLK.EmpiricalLeakage.from_scores(
        [1, 4, 7], [0.5, 0.3, 0.1], 8,
        score_fn=JA.make_activation_scorer(jparams))
    temp = TLK.EmpiricalLeakage.from_scores(
        [1, 4, 7], [0.5, 0.3, 0.1], 8,
        score_fn=TA.make_activation_scorer(W.attacker_params_from_jax(_np(jparams), "cpu")))
    jsc = JSC.scenario_from_net(JNet())
    tsc = TSC.scenario_from_net(TNet(), device="cpu")
    jplan = JLK.plan_hop_geometry(**geo)
    tplan = TLK.plan_hop_geometry(**geo, device="cpu")
    live_j = jemp.evaluate(jsc, jplan, activations=jax.tree.map(jnp.asarray, act))
    live_t = temp.evaluate(tsc, tplan, activations=_t(act))
    np.testing.assert_allclose(live_t.numpy(), np.asarray(live_j), **TOL)
    assert float(live_t.sum()) > 0
    table_j = jemp.evaluate(jsc, jplan)
    table_t = temp.evaluate(tsc, tplan)
    np.testing.assert_allclose(table_t.numpy(), np.asarray(table_j), **TOL)
    assert not np.allclose(live_t.numpy(), table_t.numpy())


def test_attack_reference_holds_the_band_configuration():
    """``tests/data/torch_attack_reference.json`` was made at the
    configuration ``chip_smoke.py``'s fig-10 band runs, and holds one score
    table per seed."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.figures import fig10_leakage_attack as FIG10

    with open(DATA) as f:
        ref = json.load(f)
    assert chip_smoke.attack_band_config() is FIG10.BAND
    assert ref["config"] == json.loads(json.dumps(FIG10.BAND))
    runs = ref["runs"]
    assert [r["seed"] for r in runs] == FIG10.BAND["seeds"]
    k, s = len(FIG10.BAND["cuts"]), len(FIG10.BAND["qs"])
    for r in runs:
        assert np.asarray(r["scores"]).shape == (k, s)
