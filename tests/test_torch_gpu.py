"""Tests of the port that need a CUDA card (marker ``gpu``).

They skip without a card. On the card, where JAX is not installed, run
them with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``;
this file imports only torch, numpy and the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ca_attention as CA  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("b,i,obs_dim,pair_dim,c", [
    (128, 4, 28, 52, 64),  # the SAC update's call
    (130, 8, 28, 52, 64),  # ragged batch, longer history
    (4, 9, 6, 10, 8),  # I = 9 (refused before the redesign)
    (4, 3, 6, 129, 8),  # pair_dim 129 (refused before the redesign)
    (64, 16, 76, 132, 64),  # U 22 with hist_len 16 (refused before)
    (32, 16, 28, 52, 256),  # C 256
    (48, 16, 76, 132, 256),  # f32 weights in 5 stages, history in 2 chunks
])
def test_ca_attention_kernel_matches_plain_on_card(b, i, obs_dim, pair_dim, c):
    """The hand-written kernel vs its plain version, f32 ``atol 1e-5``, an
    all-masked row exactly zero, and one launch counted per call: at the
    SAC shapes and at shapes the earlier kernel refused."""
    _card()
    rng = np.random.default_rng(b + i + pair_dim + c)
    obs = torch.from_numpy(rng.standard_normal((b, obs_dim), dtype=np.float32))
    hist = torch.from_numpy(rng.standard_normal((b, i, pair_dim), dtype=np.float32))
    mask = torch.from_numpy((rng.uniform(size=(b, i)) > 0.4).astype(np.float32))
    mask[0] = 0.0
    params = {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.15)
              for k, shape in (("wq_s", (obs_dim, c)), ("wq_h", (pair_dim, c)),
                               ("wk", (pair_dim, c)), ("wv", (pair_dim, c)))}
    cp = {k: v.cuda() for k, v in params.items()}
    before = CA.launches
    out = CA.ca_attention(cp, obs.cuda(), hist.cuda(), mask.cuda())
    torch.cuda.synchronize()
    assert CA.launches == before + 1
    ref = CA.ca_attention_ref(obs, hist, mask, params["wq_s"], params["wk"],
                              params["wv"])
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-5)
    assert float(out[0, obs_dim:].abs().max()) == 0.0


@pytest.mark.gpu
def test_ca_attention_kernel_rejects_what_it_does_not_take():
    """On a CUDA tensor the wrapper launches or raises: mixed dtypes and
    non-contiguous inputs raise. (I and pair_dim above 8 and 128 run since
    the redesign: the matching test above holds them to the plain
    version.)"""
    _card()
    p = {k: torch.randn(s, device="cuda") for k, s in
         (("wq_s", (6, 8)), ("wq_h", (10, 8)), ("wk", (10, 8)), ("wv", (10, 8)))}
    obs = torch.randn(4, 6, device="cuda")
    hist = torch.randn(4, 3, 10, device="cuda")
    mask = torch.ones(4, 3, device="cuda")
    with pytest.raises(TypeError):
        CA.ca_attention(p, obs, hist, mask.half())
    with pytest.raises(ValueError):
        CA.ca_attention(p, obs, hist.transpose(0, 1).contiguous().transpose(0, 1), mask)


# ---------------------------------------------------------------------------
# the algorithm comparison: the sequential update, select_action, baselines
# ---------------------------------------------------------------------------

TINY = dict(hidden=32, feat_dim=8, attn_dim=8, batch=32, buffer_size=2000)


def _resnet_env():
    from repro_torch.core.env import MHSLEnv
    from repro_torch.core.profiles import resnet101_profile

    return MHSLEnv(profile=resnet101_profile(batch=1))


@pytest.mark.gpu
def test_sequential_update_trains_on_card():
    """train_sac with ``joint_update=False`` on cuda: a warm-up chunk and
    one updating chunk of 56 gradient steps, one ca_attention launch per
    gradient step and per rollout step, finite metrics and parameters."""
    _card()
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC

    env = _resnet_env()
    before = CA.launches
    res = LP.train_sac(env, SAC.SACConfig(**TINY, joint_update=False), episodes=8,
                       warmup_episodes=4, num_envs=4)
    torch.cuda.synchronize()
    assert res.chunk_updated == [False, True]
    assert CA.launches - before == 2 * env.episode_len * 4 + env.episode_len
    assert np.isfinite(list(res.metrics[0].values())).all()
    for leaf in tree_leaves(res.params):
        assert leaf.is_cuda and bool(torch.isfinite(leaf).all())


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["dqn", "ppo"])
def test_baselines_train_on_card(algo):
    """train_dqn and train_ppo on cuda through an updating chunk: finite
    metrics, parameters on the card, no kernel launched."""
    _card()
    from repro_torch.core.agents import dqn as DQ
    from repro_torch.core.agents import ppo as PP

    env = _resnet_env()
    before = CA.launches
    if algo == "dqn":
        res = DQ.train_dqn(env, DQ.DQNConfig(hidden=32, batch=32), episodes=8,
                           num_envs=4)
        assert res.chunk_updated == [False, True]
    else:
        res = PP.train_ppo(env, PP.PPOConfig(hidden=32, episodes_per_batch=4),
                           episodes=8, num_envs=4)
        assert res.chunk_updated == [True, True]
    torch.cuda.synchronize()
    assert CA.launches == before
    assert np.isfinite([v for m in res.metrics for v in m.values()]).all()
    assert np.isfinite(res.episode_reward).all()
    assert all(leaf.is_cuda for leaf in tree_leaves(res.params))


# the split planner: card against the CPU at the deepest zoo enumeration
# (measured 1.6e-7 relative on an H100; chip_smoke.py's gate is the same)
PLAN_RTOL = 2e-6


def _plan_case(arch):
    from repro_torch.configs import get_config
    from repro_torch.core.channel import NetworkConfig
    from repro_torch.core.profiles import transformer_profile
    from repro_torch.core.splitting import stack_boundaries
    from repro_torch.figures.zoo_plan_scoring import plan_inputs

    net = NetworkConfig(state_cycles_per_bit=0.01)
    prof = transformer_profile(get_config(arch), batch=1, seq=2048)
    pos, devices, p_tx, decoy = plan_inputs(4, net)
    # in the scorer's argument order
    return prof, stack_boundaries(prof.num_layers, 4), (devices, pos, p_tx, decoy), net


@pytest.mark.gpu
def test_plan_scorer_on_card_matches_cpu_at_nemotron():
    """The batched scorer on cuda against its CPU evaluation over the full
    S 4 enumeration of Nemotron-4-340B (96 layers, 138 415 plans), state
    priced, rtol 2e-6; the best delays agree to the same tolerance."""
    _card()
    from repro_torch.core.splitting import make_plan_scorer

    prof, bounds, inputs, net = _plan_case("nemotron-4-340b")
    assert len(bounds) == 138415
    t, e = make_plan_scorer(prof, "cuda")(bounds, *inputs, net)
    assert t.is_cuda and e.is_cuda
    tc, ec = make_plan_scorer(prof, "cpu")(bounds, *inputs, net)
    np.testing.assert_allclose(t.cpu().numpy(), tc.numpy(), rtol=PLAN_RTOL)
    np.testing.assert_allclose(e.cpu().numpy(), ec.numpy(), rtol=PLAN_RTOL)
    np.testing.assert_allclose(float(t.min()), float(tc.min()), rtol=PLAN_RTOL)
    # plan_cost prices its hops on a cuda ScenarioParams' device
    from repro_torch.core.scenario import scenario_from_net
    from repro_torch.core.splitting import SplitPlan, plan_cost

    devices, pos, p_tx, decoy = inputs
    plan = SplitPlan(tuple(int(x) for x in bounds[int(t.argmin())]),
                     tuple(int(d) for d in devices))
    np.testing.assert_allclose(
        plan_cost(prof, plan, pos, p_tx, decoy,
                  scenario_from_net(net, device="cuda")),
        plan_cost(prof, plan, pos, p_tx, decoy, net), rtol=1e-6)


@pytest.mark.gpu
def test_plan_scorer_kernels_do_not_depend_on_plans():
    """The CUDA kernels of one scorer call are the same at 4 495 plans
    (Jamba) and at 138 415 (Nemotron): no per-plan work on the host."""
    _card()
    from repro_torch.core.splitting import make_plan_scorer
    from repro_torch.figures.zoo_plan_scoring import device_ops_per_call

    counts = []
    for arch in ("jamba-v0.1-52b", "nemotron-4-340b"):
        prof, bounds, inputs, net = _plan_case(arch)
        scorer = make_plan_scorer(prof, "cuda")
        b = torch.as_tensor(bounds, device="cuda")
        counts.append(device_ops_per_call(lambda: scorer(b, *inputs, net))[0])
    assert counts[0] == counts[1] > 0


@pytest.mark.gpu
def test_evaluate_population_launches_ca_attention_per_step():
    """A five-point q sweep through ``evaluate_population`` on cuda: one
    ca_attention launch per rollout step per scenario (5 x 7), leak
    non-decreasing in q."""
    _card()
    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import rollout as R
    from repro_torch.core.agents import sac as SAC

    env = _resnet_env()
    cfg = SAC.SACConfig(**TINY)
    params = SAC.init_agent(torch.Generator().manual_seed(0), env.obs_dim,
                            env.action_dims, cfg, device="cuda")
    qs = [0.3, 0.45, 0.6, 0.75, 0.9]
    scenarios = SC.stack_scenarios(SC.scenario_grid(env.scenario(), monitor_prob=qs))
    before = CA.launches
    out = SC.evaluate_population(env, R.sac_policy(env.action_dims, cfg), params,
                                 scenarios, episodes=8, hist_len=cfg.hist_len)
    torch.cuda.synchronize()
    assert CA.launches - before == len(qs) * env.episode_len
    assert out["leak"].shape == (len(qs),) and np.isfinite(out["reward"]).all()
    assert np.all(np.diff(out["leak"]) >= 0.0)


@pytest.mark.gpu
def test_train_population_two_chunks_on_card():
    """fig 8's two-scenario population on cuda for a warm-up chunk and an
    updating chunk of 4 envs: exactly 2 x (one ca_attention launch per
    gradient step and per trained rollout step), per-scenario curves, the
    stacked params on the card."""
    _card()
    from repro_torch.core import scenario as SC
    from repro_torch.core.agents import sac as SAC

    env = _resnet_env()
    scens = SC.stack_scenarios(SC.scenario_grid(env.scenario(),
                                                know_eave_locations=[1.0, 0.0]))
    before = CA.launches
    pop = SC.train_population(env, SAC.SACConfig(**TINY), scens, episodes=8,
                              warmup_episodes=4, num_envs=4)
    torch.cuda.synchronize()
    assert CA.launches - before == 2 * (2 * env.episode_len * 4 + env.episode_len)
    for res in pop.results:
        assert res.chunk_updated == [False, True] and len(res.episode_reward) == 8
        assert np.isfinite(res.episode_reward).all()
    for leaf in tree_leaves(pop.params):
        assert leaf.is_cuda and leaf.shape[0] == 2 and bool(torch.isfinite(leaf).all())


@pytest.mark.gpu
def test_cuda_generator_state_resumes(tmp_path):
    """A CUDA generator's Philox state through a checkpoint archive: the
    draws after a restore repeat the draws after the save; and a
    ``train_sac`` stopped and resumed on cuda gives the uninterrupted
    run's curve."""
    _card()
    from repro_torch.checkpoint import store as ST
    from repro_torch.checkpoint import train_state as TS
    from repro_torch.core.agents import loops as LP
    from repro_torch.core.agents import sac as SAC

    g = torch.Generator(device="cuda").manual_seed(5)
    torch.rand(100, generator=g, device="cuda")
    path = str(tmp_path / "g.npz")
    ST.save_pytree({"gen": TS.generator_leaf(g)}, path)
    after = torch.rand(64, generator=g, device="cuda")
    fresh = torch.Generator(device="cuda")
    like = {"gen": TS.generator_leaf(fresh)}
    TS.restore_generator(fresh, ST.load_pytree(path, like)["gen"])
    assert torch.equal(torch.rand(64, generator=fresh, device="cuda"), after)

    env = _resnet_env()
    cfg = SAC.SACConfig(**TINY)
    kw = dict(warmup_episodes=4, num_envs=4, seed=2)
    ref = LP.train_sac(env, cfg, episodes=12, **kw)
    ck = str(tmp_path / "sac")
    LP.train_sac(env, cfg, episodes=8, checkpoint_dir=ck, **kw)
    res = LP.train_sac(env, cfg, episodes=12, checkpoint_dir=ck, **kw)
    assert res.episode_reward == ref.episode_reward
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(res.params),
                                                 tree_leaves(ref.params)))


@pytest.mark.gpu
def test_select_action_through_the_kernel_at_b1():
    """select_action on cuda launches ca_attention once at B = 1, and its
    action equals the plain route's (the plain version's s', the same
    heads) under the same Gumbel draws."""
    _card()
    from repro_torch.core.agents import action_space as A
    from repro_torch.core.agents import sac as SAC

    env = _resnet_env()
    cfg = SAC.SACConfig()
    dims = env.action_dims
    params = SAC.init_agent(torch.Generator().manual_seed(0), env.obs_dim, dims, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    st = env.reset(env.sample_positions(gen, 1))
    pair_dim = env.obs_dim + A.flat_dim(dims)
    hist = torch.randn((cfg.hist_len, pair_dim), generator=gen, device="cuda")
    hmask = torch.tensor([0.0, 1.0, 1.0, 1.0], device="cuda")
    obs = env.observe(st)[0]
    masks = {k: v[0] for k, v in env.action_masks(st).items()}
    g = A.gumbel(A.head_shapes(dims), gen, "cuda")
    before = CA.launches
    a = SAC.select_action(params, g, obs, hist, hmask, masks, dims, cfg)
    torch.cuda.synchronize()
    assert CA.launches == before + 1
    ca = params["actor"]["ca"]
    x = CA.ca_attention_ref(obs[None], hist[None], hmask[None], ca["wq_s"], ca["wk"],
                            ca["wv"])
    plain = A.sample(SAC._head_logits(params, x, {k: v[None] for k, v in masks.items()},
                                      dims), {k: v[None] for k, v in g.items()})
    for h in A.HEADS:
        assert torch.equal(plain[h][0], a[h]), h


# ---------------------------------------------------------------------------
# the split executor's kernels
# ---------------------------------------------------------------------------


def _stage_case(rows, d, f, activation, dtype, seed):
    rng = np.random.default_rng(seed)
    names = (("w_gate", (d, f)),) if activation == "swiglu" else ()
    names += (("w_up", (d, f)), ("w_down", (f, d)))
    params = {k: torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[0]))
                                  .astype(np.float32)) for k, shape in names}
    nw = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, rows, d), dtype=np.float32)).to(dtype)
    gy = torch.from_numpy(rng.standard_normal((1, rows, d), dtype=np.float32)).to(dtype)
    return params, nw, x, gy


# forward gates of the stage kernel: f32 (FMA body) absolute; f16 and
# bf16 (tensor-core body) relative to max|ref|, two ulps at the largest
# output
STAGE_ATOL_F32 = 1e-4
STAGE_REL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_stage_mlp_block_kernel_matches_plain_on_card(activation, dtype):
    """The hand-written kernel vs its plain version on the card at 37
    ragged rows, D 256, F 512, f32 weights: forward f32 ``atol 1e-4``,
    bf16 / f16 within two ulps of the largest output. Gradients through
    the wrapper against autograd of ``mlp_block`` on the same tensors (the
    same backward code): ``1e-5`` of each leaf's largest entry."""
    _card()
    from repro_torch.kernels import stage_block as SB
    from repro_torch.models import layers as L

    dt = getattr(torch, dtype)
    params, nw, x, gy = _stage_case(37, 256, 512, activation, dt, seed=len(activation))
    params = {k: v.cuda() for k, v in params.items()}
    nw, x, gy = nw.cuda(), x.cuda(), gy.cuda()
    names = sorted(params)

    def grads(fn):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        n, xx = nw.detach().requires_grad_(True), x.detach().requires_grad_(True)
        out = fn(n, p, xx)
        return out, torch.autograd.grad(out, [n, xx] + [p[k] for k in names], gy)

    before = SB.launches
    out, gk = grads(lambda n, p, xx: SB.stage_mlp_block(n, p, xx, activation=activation))
    torch.cuda.synchronize()
    assert SB.launches == before + 1
    with torch.no_grad():
        ref = SB.stage_mlp_block_ref(nw, params, x, activation=activation)
    top = float(ref.float().abs().max())
    atol = STAGE_ATOL_F32 if dtype == "float32" else STAGE_REL[dtype] * top
    assert out.dtype == dt
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol)
    _, gr = grads(lambda n, p, xx: L.mlp_block(n, p, xx, activation))
    for a, r in zip(gk, gr):
        r = r.float().cpu().numpy()
        np.testing.assert_allclose(a.float().cpu().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


@pytest.mark.gpu
@pytest.mark.parametrize("activation,rows,d,f,dtype,wdtype", [
    ("swiglu", 512, 2048, 11008, "bfloat16", "float32"),   # the Split call
    ("swiglu", 512, 2048, 11008, "float16", "float32"),
    ("relu2", 130, 3072, 9216, "bfloat16", "float32"),     # Minitron, ragged
    ("relu2", 130, 3072, 9216, "float16", "float32"),
    ("swiglu", 300, 512, 1024, "bfloat16", "bfloat16"),    # W == T
    ("gelu", 300, 512, 1024, "float16", "float16"),        # W == T
    ("silu", 77, 256, 768, "bfloat16", "float16"),         # W a 16-bit other
])
def test_stage_mlp_block_tensor_core_body_on_card(activation, rows, d, f, dtype,
                                                  wdtype):
    """The tensor-core body at the Split shape, the ragged Minitron shape
    and with weights already in the activation dtype (no conversion),
    forward against the plain version: two ulps of the largest output."""
    _card()
    from repro_torch.kernels import stage_block as SB

    dt, wt = getattr(torch, dtype), getattr(torch, wdtype)
    assert SB.body(dt) == "wgmma"
    params, nw, x, _ = _stage_case(rows, d, f, activation, dt, seed=rows + d)
    params = {k: v.to(wt).cuda() for k, v in params.items()}
    nw, x = nw.to(wt).cuda(), x.cuda()
    before = SB.launches
    with torch.no_grad():
        out = SB.stage_mlp_block(nw, params, x, activation=activation)
        ref = SB.stage_mlp_block_ref(nw, params, x, activation=activation)
    torch.cuda.synchronize()
    assert SB.launches == before + 1
    assert out.dtype == dt and out.shape == x.shape
    top = float(ref.float().abs().max())
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=STAGE_REL[dtype] * top)


# forward gates of the flash kernel: f32 (FMA body) 1e-5; bf16 2e-2 and
# f16 4e-3 (tensor-core body, P as two terms in the input dtype): about
# one bf16 / two f16 ulps of outputs below 4
FLASH_ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 256, 256, 16, 2, 128, None, 0),   # GQA, Qwen head layout
    (1, 200, 200, 4, 1, 64, None, 0),     # ragged S, MQA
    (2, 256, 256, 8, 2, 64, 64, 0),       # sliding window
    (2, 32, 128, 4, 2, 32, None, 96),     # queries at offset 96
    (2, 100, 100, 4, 2, 16, None, 0),     # head dim 16, ragged
    (8, 1024, 1024, 16, 2, 128, None, 0),  # the held-out call's shape
    (2, 512, 512, 32, 32, 64, None, 0),   # MHA, head dim 64
    (1, 96, 160, 4, 2, 64, None, None),   # not causal, Skv > Sq
    (2, 100, 100, 4, 2, 48, None, 0),     # head dim 48, padded to 64 (refused before)
    (1, 256, 256, 96, 8, 192, None, 0),   # Nemotron-4-340B: hd 192, GQA 96/8
    (1, 200, 200, 4, 2, 96, 64, 0),       # head dim 96, window
    (1, 130, 130, 4, 2, 256, None, 0),    # head dim 256
    (1, 72, 72, 4, 2, 80, None, 0),       # head dim 80, padded to 96
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernel_matches_plain_on_card(case, dtype):
    """The hand-written kernel vs its plain version on the card: f32
    ``atol 1e-5``, bf16 ``atol 2e-2``, f16 ``atol 4e-3``; one launch
    counted per call. ``q_offset`` None means a non-causal call."""
    _card()
    from repro_torch.kernels import flash_attention as FA

    b, sq, skv, h, kh, hd, window, q_offset = case
    causal = q_offset is not None
    q_offset = q_offset or 0
    rng = np.random.default_rng(sq + h)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dt).cuda()
               for s in ((b, sq, h, hd), (b, skv, kh, hd), (b, skv, kh, hd)))
    before = FA.launches
    with torch.no_grad():
        out = FA.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
        ref = FA.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=FLASH_ATOL[dtype])


# the backward's cases: (B, S, H, KH, hd, window)
FLASH_BWD_CASES = [
    (2, 2048, 16, 2, 128, None),  # the dense training cell's microbatch
    (1, 1024, 32, 4, 128, None),  # the MoE training cell's
    (2, 512, 8, 2, 64, 128),      # sliding window
    (2, 256, 4, 4, 64, None),     # GQA group 1, head dim 64
    (1, 300, 4, 2, 48, None),     # head dim 48, padded to 64; ragged S
]


def _grads(fn, q, k, v, do):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fn(*leaves).backward(do)
    return [t.grad for t in leaves]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_backward_on_card(case):
    """bf16 gradients through the kernel against ``flash_attention_ref``'s
    autograd in f32 from the same bf16 inputs: each of dq, dk and dv is
    at most as far from it (max|err| over max|ref|) as the dense route's
    bf16 autograd, measured here; two calls give bit-equal gradients; a
    forward and a backward count one launch each."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    b, s, h, kh, hd, window = case
    g = torch.Generator(device="cuda").manual_seed(s + h + hd)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").bfloat16()
                   for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd),
                                 (b, s, h, hd)))
    ref = _grads(lambda *t: FA.flash_attention_ref(*(x.float() for x in t), window=window),
                 q, k, v, do.float())
    dense = _grads(lambda *t: L.dense_attention(*t, q_offset=0, window=window), q, k, v, do)
    before = FA.launches
    got = _grads(lambda *t: FA.flash_attention(*t, window=window), q, k, v, do)
    torch.cuda.synchronize()
    assert FA.launches == before + 2
    again = _grads(lambda *t: FA.flash_attention(*t, window=window), q, k, v, do)
    for name, x, y, r, d in zip("qkv", got, again, ref, dense):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape
        assert torch.equal(x, y), f"d{name} differs between two calls"
        assert _rel(x, r) <= _rel(d, r), (f"d{name}", _rel(x, r), _rel(d, r))


@pytest.mark.gpu
def test_attention_apply_auto_trains_through_the_kernel_on_card():
    """``attention_apply(impl="auto")`` on bf16 card tensors at head dim
    128 adds one kernel launch forward and one backward; on f32 card
    tensors it keeps the dense route and launches nothing."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    cfg = get_config("qwen2.5-3b")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {k: v.cuda().requires_grad_(True) for k, v in L.init_attention(
        torch.Generator().manual_seed(0), cfg, device="cpu").items()}
    pos = torch.arange(256, device="cuda")
    for dt, launches in ((torch.bfloat16, (1, 1)), (torch.float32, (0, 0))):
        x = torch.randn(2, 256, cfg.d_model, generator=g, device="cuda").to(dt)
        x.requires_grad_(True)
        before = FA.launches
        out, _ = L.attention_apply(params, x, cfg, positions=pos, impl="auto")
        torch.cuda.synchronize()
        fwd = FA.launches - before
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        assert (fwd, FA.launches - before - fwd) == launches, dt
        assert torch.isfinite(x.grad.float()).all()


@pytest.mark.gpu
def test_split_kernels_reject_what_they_do_not_take():
    """On CUDA tensors the wrappers launch or raise: mixed dtypes,
    non-contiguous inputs, a head dim above 256 (others are padded to an
    instantiated width), and a gradient through flash_attention raise."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import stage_block as SB

    q = torch.randn(1, 8, 2, 32, device="cuda")
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        FA.flash_attention(*(torch.randn(1, 8, 2, 272, device="cuda"),) * 3)
    with pytest.raises(RuntimeError):
        FA.flash_attention(q.requires_grad_(True), q, q)
    p = {"w_up": torch.randn(16, 32, device="cuda"),
         "w_down": torch.randn(32, 16, device="cuda")}
    x = torch.randn(2, 3, 16, device="cuda")
    nw = torch.ones(16, device="cuda")
    with pytest.raises(TypeError):
        SB.stage_mlp_block(nw.half(), p, x, activation="gelu")
    with pytest.raises(ValueError):
        SB.stage_mlp_block(nw, p, x, activation="swiglu")  # no w_gate
    with pytest.raises(ValueError):
        SB.stage_mlp_block(nw, {**p, "w_up": p["w_up"].t().contiguous().t()}, x,
                           activation="gelu")


@pytest.mark.gpu
def test_tensor_core_bodies_reject_what_tma_cannot_take():
    """The f16/bf16 bodies load by TMA: a base off 16 bytes or a row
    stride that is not a multiple of 16 bytes raises a ValueError in the
    wrapper, before any launch; the f32 bodies take the same shapes."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import stage_block as SB

    q = torch.randn(1, 8, 2, 32, device="cuda").bfloat16()
    off = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)[1:].view(q.shape)
    off.copy_(q)
    before = FA.launches
    with pytest.raises(ValueError, match="TMA"):
        FA.flash_attention(off, q, q)
    assert FA.launches == before
    # D = 20: 40-byte bf16 rows of h cannot be a tensor map; f32 is fine
    p = {"w_up": torch.randn(20, 32, device="cuda"),
         "w_down": torch.randn(32, 20, device="cuda")}
    x = torch.randn(2, 3, 20, device="cuda")
    nw = torch.ones(20, device="cuda")
    before = SB.launches
    with pytest.raises(ValueError, match="TMA"):
        SB.stage_mlp_block(nw, p, x.bfloat16(), activation="gelu")
    assert SB.launches == before
    out = SB.stage_mlp_block(nw, p, x, activation="gelu")
    ref = SB.stage_mlp_block_ref(nw, p, x, activation="gelu")
    np.testing.assert_allclose(out.detach().cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the SSM and MoE kernels
# ---------------------------------------------------------------------------


def _ssd_case(b, s, h, p, n, seed):
    """SSD inputs as a Mamba block makes them: dt = softplus(N(0, 1)),
    a = -linspace(1, 16, H) (``init_mamba``'s rates), x, b, c ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a = (-np.linspace(1.0, 16.0, h)).astype(f)
    bm = rng.standard_normal((b, s, n)).astype(f)
    cm = rng.standard_normal((b, s, n)).astype(f)
    return [torch.from_numpy(t).cuda() for t in (x, dt, a, bm, cm)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 256, 4, 64, 128, 64),   # Mamba2-370m head and state widths
    (1, 200, 2, 64, 128, 64),   # ragged S: the last chunk has 8 rows
    (1, 50, 3, 32, 16, 64),     # one partial chunk, reduced widths
    (1, 96, 2, 96, 8, 32),      # P split over two blocks of columns
    (1, 300, 2, 64, 128, 128),  # chunk 128: runs at 64 (refused before)
    (1, 128, 2, 32, 256, 64),   # N 256: two state tiles (refused before)
])
def test_ssd_scan_kernel_matches_plain_on_card(case):
    """The hand-written kernel vs its plain version on the card, ``y`` and
    ``h_last``, within ``1e-4`` of each one's largest entry (the in-chunk
    cumulative decay reaches ~-800 at these rates, so its f32 rounding,
    taken in another order, enters exp(); ``chip_smoke.SSD_REL``); one
    launch counted per state tile of 128; no backward."""
    _card()
    from repro_torch.kernels import ssd_scan as SK

    *shape, chunk = case
    x, dt, a, bm, cm = _ssd_case(*shape, seed=sum(case))
    before = SK.launches
    with torch.no_grad():
        y, hl = SK.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        yr, hr = SK.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert SK.launches == before + -(-shape[4] // SK.MAX_STATE)  # one per state tile
    for out, ref in ((y, yr), (hl, hr)):
        ref = ref.cpu().numpy()
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    with pytest.raises(RuntimeError):
        SK.ssd_scan(x.requires_grad_(True), dt, a, bm, cm, chunk=chunk)


@pytest.mark.gpu
def test_ssd_scan_kernel_at_the_held_out_shape_on_card():
    """The 3xTF32 body at the shape of the held-out evaluation's scans
    (Mamba2-370m, 8 x 1024 tokens: H 32, P 64, N 128, chunk 64), y and
    h_last within 1e-4 of each one's largest entry of the plain version."""
    _card()
    from repro_torch.kernels import ssd_scan as SK

    x, dt, a, bm, cm = _ssd_case(8, 1024, 32, 64, 128, seed=1)
    with torch.no_grad():
        out = SK.ssd_scan(x, dt, a, bm, cm, chunk=64)
        ref = SK.ssd_scan_ref(x, dt, a, bm, cm, chunk=64)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        assert float((o - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_what_it_does_not_take():
    _card()
    from repro_torch.kernels import ssd_scan as SK

    x, dt, a, bm, cm = _ssd_case(1, 64, 2, 16, 8, seed=0)
    with torch.no_grad():
        with pytest.raises(TypeError):
            SK.ssd_scan(x.double(), dt, a, bm, cm)
        with pytest.raises(ValueError):
            SK.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a,
                        bm, cm)


def _grouped_case(activation, nb, blk, d, f, e, dtype, seed):
    rng = np.random.default_rng(seed)
    eid = torch.from_numpy(np.sort(rng.integers(0, e, nb)).astype(np.int32)).cuda()
    buf = rng.standard_normal((nb * blk, d)).astype(np.float32)
    buf.reshape(nb, blk, d)[:, blk // 2:] = 0.0  # padding rows
    names = (("w_gate", (e, d, f)),) if activation == "swiglu" else ()
    names += (("w_up", (e, d, f)), ("w_down", (e, f, d)))
    params = {k: torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[1]))
                                  .astype(np.float32)).cuda() for k, s in names}
    return torch.from_numpy(buf).to(dtype).cuda(), eid, params


# forward tolerance of the grouped FFN per row dtype, of max|ref|: f32 sums
# in another order; f16/bf16 round g, u, h and the output at the Pallas
# points, and the kernel takes the activation in f32 and rounds once where
# the plain version rounds per operation (one or two ulps)
GROUPED_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("blk", [8, 32, 128])
def test_grouped_moe_ffn_kernel_matches_plain_on_card(activation, dtype, blk):
    """The hand-written kernel vs ``grouped_ffn_reference`` on the card
    (D 256, F 384, 6 experts, f32 weights): f32 rows (the FMA body) within
    ``1e-5`` of the largest output, bf16 and f16 rows (the ``wgmma`` body)
    within 2^-6 and 2^-9 of it (the kernel rounds the activation once, the
    plain version per operation); padding rows exactly zero. Gradients
    through the wrapper against autograd of the plain version (the same
    backward code): ``1e-5`` of each leaf's largest entry."""
    _card()
    from repro_torch.kernels import moe_dispatch as MD

    dt = getattr(torch, dtype)
    nb = max(2, 512 // blk)
    buf, eid, params = _grouped_case(activation, nb, blk, 256, 384, 6, dt,
                                     seed=blk + len(activation))
    gy = torch.randn(buf.shape, device="cuda").to(dt)
    names = sorted(params)

    def grads(fn):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        b = buf.detach().requires_grad_(True)
        out = fn(b, p)
        return out, torch.autograd.grad(out, [b] + [p[k] for k in names], gy)

    before = MD.launches
    out, gk = grads(lambda b, p: MD.grouped_moe_ffn(b, eid, p, activation=activation))
    torch.cuda.synchronize()
    assert MD.launches == before + 1
    _, gr = grads(lambda b, p: MD.grouped_ffn_reference(
        b, eid, p.get("w_gate"), p["w_up"], p["w_down"], activation))
    with torch.no_grad():
        ref = MD.grouped_ffn_reference(buf, eid, params.get("w_gate"),
                                       params["w_up"], params["w_down"], activation)
    ref = ref.float().cpu().numpy()
    top = np.abs(ref).max()
    assert out.dtype == dt
    np.testing.assert_allclose(out.detach().float().cpu().numpy(), ref, rtol=0,
                               atol=GROUPED_REL[dtype] * top)
    assert float(out.detach().reshape(nb, blk, -1)[:, blk // 2:].abs().max()) == 0.0
    for a, r in zip(gk, gr):
        r = r.float().cpu().numpy()
        np.testing.assert_allclose(a.float().cpu().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("blk", [8, 32, 128])
def test_grouped_moe_ffn_weights_in_the_row_dtype_on_card(dtype, blk):
    """Weights stored in the rows' dtype go to the ``wgmma`` body's B tiles
    by TMA with no conversion: the same result as the plain version within
    the row dtype's tolerance, padding rows exactly zero, one launch."""
    _card()
    from repro_torch.kernels import moe_dispatch as MD

    dt = getattr(torch, dtype)
    nb = max(2, 512 // blk)
    buf, eid, params = _grouped_case("swiglu", nb, blk, 256, 384, 6, dt, seed=blk)
    params = {k: v.to(dt) for k, v in params.items()}
    before = MD.launches
    with torch.no_grad():
        out = MD.grouped_moe_ffn(buf, eid, params, activation="swiglu")
        ref = MD.grouped_ffn_reference(buf, eid, params["w_gate"], params["w_up"],
                                       params["w_down"], "swiglu")
    torch.cuda.synchronize()
    assert MD.launches == before + 1 and out.dtype == dt
    ref = ref.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref, rtol=0,
                               atol=GROUPED_REL[dtype] * np.abs(ref).max())
    assert float(out.reshape(nb, blk, -1)[:, blk // 2:].abs().max()) == 0.0


@pytest.mark.gpu
def test_grouped_moe_ffn_at_the_moe_layer_shape_on_card():
    """Path (B)'s call: one Qwen3-MoE-30B-A3B layer's dropless buffer of
    2 048 bf16 tokens (top-8 of 128 experts, blocks of 128; D 2048, F 768,
    SwiGLU, f32 weights) through the ``wgmma`` body, within 2^-6 of the
    largest output of the plain version; padding rows exactly zero; the
    tile schedule computed on the card is its plain version's."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.models import layers as L

    cfg = get_config("qwen3-moe-30b-a3b")
    g = torch.Generator(device="cuda").manual_seed(90)
    params = L.init_moe(g, cfg, device="cuda")
    x = torch.randn(2048, cfg.d_model, generator=g, device="cuda").bfloat16()
    _, ids, _ = L._moe_route(params, x, cfg)
    order, dest, p_rows, eid = L.dropless_layout(ids, cfg.moe.num_experts, 128)
    buf = x.new_zeros((p_rows, cfg.d_model)).index_copy(0, dest,
                                                        x[order // cfg.moe.top_k])
    sched = MD.device_tile_schedule(buf, eid, 128, cfg.moe.num_experts)
    assert torch.equal(sched.cpu(), MD.tile_schedule(
        buf.cpu(), eid.cpu(), 128, cfg.moe.num_experts))
    with torch.no_grad():
        out = MD.grouped_moe_ffn(buf, eid, params, activation="swiglu")
        ref = MD.grouped_ffn_reference(buf, eid, params["w_gate"], params["w_up"],
                                       params["w_down"], "swiglu")
    torch.cuda.synchronize()
    top = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** -6 * top
    pad = buf.float().abs().sum(-1) == 0
    assert bool(pad.any()) and float(out[pad].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("blk", [8, 32, 128])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty experts"])
def test_device_tile_schedule_matches_plain_on_card(blk, kind):
    """The two schedule grids give ``tile_schedule``'s table exactly, on a
    dropless layout of uniform, skewed (most choices on two experts) and
    sparse (odd experts get no rows) routing, with some routed rows and a
    whole expert's rows zero and a NaN row."""
    _card()
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.models import layers as L

    e, t, k, d = 16, 300, 4, 64
    g = torch.Generator().manual_seed(blk)
    ids = torch.randint(0, e, (t, k), generator=g)
    if kind == "skewed":
        ids[: 3 * t // 4, 0] = 1
        ids[: t // 2, 1] = e - 1
    elif kind == "empty experts":
        ids = (ids // 2) * 2
    order, dest, p_rows, eid = L.dropless_layout(ids, e, blk)
    buf = torch.zeros(p_rows, d)
    buf[dest] = torch.randn(dest.numel(), d, generator=g)
    buf[dest[:5]] = 0.0
    buf[dest[-1], 3] = float("nan")
    plain = MD.tile_schedule(buf.bfloat16(), eid, blk, e)
    _, first, end, _ = plain[1].tolist()
    buf[first:end] = 0.0
    plain = MD.tile_schedule(buf.bfloat16(), eid, blk, e)
    got = MD.device_tile_schedule(buf.bfloat16().cuda(), eid.cuda(), blk, e)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain)
    assert int(plain[:, 3].sum()) < int((plain[:, 1] < plain[:, 2]).sum())


@pytest.mark.gpu
def test_grouped_moe_ffn_kernel_rejects_what_it_does_not_take():
    _card()
    from repro_torch.kernels import moe_dispatch as MD

    buf, eid, params = _grouped_case("swiglu", 4, 8, 64, 96, 3, torch.float32, 0)
    with torch.no_grad():
        with pytest.raises(ValueError):  # blocks of 12 rows: no row tile
            MD.grouped_moe_ffn(buf[:24], eid[:2], params, activation="swiglu")
        with pytest.raises(TypeError):
            MD.grouped_moe_ffn(buf, eid.long(), params, activation="swiglu")
        with pytest.raises(TypeError):
            MD.grouped_moe_ffn(buf.half(), eid, {k: v.bfloat16() for k, v in
                                                 params.items()}, activation="swiglu")
        with pytest.raises(ValueError):
            MD.grouped_moe_ffn(buf.t().contiguous().t(), eid, params,
                               activation="swiglu")


# ---------------------------------------------------------------------------
# serving: the stage kernel at decode rows, the engine and the cached model
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage_mlp_block_at_decode_rows_on_card(rows, dtype):
    """The stage kernel at the pipelined runner's decode rows (one token
    per slot: 1, 8 and 16 rows, far under the tensor-core body's 256-row
    tile) at Qwen2.5-3B's widths, f32 weights, against its plain version:
    bf16 within two ulps of the largest output, f32 ``atol 1e-4``."""
    _card()
    from repro_torch.kernels import stage_block as SB

    dt = getattr(torch, dtype)
    params, nw, x, _ = _stage_case(rows, 2048, 11008, "swiglu", dt, seed=rows)
    params = {k: v.cuda() for k, v in params.items()}
    nw, x = nw.cuda(), x.reshape(rows, 1, 2048).cuda()
    before = SB.launches
    with torch.no_grad():
        out = SB.stage_mlp_block(nw, params, x, activation="swiglu")
        ref = SB.stage_mlp_block_ref(nw, params, x, activation="swiglu")
    torch.cuda.synchronize()
    assert SB.launches == before + 1
    assert out.dtype == dt and out.shape == x.shape
    top = float(ref.float().abs().max())
    atol = STAGE_ATOL_F32 if dtype == "float32" else STAGE_REL[dtype] * top
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_engine_matches_reference_on_card(temperature):
    """A reduced Qwen2.5-3B served by the engine on the card: 7 requests
    through 3 slots, every completion bitwise ``generate_reference``'s."""
    _card()
    from repro_torch.serving import (ServeConfig, ServingService,
                                     generate_reference, poisson_trace)

    cfg = ServeConfig(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
                      decode_chunk=2, temperature=temperature)
    svc = ServingService(cfg)
    assert svc.params["embed"].device.type == "cuda"
    trace = poisson_trace(n_requests=7, rate_per_sec=50.0,
                          vocab_size=svc.model_cfg.vocab_size,
                          plen_range=(2, 8), gen_range=(2, 8), seed=3)
    res = svc.run(trace)
    assert res["num_requests"] == 7
    for r in trace:
        ref = generate_reference(svc.runner, svc.params, r.prompt,
                                 gen_target=r.gen_target, max_new=8,
                                 prompt_pad=8, slots=3, temperature=temperature,
                                 base_key=svc.base_key, req_id=r.rid)
        assert np.array_equal(res["completions"][r.rid], ref.cpu().numpy()), r.rid


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-370m"])
def test_cached_forward_on_card_matches_cpu(arch):
    """A prefill and 4 decode steps at per-row positions of the reduced
    model, f32, on the card against the same on the CPU: logits and
    caches within ``rtol 1e-4`` of max|cpu| (f32 products summed in other
    orders; TF32 off)."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2, 1)))

    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        caches = M.init_caches(cfg, 2, 14, dtype=torch.float32, device=dev)
        pre = M.make_prefill_step(cfg, compute_dtype=torch.float32)
        dec = M.make_decode_step(cfg, compute_dtype=torch.float32)
        outs = []
        with torch.no_grad():
            lg, caches = pre(p, prompts.to(dev), caches)
            outs.append(lg)
            pos = torch.tensor([8, 6], device=dev)
            for i in range(4):
                lg, caches = dec(p, feed[i].to(dev), caches, pos + i)
                outs.append(lg)
        return [o.cpu() for o in outs] + [t.cpu() for t in tree_leaves(caches)]

    for a, b in zip(run("cuda"), run("cpu")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * max(float(b.abs().max()), 1e-6))


@pytest.mark.gpu
def test_mixed_pipeline_matches_unpipelined_on_card():
    """Reduced Jamba as ``AMAM`` (attention + MoE, Mamba + MLP: period 2)
    at the uneven split (1, 4), f32, on the card: the pipelined ``(loss,
    grads)`` against the unpipelined ``loss_and_grads`` with the MoE
    router's aux weighted 0 (the stage loss drops it): loss ``rtol 1e-5``,
    each leaf's max|err| within ``1e-4`` of its max|ref| (the gates of
    ``chip_smoke.py``'s pipelined f32 step); the gradients in the slots
    layout."""
    _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import PipelineConfig, pipeline_step_fn
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              num_layers=4, block_pattern="AMAM")
    no_aux = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).cuda()
             for k in ("tokens", "labels")}
    loss, grads = pipeline_step_fn(cfg, (1, 4), 2, pipe=PipelineConfig(
        compute_dtype="float32"))(params, batch["tokens"], batch["labels"])
    (_, (ref_loss, _)), ref = M.loss_and_grads(params, batch, no_aux,
                                               compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert [tuple(g.shape) for g in tree_leaves(grads)] == [
        tuple(p.shape) for p in tree_leaves(params)]
    for a, r in zip(tree_leaves(grads), tree_leaves(ref)):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.gpu
def test_frontend_flash_matches_dense_on_card():
    """Reduced Pixtral with image features prepended, bf16: the held-out
    loss through the flash kernel (one launch per layer, at the joined
    length) against ``impl="dense"``, within 2e-3 nats (dense rounds the
    softmax weights to bf16, the kernel carries them as two bf16 terms)."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M

    cfg = get_config("pixtral-12b").reduced()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    batch = synthetic_batch(cfg, 2, 64, seed=3, device="cuda")
    before = FA.launches
    with torch.no_grad():
        _, (flash, _) = M.loss_fn(params, batch, cfg, impl="pallas")
        _, (dense, _) = M.loss_fn(params, batch, cfg, impl="dense")
    assert FA.launches == before + cfg.num_layers
    assert np.isfinite(float(flash))
    assert abs(float(flash) - float(dense)) <= 2e-3


@pytest.mark.gpu
def test_attacker_population_kernels_do_not_grow_on_card():
    """The stacked attacker population's torch ops per training step are
    the same on the card at populations 1 and 14 (one ``baddbmm`` per
    dense layer over the stacked axis), and so are its CUDA kernels at 2
    and 14 (at 1 cuBLAS takes other GEMMs); a population of 3 on the card
    matches the same population on the CPU."""
    _card()
    from repro_torch.attack import AttackConfig, init_attacker_population
    from repro_torch.attack.fsha import draw_attack, make_population_attack_chunk
    from repro_torch.attack.population import (count_ops_per_step,
                                               profile_kernels_per_step)

    acfg = AttackConfig(d_data=32, d_smash=32)
    assert count_ops_per_step(acfg, 1) == count_ops_per_step(acfg, 14)
    assert count_ops_per_step(acfg, 14) == count_ops_per_step(acfg, 14, device="cpu")
    assert profile_kernels_per_step(acfg, 2) == profile_kernels_per_step(acfg, 14)
    n, pool, steps = 3, 64, 8
    rng = np.random.default_rng(0)
    pools = {k: torch.from_numpy(rng.standard_normal((n, pool, 32), dtype=np.float32))
             for k in ("z_cli", "x_cli", "z_aux", "x_aux")}
    draws = draw_attack(torch.Generator().manual_seed(1), steps, acfg.batch, pool,
                        n=n, device="cpu")
    p_eff = torch.tensor([0.0, 0.5, 1.0])
    outs = []
    for dev in ("cpu", "cuda"):
        params, state = init_attacker_population(torch.Generator().manual_seed(2),
                                                 acfg, n, dev)
        out = make_population_attack_chunk(acfg, steps)(
            params, state, tree_map(lambda a: a.to(dev), pools), p_eff.to(dev),
            tree_map(lambda a: a.to(dev), draws))
        outs.append(out[0])
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        np.testing.assert_allclose(a.numpy(), b.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_faulted_serving_matches_fault_free_on_card():
    """Serving on the card under the reference fault schedule (a reduced
    model, two pipelined stages): every request completes with the
    fault-free run's tokens, bit for bit, and the outage was seen."""
    _card()
    from repro_torch.core.faults import reference_schedule
    from repro_torch.serving import ServeConfig, ServingService, poisson_trace

    cfg = ServeConfig(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
                      decode_chunk=2, fault_tick_s=0.02, max_retries=2,
                      retry_backoff_s=0.005, boundaries=(1, 2))
    svc = ServingService(cfg)
    trace = poisson_trace(n_requests=7, rate_per_sec=50.0,
                          vocab_size=svc.model_cfg.vocab_size, plen_range=(2, 8),
                          gen_range=(2, 8), seed=3)
    free = svc.run(list(trace))
    faulted = ServingService(cfg, svc.params).run(
        list(trace), faults=reference_schedule(2, 1, tick_seconds=cfg.fault_tick_s))
    assert faulted["num_requests"] == len(trace) and faulted["fault_events"] >= 1
    for r in trace:
        assert np.array_equal(free["completions"][r.rid], faulted["completions"][r.rid])


# the meshes: child processes on this card (tests/_torch_ranks.py's card
# workers), the counterparts of chip_smoke.py's (M1) and (M2)
MESH_SAC_KW = dict(episodes=24, warmup_episodes=8, seed=5, num_envs=8)


@pytest.mark.gpu
def test_one_nccl_rank_mesh_is_mesh_none_on_card(tmp_path):
    """One rank over NCCL: ``train_sac`` and ``train_population`` on a
    1-rank population mesh are bit for bit ``mesh=None`` (launching the
    kernel); a 1-rank stage mesh's step is the in-process step's, the
    gate of ``chip_smoke.MESH_GRAD_REL``."""
    _card()
    import _torch_ranks as TR

    (r,) = TR.spawn("card_one_rank", 1, tmp_path, timeout=400, backend="nccl",
                    sac_kw=MESH_SAC_KW, qs=[0.3, 0.8], depth=2)
    assert r["backend"] == "nccl"
    for name in ("train_sac", "train_population"):
        assert r[name]["diff"] == 0.0, (name, r[name])
        assert r["launches"][name]["ca_attention"] > 0
    st = r["stage"]
    assert abs(st["loss"] - st["ref_loss"]) <= 1e-6 * abs(st["ref_loss"])
    assert st["grad_rel"] <= 1e-4, st
    assert r["launches"]["stage"]["stage_mlp_block"] == 4 * 2


@pytest.mark.gpu
def test_two_gloo_ranks_share_the_card(tmp_path):
    """Two gloo ranks on one card: the population over them is bit for
    bit the 1-rank run; ``train_sac`` with its envs split finishes with
    finite curves (its difference from 1 rank is recorded by
    ``chip_smoke.py``)."""
    _card()
    import _torch_ranks as TR

    lead, other = TR.spawn(
        "card_two_ranks", 2, tmp_path, timeout=400,
        sac_kw=dict(episodes=16, warmup_episodes=4, seed=5, num_envs=4),
        pop_kw=dict(episodes=8, warmup_episodes=2, seed=5, num_envs=2),
        qs=[0.3, 0.5, 0.7, 0.9], small=dict(batch=16, buffer_size=2000))
    assert "staged through the host" in lead["transport"]
    assert other["pop_diff"] == 0.0 and other["pop_updated"]
    assert np.isfinite(lead["sac_diff"]) and lead["sac_updated"]
    assert lead["launches"]["ca_attention"] > 0 and other["launches"]["ca_attention"] > 0


@pytest.mark.gpu
def test_tensor_parallel_step_on_four_gloo_ranks(tmp_path):
    """Four gloo ranks sharing the card on a (2 x 2) (data x model) mesh:
    reduced StableLM-1.6B's f32 train step, params and AdamW moments as
    ``param_shardings`` blocks, against the one-process step: loss ``rtol
    1e-5``, the clip's mesh-wide norm ``rtol 1e-6``, the updated params
    and first moment 1e-4 relative per leaf (``chip_smoke.MESH_GRAD_REL``);
    no kernel route (the counterpart of ``chip_smoke.py``'s (M4))."""
    _card()
    import _torch_ranks as TR

    lead, *rest = TR.spawn("card_tp_step", 4, tmp_path, timeout=400)
    assert lead["device"].startswith("cuda")
    assert lead["loss"] == pytest.approx(lead["ref_loss"], rel=1e-5)
    assert lead["norm"] == pytest.approx(lead["ref_norm"], rel=1e-6)
    assert lead["param_rel"] <= 1e-4 and lead["mu_rel"] <= 1e-4, lead
    assert all(not any(r["launches"].values()) for r in [lead, *rest])



@pytest.mark.gpu
def test_serving_ring_on_two_gloo_ranks(tmp_path):
    """A 2-stage plan served on two gloo ranks sharing the card
    (``ServingService(mesh=)``, Qwen2.5-3B at published widths, depth 2,
    bf16 through the stage kernel): every completion on both ranks bit for
    bit the one-process service's; each rank launches ``stage_mlp_block``
    once per ring pass for its one layer (the counterpart of
    ``chip_smoke.py``'s (M5a))."""
    _card()
    import _torch_ranks as TR

    ranks = TR.spawn("card_serve_stage", 2, tmp_path, timeout=400,
                     arch="qwen2_5_3b", bounds=[1, 2],
                     serve=dict(num_layers=2, num_slots=4, arrival_slots=2,
                                prompt_pad=16, max_new=8, decode_chunk=4),
                     trace=dict(n_requests=4, rate_per_sec=64.0, plen_range=(4, 16),
                                gen_range=(4, 8), seed=0))
    ref = ranks[0]["ref_completions"]
    assert len(ref) == 4
    for r in ranks:
        assert r["completions"].keys() == ref.keys()
        assert all(np.array_equal(r["completions"][k], v) for k, v in ref.items())
        passes = r["passes"]["prefill"] + r["passes"]["decode"]
        assert passes and r["launches"]["stage_mlp_block"] == passes * r["stage_layers"]


@pytest.mark.gpu
def test_sharded_mamba_decode_on_four_gloo_ranks(tmp_path):
    """Mamba2-370m at published widths and full depth, f32, decoding on a
    (1 x 4) mesh (each rank its SSM heads and conv channels): the greedy
    tokens equal one process's, logits within ``chip_smoke.M4C_LOGIT_ATOL``
    (1e-3); no kernel route."""
    _card()
    import _torch_ranks as TR

    ranks = TR.spawn("card_tensor_parallel", 4, tmp_path, timeout=600,
                     parts=["M4c_mamba"],
                     m4c_mamba=dict(arch="mamba2-370m", cache=32, starts=[0, 1, 2, 3],
                                    prompt=1, steps=4))
    c = ranks[0]["M4c_mamba"]
    assert torch.equal(c["tokens"], c["ref_tokens"])
    assert float((c["logits"] - c["ref_logits"]).abs().max()) <= 1e-3
    assert c["cache_spec"]["ssm"][2] == "model" and c["cache_spec"]["conv"][3] == "model"
    assert all(not any(v for part in r["launches"].values() for v in part.values())
               for r in ranks)


@pytest.mark.gpu
def test_step_spans_agree_with_cuda_events_on_card():
    """Under ``tracing.recording()``, one pipelined training step of
    Qwen2.5-3B at published widths, depth 4 on 3 stages, bf16 through the
    stage kernel: ``train.step``'s device ms is within 5% of CUDA events
    around the whole step; every span's children take no more device
    time than it does; the stage kernel runs as often as the plan says."""
    _card()
    import dataclasses

    from repro_torch import configs as TC
    from repro_torch import tracing
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.kernels import stage_block as SB
    from repro_torch.launch import train_mhsl_rl as RUN
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw

    cfg = dataclasses.replace(TC.get_config("qwen2.5-3b"), num_layers=4)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    opt = adamw(3e-4, max_grad_norm=1.0)
    micro = 4
    step = RUN.make_pipeline_train_step(
        cfg, (1, 3, 4), micro, PipelineConfig(stage_impl="pallas"), opt)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok, lab = (torch.randint(0, cfg.vocab_size, (8, 512), generator=gen, device="cuda")
                for _ in range(2))
    for _ in range(2):  # warm-up: the kernel's build, the allocator
        params, state, _, _ = step(params, state, tok, lab)
    tracing.reset()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    launches = SB.launches
    with tracing.recording():
        torch.cuda.synchronize()
        a.record()
        params, state, loss, _ = step(params, state, tok, lab)
        b.record()
        b.synchronize()
    assert SB.launches - launches == micro * (1 + 2 * 3)  # 2 runs off the last stage
    outer = a.elapsed_time(b)
    s = tracing.summary()
    inner = s["spans"]["train.step"]["device_ms"]
    assert s["steps"] == 1 and abs(inner - outer) <= 0.05 * outer, (inner, outer)
    recs = tracing.TRACER.records
    dev = [r.ev0.elapsed_time(r.ev1) for r in recs]
    children = {}
    for r, ms in zip(recs, dev):
        if r.parent is not None:
            total, n = children.get(r.parent, (0.0, 0))
            children[r.parent] = (total + ms, n + 1)
    for i, (ms, n) in children.items():  # an event's resolution a child as slack
        assert ms <= dev[i] + 1e-3 * n, (recs[i].name, ms, dev[i])
    tracing.reset()
    assert np.isfinite(float(loss))
