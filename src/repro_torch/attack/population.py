"""Attacker populations: one adversary per (split boundary x scenario).

Port of ``repro.attack.population``. Where the reference vmaps one
attacker's chunk over the flattened (boundary x scenario) axis, the port
stacks the population (``fsha.make_population_attack_chunk``): every
attacker trains in lockstep in one loop of batched matmuls, each against
its cut's smashed-activation pool and its scenario's capture
probability. Attacker ``k * n_scenarios + s`` is cut ``k`` under
scenario ``s`` (cut-major).

The pools are gathered, not tiled: attacker ``i`` reads its cut's
client and shadow activations by index, and every cut reads the one
copy of the private inputs, so no pool is repeated per scenario or per
cut. The values each attacker sees are the reference's tiled pools'.

:func:`train_attacker_population` builds the client model and the
attacker's shadow copy, extracts the stage-boundary activations at every
requested cut, trains the population and measures per-boundary attack
accuracy on held-out client data. It draws everything from one seed
(:func:`draw_population_inputs`) and hands it to
:func:`train_attacker_population_from`, which takes the models, tokens,
attacker init and draws explicitly (the parity tests give it the
reference's) and stacks several seeds' populations into one
(:func:`train_attacker_populations`). :func:`train_empirical_model`
wraps a trained population into an
:class:`repro_torch.core.leakage.EmpiricalLeakage`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.attack.fsha import (
    AttackConfig,
    AttackDraws,
    draw_attack,
    flatten_rows,
    init_attack_state,
    init_attacker,
    make_population_attack_chunk,
    pop_attack_scores,
    smashed_activations,
)
from repro_torch.core.leakage import EmpiricalLeakage, capture_probability
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map, tree_stack

Tensor = torch.Tensor


def capture_weight(monitor_prob: float, *, p_tx: float = 0.5,
                   dist_tx_e: float = 300.0,
                   decoy_p: Sequence[float] = (0.2,),
                   decoy_dist_e: Sequence[float] = (300.0,),
                   o: float = 1.0) -> float:
    """Effective per-hop capture probability of one eavesdropper under a
    canonical geometry: Theorem 1's capture probability times the
    monitoring probability, the Bernoulli weight of how often an
    attacker's step receives a captured batch (f32, as the reference)."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    cap = capture_probability(f32(p_tx), f32([dist_tx_e]), f32(decoy_p),
                              f32(decoy_dist_e)[:, None], o)
    return float(cap[0]) * float(monitor_prob)


def init_attacker_population(gen: torch.Generator, cfg: AttackConfig, n: int,
                             device: DeviceLike = None):
    """Stacked params (leading axis N) and AdamW states for ``n``
    attackers, drawn one after another from ``gen`` (a CPU generator)."""
    params = tree_stack([init_attacker(gen, cfg, device) for _ in range(n)])
    return params, init_attack_state(params, cfg)


@dataclass
class AttackResult:
    """A trained population and its measurements.

    ``scores``/``final_mse`` are (n_cuts, n_scenarios): held-out attack
    accuracy (variance explained, in [0, 1]) and reconstruction MSE.
    ``recon_mse`` is the per-step training trace (n_cuts, n_scenarios,
    steps), which the fig-10 gate checks falls on average. ``params``
    keeps the stacked population (cut-major: attacker ``k * n_scenarios
    + s``), ``held_out`` the standardised held-out client activations it
    was scored on (``{"z": (n_cuts, n, d_smash), "x": (n, d_data)}``).
    Nothing compiles, so where the reference counts traces the port keeps
    ``ops_per_step``, the torch ops one training step dispatches
    (:func:`count_ops_per_step`), and ``kernels_per_step``, the CUDA
    kernels it launches (:func:`profile_kernels_per_step`); None unless
    measured.
    """

    params: Any
    opt_state: Any
    scores: np.ndarray
    final_mse: np.ndarray
    recon_mse: np.ndarray
    cuts: np.ndarray
    capture_weights: np.ndarray
    num_layers: int
    seconds: float
    steps: int
    pool_seconds: float = 0.0
    held_out: Optional[dict] = None
    ops_per_step: Optional[float] = None
    kernels_per_step: Optional[float] = None

    @property
    def population(self) -> int:
        return self.scores.size


def _standardize(a: Tensor, eps: float = 1e-6):
    """Zero-mean / unit-std per dim over the pool axis (-2), with the
    population std (numpy's, as the reference); returns the stats."""
    m = a.mean(dim=-2, keepdim=True)
    s = a.std(dim=-2, keepdim=True, correction=0) + eps
    return (a - m) / s, m, s


def _embed_scaled(params, scale: float):
    return dict(params, embed=params["embed"] * scale)


class PopulationInputs(NamedTuple):
    """Everything one seed's population run draws: the client model and
    the attacker's shadow copy (``init_params`` layout, embedding
    unscaled), the (client train, shadow train, client held-out) token
    tensors, the stacked attackers' init and AdamW states (N =
    cuts x scenarios, cut-major) and their :class:`AttackDraws` (leading
    axis N)."""

    cli_params: Any
    shadow_params: Any
    tokens: tuple
    params: Any
    opt_state: Any
    draws: AttackDraws


def draw_population_inputs(model_cfg, n: int, acfg: AttackConfig, steps: int,
                           seed: int, train_tokens, eval_tokens,
                           device: DeviceLike = None) -> PopulationInputs:
    """From ``seed``, in order: the client and shadow params and the three
    token sets from a generator on ``device`` (``cuda`` by default), the
    attacker init from a CPU generator, and the attackers' draws from the
    device generator."""
    from repro_torch.models import model as M

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cli_params = M.init_params(gen, model_cfg, device=dev)
    shadow_params = M.init_params(gen, model_cfg, device=dev)

    def toks(shape):
        return torch.randint(0, model_cfg.vocab_size, tuple(shape),
                             generator=gen, device=dev)

    tokens = (toks(train_tokens), toks(train_tokens), toks(eval_tokens))
    params, opt_state = init_attacker_population(
        torch.Generator().manual_seed(seed), acfg, n, dev)
    draws = draw_attack(gen, steps, acfg.batch, int(np.prod(train_tokens)),
                        n=n, device=dev)
    return PopulationInputs(cli_params, shadow_params, tokens, params,
                            opt_state, draws)


def _attack_pools(model_cfg, inp: PopulationInputs, cuts, embed_scale: float):
    """One seed's standardised pools: ``z_*`` (K, P, d_smash) per cut,
    ``x_*`` (P, d_data) shared by the cuts, ``*_ev`` the held-out ones."""
    t_cli, t_aux, t_ev = inp.tokens
    cli = _embed_scaled(inp.cli_params, embed_scale)
    shadow = _embed_scaled(inp.shadow_params, embed_scale)
    # client activations (captured), shadow pairs (owned). Everything is
    # standardised per cut over the pool axis: activation scale grows with
    # residual depth, and the variance-explained score is computed in the
    # same standardised space (held-out data with the TRAIN pool's client
    # statistics)
    x_cli, z_cli = smashed_activations(cli, model_cfg, t_cli, cuts)
    z_cli, zc_m, zc_s = _standardize(flatten_rows(z_cli))
    x_cli, xc_m, xc_s = _standardize(flatten_rows(x_cli))
    x_aux, z_aux = smashed_activations(shadow, model_cfg, t_aux, cuts)
    z_aux, _, _ = _standardize(flatten_rows(z_aux))
    x_aux, _, _ = _standardize(flatten_rows(x_aux))
    x_ev, z_ev = smashed_activations(cli, model_cfg, t_ev, cuts)
    return {"z_cli": z_cli, "x_cli": x_cli, "z_aux": z_aux, "x_aux": x_aux,
            "z_ev": (flatten_rows(z_ev) - zc_m) / zc_s,
            "x_ev": (flatten_rows(x_ev) - xc_m) / xc_s}


def _cat(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def train_attacker_population_from(
    model_cfg,
    inputs: Sequence[PopulationInputs],
    *,
    cuts: Sequence[int],
    capture_weights: Sequence[float],
    acfg: AttackConfig,
    steps: int,
    embed_scale: float = 25.0,
) -> List[AttackResult]:
    """Train one attacker per (cut x scenario) for each of ``inputs``
    (one seed's draws each, all on one device), every seed's attackers in
    one stacked population: attacker ``i`` of seed ``s`` takes exactly the
    steps it would take alone. Returns one :class:`AttackResult` per seed;
    with several seeds, ``seconds`` and ``pool_seconds`` are the whole
    run's.

    The pools are gathered, not tiled: there is one copy of each cut's
    client and shadow activations, and one of each seed's private inputs
    (a stride-0 view over its cuts when there is one seed)."""
    cuts = np.asarray(cuts, np.int64)
    capture_weights = np.asarray(capture_weights, np.float64)
    n_cut, n_scen, n_seed = len(cuts), len(capture_weights), len(inputs)
    n = n_cut * n_scen
    dev = inputs[0].cli_params["embed"].device
    t0 = time.perf_counter()
    per = [_attack_pools(model_cfg, inp, cuts, embed_scale) for inp in inputs]

    def by_cut(key):  # (seeds x cuts, rows, d), seed-major
        if key.startswith("z"):
            return _cat([p[key] for p in per])
        x = _cat([p[key][None] for p in per])  # (seeds, rows, d)
        return x[:, None].expand(n_seed, n_cut, *x.shape[1:]).reshape(
            n_seed * n_cut, *x.shape[1:])

    pools = {k: by_cut(k) for k in ("z_cli", "x_cli", "z_aux", "x_aux")}
    # attacker s * n + k * n_scen + q reads seed s's cut k
    cut_of = torch.arange(n_seed * n, device=dev) // n_scen
    p_eff = torch.as_tensor(capture_weights, dtype=torch.float32,
                            device=dev).repeat(n_seed * n_cut)
    steps_at = {int(inp.opt_state[0].step) for inp in inputs}
    if len(steps_at) != 1:
        raise ValueError(f"populations at different steps {sorted(steps_at)}")
    params = tree_map(lambda *xs: _cat(xs), *(inp.params for inp in inputs))
    opt_state = tuple(
        st._replace(mu=tree_map(lambda *xs: _cat(xs), *(i.opt_state[j].mu for i in inputs)),
                    nu=tree_map(lambda *xs: _cat(xs), *(i.opt_state[j].nu for i in inputs)))
        for j, st in enumerate(inputs[0].opt_state))
    draws = AttackDraws(*(_cat(xs) for xs in zip(*(inp.draws for inp in inputs))))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pool_seconds = time.perf_counter() - t0

    pop = make_population_attack_chunk(acfg, steps)
    t0 = time.perf_counter()
    params, opt_state, metrics = pop(params, opt_state, pools, p_eff, draws,
                                     pool_index=cut_of)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0

    with torch.no_grad():
        sc, mse = pop_attack_scores(params, by_cut("z_ev")[cut_of],
                                    by_cut("x_ev")[cut_of])
    shape = (n_cut, n_scen)
    sc, mse = sc.cpu().numpy(), mse.cpu().numpy()
    recon = metrics["recon_mse"].cpu().numpy()
    out = []
    for s, p in enumerate(per):
        rows = slice(s * n, (s + 1) * n)
        out.append(AttackResult(
            params=tree_map(lambda a: a[rows], params),
            opt_state=tuple(st._replace(mu=tree_map(lambda a: a[rows], st.mu),
                                        nu=tree_map(lambda a: a[rows], st.nu))
                            for st in opt_state),
            scores=sc[rows].reshape(shape),
            final_mse=mse[rows].reshape(shape),
            recon_mse=recon[rows].reshape(shape + (steps,)),
            cuts=cuts,
            capture_weights=capture_weights,
            num_layers=model_cfg.num_layers,
            seconds=seconds,
            steps=steps,
            pool_seconds=pool_seconds,
            held_out={"z": p["z_ev"], "x": p["x_ev"]},
        ))
    return out


def train_attacker_populations(
    model_cfg,
    *,
    seeds: Sequence[int],
    cuts: Sequence[int],
    capture_weights: Sequence[float],
    acfg: Optional[AttackConfig] = None,
    steps: int = 300,
    train_tokens=(32, 64),
    eval_tokens=(8, 64),
    embed_scale: float = 25.0,
    device: DeviceLike = None,
) -> List[AttackResult]:
    """:func:`train_attacker_population` at each of ``seeds``, all in one
    stacked population (each seed's draws as it alone would draw them)."""
    dev = resolve_device(device)
    if acfg is None:
        acfg = AttackConfig(d_data=model_cfg.d_model, d_smash=model_cfg.d_model)
    n = len(cuts) * len(capture_weights)
    inputs = [draw_population_inputs(model_cfg, n, acfg, steps, seed,
                                     train_tokens, eval_tokens, dev)
              for seed in seeds]
    return train_attacker_population_from(
        model_cfg, inputs, cuts=cuts, capture_weights=capture_weights,
        acfg=acfg, steps=steps, embed_scale=embed_scale)


def train_attacker_population(
    model_cfg,
    *,
    cuts: Sequence[int],
    capture_weights: Sequence[float],
    acfg: Optional[AttackConfig] = None,
    steps: int = 300,
    seed: int = 0,
    train_tokens=(32, 64),
    eval_tokens=(8, 64),
    embed_scale: float = 25.0,
    device: DeviceLike = None,
) -> AttackResult:
    """Train one attacker per (cut point x scenario) in lockstep.

    ``cuts`` are cumulative layer indices (1..L-1) of ``model_cfg``;
    ``capture_weights`` the per-scenario effective capture probabilities
    (:func:`capture_weight`). The client model and the shadow model are
    two independent initialisations of ``model_cfg``; the shadow
    supplies the attacker's (x, z) inversion pairs, and captured client
    activations enter only through the capture-gated terms, so
    low-capture scenarios learn less.

    ``embed_scale`` lifts the probe models' embedding tables to O(1): a
    random embedding is ~50x smaller than the block outputs it rides the
    residual stream with, unlike a trained model's.

    Everything is drawn from ``seed`` (:func:`draw_population_inputs`) and
    handed to :func:`train_attacker_population_from`.
    """
    return train_attacker_populations(
        model_cfg, seeds=[seed], cuts=cuts, capture_weights=capture_weights,
        acfg=acfg, steps=steps, train_tokens=train_tokens,
        eval_tokens=eval_tokens, embed_scale=embed_scale, device=device)[0]


def make_activation_scorer(stacked_params):
    """Live-activation scorer for :attr:`EmpiricalLeakage.score_fn`.

    ``stacked_params`` is a trained population whose leading axis matches
    the hop axis of the activations dict ``{"z": (H, n, d_smash), "x":
    (H, n, d_data)}``; returns the per-hop attack accuracies (H,)."""

    @torch.no_grad()
    def score(activations):
        s, _ = pop_attack_scores(stacked_params, activations["z"],
                                 activations["x"])
        return s

    return score


def empirical_model_from(result: AttackResult, *, scenario_idx: int = 0,
                         num_layers: Optional[int] = None,
                         with_scorer: bool = False) -> EmpiricalLeakage:
    """One scenario column of an :class:`AttackResult` as an
    :class:`EmpiricalLeakage` (interpolated onto ``num_layers``)."""
    score_fn = None
    if with_scorer:
        n_scen = len(result.capture_weights)
        col = tree_map(lambda a: a[scenario_idx::n_scen], result.params)
        score_fn = make_activation_scorer(col)
    return EmpiricalLeakage.from_scores(
        result.cuts, result.scores[:, scenario_idx], result.num_layers,
        num_layers=num_layers, score_fn=score_fn)


def tiny_attack_model_cfg(depth: int = 8, d_model: int = 32):
    """Reduced transformer the quick empirical model measures leakage on."""
    from repro_torch.configs import get_config

    cfg = get_config("stablelm-1.6b").reduced()
    return replace(cfg, num_layers=depth, d_model=d_model, num_heads=2,
                   num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
                   name=f"attack-probe-{depth}x{d_model}")


def train_empirical_model(*, seed: int = 0, steps: int = 400,
                          depth: int = 8, d_model: int = 32,
                          monitor_prob: float = 0.8,
                          num_layers: Optional[int] = None,
                          device: DeviceLike = None) -> EmpiricalLeakage:
    """One-call empirical leakage model: train an attacker population over
    every cut of a reduced transformer and return the measured per-layer
    values as an :class:`EmpiricalLeakage` (interpolated onto
    ``num_layers`` when pricing another profile's depth). It is what the
    figure drivers' ``--leakage empirical`` builds."""
    model_cfg = tiny_attack_model_cfg(depth, d_model)
    res = train_attacker_population(
        model_cfg, cuts=np.arange(1, depth),
        capture_weights=[capture_weight(monitor_prob)], steps=steps,
        seed=seed, device=device)
    return empirical_model_from(res, num_layers=num_layers)


def _probe(acfg: AttackConfig, n: int, pool: int, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, opt_state = init_attacker_population(
        torch.Generator().manual_seed(seed), acfg, n, dev)
    pools = {k: torch.randn((n, pool, d), generator=gen, device=dev)
             for k, d in (("z_cli", acfg.d_smash), ("x_cli", acfg.d_data),
                          ("z_aux", acfg.d_smash), ("x_aux", acfg.d_data))}

    def run(steps):
        draws = draw_attack(gen, steps, acfg.batch, pool, n=n, device=dev)
        return make_population_attack_chunk(acfg, steps)(
            params, opt_state, pools, torch.full((n,), 0.5, device=dev), draws)

    return run


def count_ops_per_step(acfg: AttackConfig, n: int, *, steps: int = 3,
                       pool: int = 64, seed: int = 0,
                       device: DeviceLike = None) -> float:
    """Torch operations dispatched per training step of an N-attacker
    population (forward, autograd's backward and AdamW; each launches at
    least one kernel on the card), counted below autograd by a
    ``TorchDispatchMode`` on random pools: the ops of a ``steps``-step
    chunk less those of a 1-step chunk, over ``steps - 1``. It does not
    depend on N or the widths; the library kernels behind an op (cuBLAS's
    choice of GEMM) may."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    run = _probe(acfg, n, pool, seed, resolve_device(device))
    counts = []
    for k in (1, steps):
        with Count() as c:
            run(k)
        counts.append(c.n)
    return (counts[1] - counts[0]) / (steps - 1)


# the marker kernel between a profile's primer and its chunk
# (``torch.cuda._sleep``'s spin kernel, ~0.1 ms)
MARKER_CYCLES = 200_000


def profile_kernel_names(acfg: AttackConfig, n: int, *, steps: int = 10,
                         pool: int = 256, seed: int = 0,
                         device: DeviceLike = None) -> Dict[str, int]:
    """CUDA events (kernels, device copies and fills) by name over one
    ``steps``-step chunk of an N-attacker population on random pools
    under ``torch.profiler``, after an untraced warm-up step. Needs the
    card.

    A long-lived process's profiler can miss the first records of a
    window (tens of a 10-step chunk's 3 608 on an H100, always the
    chunk's first), so the window opens with a primer step and a marker
    kernel, and only the events that start after the marker count."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("kernels per step are counted on the card")
    run = _probe(acfg, n, pool, seed, dev)
    run(1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(1)
        torch.cuda._sleep(MARKER_CYCLES)
        run(steps)
        torch.cuda.synchronize(dev)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        raise RuntimeError("the profile holds no marker kernel")
    names: Dict[str, int] = {}
    for e in events:
        if e.time_range.start >= max(marks):
            names[e.name] = names.get(e.name, 0) + 1
    return names


def profile_kernels_per_step(acfg: AttackConfig, n: int, *, steps: int = 10,
                             pool: int = 256, seed: int = 0,
                             device: DeviceLike = None) -> float:
    """CUDA kernels (and device copies and fills) per training step of an
    N-attacker population (:func:`profile_kernel_names` over ``steps``)."""
    names = profile_kernel_names(acfg, n, steps=steps, pool=pool, seed=seed,
                                 device=device)
    return sum(names.values()) / steps
