"""FSHA-style reconstruction adversary against smashed activations.

Port of ``repro.attack.fsha``. The attacker observes the activations
crossing a split boundary of the 1F1B executor (Eq. 1's wireless hop)
and tries to reconstruct the private stage-0 input. It trains three
MLPs with an alternating step, as in feature-space hijacking (Pasquini
et al.; Qiu et al.):

* **encoder** ``enc``: captured smashed activation -> attacker feature;
* **decoder** ``dec``: feature -> reconstructed private input;
* **discriminator** ``disc``: separates features of the attacker's own
  shadow pipeline (a re-initialised copy of the split model over public
  auxiliary data) from features of captured client activations.

The client model is fixed: the attack evaluates the leakage of a given
split. Step A trains enc + dec on the shadow inversion loss plus, on
steps where the hop was captured, the known-record inversion and a
non-saturating generator loss on captured features; step B trains the
discriminator on the updated encoder's features. A per-step Bernoulli
capture draw with the scenario's ``capture_probability * monitor_prob``
gates the captured terms.

Every function here works on a **stacked population**: each parameter
leaf carries a leading attacker axis N, each dense layer is one
``torch.baddbmm`` over N, and one autograd pass differentiates the sum
of the N losses. The attackers share no parameter and AdamW (no
clipping) is elementwise, so each attacker takes exactly the step it
would take alone, and the kernels launched per step do not depend on N.
:func:`make_attack_chunk` is the population chunk at N = 1.

``jax.random`` streams cannot be replayed in torch, so a chunk takes its
draws as an argument (:class:`AttackDraws`, where the reference takes a
key); :func:`draw_attack` makes them from a ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import init_mlp, mlp_apply
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_map, value_and_grad

Tensor = torch.Tensor


@dataclass(frozen=True)
class AttackConfig:
    d_data: int  # private-input dim (stage-0 embedding width)
    d_smash: int  # smashed-activation dim crossing the boundary
    feat_dim: int = 32
    hidden: int = 64
    lr: float = 3e-3
    disc_lr: float = 1e-3
    adv_weight: float = 0.1  # weight of the captured-feature alignment loss
    # weight of the supervised inversion loss on captured hops whose
    # plaintext the attacker knows (Qiu et al.'s auxiliary known records),
    # gated by the same per-step capture draw
    known_weight: float = 1.0
    batch: int = 64


class AttackDraws(NamedTuple):
    """The draws of a chunk of ``steps`` attacker steps: ``idx`` (...,
    steps, batch) int64 pool rows of each step's batch (the reference's
    ``randint(ki, (batch,), 0, pool)``) and ``u`` (..., steps) uniforms
    in [0, 1), ``u < p_eff`` being the step's capture draw."""

    idx: Tensor
    u: Tensor


def draw_attack(gen: torch.Generator, steps: int, batch: int, pool: int,
                n: Optional[int] = None,
                device: DeviceLike = None) -> AttackDraws:
    """Draws of ``steps`` steps for one attacker, or for ``n`` (leading
    axis), from ``gen`` (a generator on ``device``, ``cuda`` by default)."""
    device = resolve_device(device)
    lead = () if n is None else (n,)
    idx = torch.randint(0, pool, lead + (steps, batch), generator=gen,
                        device=device)
    return AttackDraws(idx=idx, u=torch.rand(lead + (steps,), generator=gen,
                                             device=device))


def attack_optimizers(cfg: AttackConfig):
    return adamw(cfg.lr), adamw(cfg.disc_lr)


def init_attacker(gen: torch.Generator, cfg: AttackConfig,
                  device: DeviceLike = None):
    """One attacker's params from ``gen`` (a CPU generator; the weights
    are moved to ``device``)."""
    device = resolve_device(device)
    return {
        "atk": {
            "enc": init_mlp(gen, (cfg.d_smash, cfg.hidden, cfg.feat_dim), device),
            "dec": init_mlp(gen, (cfg.feat_dim, cfg.hidden, cfg.d_data), device),
        },
        "disc": init_mlp(gen, (cfg.feat_dim, cfg.hidden, 1), device),
    }


def init_attack_state(params, cfg: AttackConfig):
    """AdamW states of the attacker (enc + dec) and the discriminator.
    For a stacked population the moments are stacked and the step count,
    shared by attackers that train in lockstep, is one scalar."""
    opt_a, opt_d = attack_optimizers(cfg)
    return opt_a.init(params["atk"]), opt_d.init(params["disc"])


def reconstruct(params, z: Tensor) -> Tensor:
    """dec(enc(z)): one attacker's input reconstruction."""
    return mlp_apply(params["atk"]["dec"], mlp_apply(params["atk"]["enc"], z))


def _variance_explained(rec: Tensor, x: Tensor):
    mse = torch.mean((rec - x) ** 2, dim=(-2, -1))
    var = torch.mean((x - x.mean(dim=-2, keepdim=True)) ** 2, dim=(-2, -1))
    return torch.clamp(1.0 - mse / torch.clamp(var, min=1e-12), 0.0, 1.0), mse


def attack_scores(params, z: Tensor, x: Tensor):
    """(attack accuracy, reconstruction MSE) of one attacker on held-out
    client data ``z`` (n, d_smash), ``x`` (n, d_data).

    Accuracy is the variance explained by the reconstruction, 1 -
    MSE / Var(x), clipped to [0, 1]: 0 is no better than predicting the
    mean, 1 a perfect reconstruction. It is the measured per-boundary
    information value :class:`repro_torch.core.leakage.EmpiricalLeakage`
    prices hops with."""
    return _variance_explained(reconstruct(params, z), x)


# ---------------------------------------------------------------------------
# the stacked population: leaves (N, ...), activations (N, rows, d)
# ---------------------------------------------------------------------------


def pop_mlp_apply(p, x: Tensor) -> Tensor:
    """``mlp_apply`` of N stacked MLPs (``w`` (N, d_in, d_out), ``b`` (N,
    d_out)) on ``x`` (N, rows, d_in): one ``baddbmm`` per layer."""
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = torch.baddbmm(lp["b"].unsqueeze(-2), x, lp["w"])
        if i < n - 1:
            x = F.relu(x)
    return x


def pop_reconstruct(params, z: Tensor) -> Tensor:
    """dec(enc(z)) of N stacked attackers, ``z`` (N, rows, d_smash)."""
    return pop_mlp_apply(params["atk"]["dec"],
                         pop_mlp_apply(params["atk"]["enc"], z))


def pop_attack_scores(params, z: Tensor, x: Tensor):
    """:func:`attack_scores` of N stacked attackers: ``z`` (N, n,
    d_smash), ``x`` (N, n, d_data) -> ((N,), (N,))."""
    return _variance_explained(pop_reconstruct(params, z), x)


def _attacker_loss(atk, disc, cfg: AttackConfig, z_aux, x_aux, z_cli, x_cli,
                   cap):
    """Sum over the N attackers of each one's step-A loss, and the
    per-attacker (known-record MSE, adversarial loss), each (N,)."""
    # shadow inversion: invert the attacker's own (re-initialised) pipeline
    f_aux = pop_mlp_apply(atk["enc"], z_aux)
    rec = pop_mlp_apply(atk["dec"], f_aux)
    l_rec = torch.mean((rec - x_aux) ** 2, dim=(-2, -1))
    f_cli = pop_mlp_apply(atk["enc"], z_cli)
    # known-record inversion: captured activations of records whose
    # plaintext the attacker holds give supervised pairs (Qiu et al.)
    rec_cli = pop_mlp_apply(atk["dec"], f_cli)
    l_known = torch.mean((rec_cli - x_cli) ** 2, dim=(-2, -1))
    # captured-feature alignment (non-saturating generator loss); both
    # client terms count only on steps where the hop was captured
    logit = pop_mlp_apply(disc, f_cli)[..., 0]
    l_adv = torch.mean(F.softplus(-logit), dim=-1)
    loss = l_rec + cap * (cfg.known_weight * l_known + cfg.adv_weight * l_adv)
    # the SUM: each attacker's gradient is its own loss's, unscaled
    return loss.sum(), (l_known, l_adv)


def _disc_loss(disc, f_aux, f_cli, cap):
    l_real = torch.mean(F.softplus(-pop_mlp_apply(disc, f_aux)[..., 0]), dim=-1)
    l_fake = torch.mean(F.softplus(pop_mlp_apply(disc, f_cli)[..., 0]), dim=-1)
    per = l_real + cap * l_fake
    return per.sum(), per


def make_population_attack_chunk(cfg: AttackConfig, n_steps: int):
    """``n_steps`` alternating updates of N attackers in lockstep.

    ``pop(params, opt_state, pools, p_eff, draws, pool_index=None) ->
    (params, opt_state, metrics)``. ``params`` and the moments of
    ``opt_state`` are stacked on a leading N axis. ``pools`` holds
    ``{"z_cli", "x_cli", "z_aux", "x_aux"}``, each (K, P, d): attacker
    ``i`` draws its batches from row ``pool_index[i]`` (``arange(N)``
    when None, with K = N), so attackers that share a pool (every cut
    reads the same private inputs) share one copy of it, or an
    ``expand``-ed view. ``p_eff`` (N,) is each attacker's per-step
    capture probability, ``draws`` an :class:`AttackDraws` with leading
    axis N. ``metrics`` are per-step traces ``{"recon_mse", "adv",
    "disc", "cap"}``, each (N, n_steps): ``recon_mse`` is the
    known-record reconstruction loss the fig-10 gate tracks.
    """
    opt_a, opt_d = attack_optimizers(cfg)

    def pop(params, opt_state, pools, p_eff, draws: AttackDraws,
            pool_index: Optional[Tensor] = None):
        n = p_eff.shape[0]
        if draws.idx.shape[:2] != (n, n_steps) or draws.u.shape != (n, n_steps):
            raise ValueError(f"draws of shape {tuple(draws.idx.shape)} / "
                             f"{tuple(draws.u.shape)} for {n} attackers x "
                             f"{n_steps} steps")
        if pool_index is None:
            pool_index = torch.arange(n, device=p_eff.device)
        rows = pool_index[:, None]
        sa, sd = opt_state
        atk, disc = params["atk"], params["disc"]
        trace = {"recon_mse": [], "adv": [], "disc": [], "cap": []}
        for t in range(n_steps):
            idx = draws.idx[:, t]
            z_aux = pools["z_aux"][rows, idx]
            x_aux = pools["x_aux"][rows, idx]
            z_cli = pools["z_cli"][rows, idx]
            x_cli = pools["x_cli"][rows, idx]
            cap = (draws.u[:, t] < p_eff).to(torch.float32)

            # step A: attacker (encoder + decoder), disc a constant
            _, (l_known, l_adv), g = value_and_grad(
                lambda a: _attacker_loss(a, disc, cfg, z_aux, x_aux, z_cli,
                                         x_cli, cap), atk)
            ups, sa = opt_a.update(g, sa, atk)
            atk = apply_updates(atk, ups)

            # step B: discriminator, on the UPDATED encoder's features
            with torch.no_grad():
                f_aux = pop_mlp_apply(atk["enc"], z_aux)
                f_cli = pop_mlp_apply(atk["enc"], z_cli)
            _, l_d, gd = value_and_grad(
                lambda d: _disc_loss(d, f_aux, f_cli, cap), disc)
            upd, sd = opt_d.update(gd, sd, disc)
            disc = apply_updates(disc, upd)

            for k, v in (("recon_mse", l_known), ("adv", l_adv), ("disc", l_d),
                         ("cap", cap)):
                trace[k].append(v)
        metrics = {k: torch.stack(v, dim=-1) for k, v in trace.items()}
        return {"atk": atk, "disc": disc}, (sa, sd), metrics

    return pop


def make_attack_chunk(cfg: AttackConfig, n_steps: int):
    """``n_steps`` alternating updates of ONE attacker.

    ``chunk(params, opt_state, pools, p_eff, draws) -> (params,
    opt_state, metrics)`` with unstacked params and state, ``pools``
    ``{"z_cli": (P, d_smash), "x_cli": (P, d_data), "z_aux", "x_aux"}``,
    ``p_eff`` the scalar per-step capture probability, ``draws`` with
    ``idx`` (n_steps, batch) and ``u`` (n_steps,), and ``metrics`` the
    per-step traces, each (n_steps,). It is the population chunk at
    N = 1.
    """
    pop = make_population_attack_chunk(cfg, n_steps)

    def stack(tree):
        return tree_map(lambda a: a[None], tree)

    def unstack(tree):
        return tree_map(lambda a: a[0], tree)

    def chunk(params, opt_state, pools, p_eff, draws: AttackDraws):
        states = tuple(st._replace(mu=stack(st.mu), nu=stack(st.nu))
                       for st in opt_state)
        p_eff = torch.as_tensor(p_eff, dtype=torch.float32,
                                device=draws.u.device).reshape(1)
        params, states, metrics = pop(stack(params), states, stack(pools),
                                      p_eff, AttackDraws(*stack(tuple(draws))))
        states = tuple(st._replace(mu=unstack(st.mu), nu=unstack(st.nu))
                       for st in states)
        return unstack(params), states, unstack(metrics)

    return chunk


# ---------------------------------------------------------------------------
# smashed activations: what crosses each 1F1B stage boundary
# ---------------------------------------------------------------------------


@torch.no_grad()
def smashed_activations(params, model_cfg, tokens: Tensor, cuts: Sequence[int]):
    """Stage-boundary activations of the split model for ``tokens``.

    Returns ``(x0, z)``: ``x0`` (B, T, d) the private stage-0 input (the
    embedding, what the attacker reconstructs) and ``z`` (K, B, T, d) the
    activation after layer ``cuts[k]``, the tensor the executor's forward
    ships over a hop whose cumulative boundary is ``cuts[k]``. The blocks
    run at the model's default route (``impl="auto"``).
    """
    from repro_torch.models import model as M

    sig = M.signature(model_cfg)
    period = M.find_period(sig)
    if period != 1:
        raise ValueError(
            f"attack assumes layer-group period 1 (got period {period}); "
            "same restriction as the pipeline executor")
    blocks = params["slots"][0]
    x0 = params["embed"][tokens]  # (B, T, d)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    want = {int(c) for c in cuts}
    keep = {}
    x = x0
    for layer in range(model_cfg.num_layers):
        x, _, _ = M.block_apply(M.layer_params(blocks, layer), x, model_cfg,
                                sig[0], positions=positions)
        if layer + 1 in want:
            keep[layer + 1] = x
    return x0, torch.stack([keep[int(c)] for c in cuts])


def flatten_rows(x: Tensor) -> Tensor:
    """(..., B, T, d) -> (..., B*T, d): token-position rows for the MLPs."""
    return x.reshape(x.shape[:-3] + (x.shape[-3] * x.shape[-2], x.shape[-1]))
