"""Factored discrete action space with masking (paper's action-mask algorithm [30]).

Port of ``repro.core.agents.action_space``. Heads: u (categorical U),
size (categorical NBINS), decoys (U binary), p_tx / p_d (categorical
over power levels). Joint log-prob / entropy are sums over heads;
invalid entries are masked to ``NEG`` before sampling.

Sampling is the Gumbel-max trick ``argmax(logits + g)``, as
``jax.random.categorical`` draws it; the noise ``g`` comes from a
``torch.Generator`` (:func:`gumbel_like`) or is passed in, so tests can
share the reference's noise.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distribution.population import population_rand

Tensor = torch.Tensor

NEG = -1e9
HEADS = ("u", "size", "decoys", "p_tx", "p_d")


def masked_logits(logits: Dict[str, Tensor], masks: Dict[str, Tensor]):
    out = {
        "u": torch.where(masks["u"], logits["u"], NEG),
        "size": torch.where(masks["size"], logits["size"], NEG),
    }
    # decoys: (..., U, 2); masking the 'on' column forces 'off'
    off_on = torch.stack([torch.zeros_like(masks["decoys"], dtype=torch.float32),
                          torch.where(masks["decoys"], 0.0, NEG)], dim=-1)
    out["decoys"] = logits["decoys"] + off_on
    out["p_tx"] = torch.where(masks["p_tx"], logits["p_tx"], NEG)
    out["p_d"] = torch.where(masks["p_d"], logits["p_d"], NEG)
    return out


def head_shapes(dims: Dict[str, int]) -> Dict[str, tuple]:
    """The shape of one env's logits, per head."""
    return {"u": (dims["u"],), "size": (dims["size"],),
            "decoys": (dims["decoys"], 2), "p_tx": (dims["p_tx"],),
            "p_d": (dims["p_d"],)}


def gumbel(shapes: Dict[str, tuple], gen: torch.Generator, device):
    """Standard Gumbel noise of the given shape per head, drawn head by
    head in :data:`HEADS` order (``gen`` may be a
    ``distribution.population.PopulationGenerator``)."""
    tiny = torch.finfo(torch.float32).tiny
    out = {}
    for name in HEADS:
        u = population_rand(shapes[name], gen, device)
        out[name] = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return out


def gumbel_like(logits: Dict[str, Tensor], gen: torch.Generator):
    """Standard Gumbel noise shaped like each head's logits."""
    return gumbel({k: tuple(v.shape) for k, v in logits.items()}, gen,
                  logits["u"].device)


def sample(logits: Dict[str, Tensor], gumbel: Dict[str, Tensor]):
    """Categorical draw per head: ``argmax(logits + gumbel)`` (int32)."""
    return {name: torch.argmax(logits[name] + gumbel[name], dim=-1).to(torch.int32)
            for name in HEADS}


def _cat_logp(logits, idx):
    lp = F.log_softmax(logits, dim=-1)
    return torch.gather(lp, -1, idx[..., None].long())[..., 0]


def log_prob(logits: Dict[str, Tensor], action: Dict[str, Tensor]):
    lp = _cat_logp(logits["u"], action["u"])
    lp = lp + _cat_logp(logits["size"], action["size"])
    lp = lp + _cat_logp(logits["decoys"], action["decoys"]).sum(-1)
    lp = lp + _cat_logp(logits["p_tx"], action["p_tx"])
    lp = lp + _cat_logp(logits["p_d"], action["p_d"])
    return lp


def _cat_entropy(logits):
    lp = F.log_softmax(logits, dim=-1)
    p = torch.exp(lp)
    return -(p * torch.where(p > 0, lp, 0.0)).sum(-1)


def entropy(logits: Dict[str, Tensor]):
    h = _cat_entropy(logits["u"])
    h = h + _cat_entropy(logits["size"])
    h = h + _cat_entropy(logits["decoys"]).sum(-1)
    h = h + _cat_entropy(logits["p_tx"])
    h = h + _cat_entropy(logits["p_d"])
    return h


def log_prob_entropy(logits: Dict[str, Tensor], action: Dict[str, Tensor]):
    """Joint (log_prob, entropy) sharing one log_softmax per head."""
    lp_total = None
    ent_total = None
    for name in HEADS:
        lp = F.log_softmax(logits[name], dim=-1)
        head_lp = torch.gather(lp, -1, action[name][..., None].long())[..., 0]
        p = torch.exp(lp)
        head_ent = -(p * torch.where(p > 0, lp, 0.0)).sum(-1)
        if name == "decoys":
            head_lp = head_lp.sum(-1)
            head_ent = head_ent.sum(-1)
        lp_total = head_lp if lp_total is None else lp_total + head_lp
        ent_total = head_ent if ent_total is None else ent_total + head_ent
    return lp_total, ent_total


def onehot(action: Dict[str, Tensor], dims: Dict[str, int]):
    """Flatten an action into a single one-hot feature vector b(n)."""
    parts = [
        F.one_hot(action["u"].long(), dims["u"]).float(),
        F.one_hot(action["size"].long(), dims["size"]).float(),
        action["decoys"].float(),
        F.one_hot(action["p_tx"].long(), dims["p_tx"]).float(),
        F.one_hot(action["p_d"].long(), dims["p_d"]).float(),
    ]
    return torch.cat(parts, dim=-1)


def flat_dim(dims: Dict[str, int]) -> int:
    return dims["u"] + dims["size"] + dims["decoys"] + dims["p_tx"] + dims["p_d"]
