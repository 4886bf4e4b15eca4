"""The comparison that decides ``correct`` for a training cell.

The program's first training steps and the reference's steps from the
same weights and batches each give :class:`Readings`
(``perfbench/reference/decoder_lm.py``). Four numbers compare them, each
against the limit that ``perfbench/checks/<cell>.json`` gives it:

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  steps;
* ``norm_gap``: the same of the global gradient norm the clip reads;
* ``grad_gap``: over the leaves, the largest gap between the norms of
  the first step's clipped gradient (the program's worked out from its
  AdamW state), ``|n - n_ref|``, over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_gap``: the same of the norms of each leaf's change over the
  steps, leaving out the leaves whose gradient in the reference is under
  a thousandth of the median leaf's (their moves under AdamW are
  round-off, as a key bias's under softmax);
* ``grad_dist``: over the leaves, the median of the distance between the
  two first clipped gradients at the leaf's sampled positions,
  ``|g - g_ref| / |g_ref|``. A gap between two norms moves with the
  square of an error spread over the elements; a distance moves with the
  error itself.

``norm_gap`` is given over all the steps and, as ``norm_gap_first``, over
the first step alone, which no earlier step's rounding moves.

The runner adds exact counts beside them (limit 0). A number that is
not finite, or over its limit, makes the run not correct.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

NUMBERS = ("loss_gap", "norm_gap", "norm_gap_first", "grad_gap", "change_gap",
           "grad_dist")
STILL_SHARE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _leaf_gap(ours: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(ours[k] - ref[k]) / max(ref[k], med) for k in keys)


def still_leaves(ref) -> List[str]:
    """Leaves whose gradient in the reference is round-off."""
    med = statistics.median(ref.raw_grad.values())
    return sorted(k for k, g in ref.raw_grad.items() if g < STILL_SHARE * med)


def leaf_dist(ours, ref) -> Dict[str, float]:
    """Per leaf, ``|g - g_ref| / |g_ref|`` of the first clipped gradients
    at the sampled positions."""
    return {k: float(torch.linalg.vector_norm(ours.grad_sample[k] - g)
                     / torch.linalg.vector_norm(g).clamp(min=1e-30))
            for k, g in ref.grad_sample.items()}


def gaps(ours, ref) -> Dict[str, float]:
    """The four numbers of ``ours`` against ``ref`` (both Readings)."""
    if set(ours.grad) != set(ref.grad) or len(ours.loss) != len(ref.loss):
        raise ValueError("the two runs differ in their leaves or steps")
    still = set(still_leaves(ref))
    dist = leaf_dist(ours, ref)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(ours.loss, ref.loss)),
        "norm_gap": max(abs(a - b) / b for a, b in zip(ours.norm, ref.norm)),
        "norm_gap_first": abs(ours.norm[0] - ref.norm[0]) / ref.norm[0],
        "grad_dist": statistics.median(dist.values()) if dist else math.nan,
        "grad_gap": _leaf_gap(ours.grad, ref.grad, ref.grad),
        "change_gap": _leaf_gap(ours.change, ref.change,
                                [k for k in ref.change if k not in still]),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {number: {"value", "limit"}})`` over the numbers that
    have a limit (a cell's checks file names those it compares): each must
    be finite and at most its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        out[name] = {"value": value, "limit": limit}
        ok &= math.isfinite(value) and value <= limit
    return ok, out
