"""Collective bytes and roofline terms, the counterpart of
``repro.launch.hlo_analysis``.

The reference reads them from XLA's compiled, SPMD-partitioned module
text: each collective op's per-device result shape, its replica-group
size, and the trip counts of the loops around it. The port compiles
nothing, so its HLO text parsers (``split_computations``,
``loop_multipliers``, ``parse_collectives``, ``_parse_flat``) have no
counterpart. Its records come from the transfers a run issues instead:
``distribution.collectives.record_collectives()`` yields a
:class:`CollectiveStats` that every collective of the port adds to while
the context is open, one count and its per-rank result bytes under the
reference's kind names. A loop's collectives are counted once per trip
because they run once per trip, which is what the reference's loop-aware
parse recovers.

``CollectiveStats``, ``wire_bytes`` (the reference's wire factors) and
``COLLECTIVES`` live with the collectives, in ``distribution.records``,
and are re-exported here under the reference's names.

The roofline prices per-device terms with an NVIDIA H100 SXM5's datasheet
figures (the reference's are a TPU v5e's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# the collectives' own records, under the reference's names here
from repro_torch.distribution.records import (  # noqa: F401
    COLLECTIVES, CollectiveStats, wire_bytes)


def pipeline_collective_counts(stats: CollectiveStats,
                               n_ticks: int = 1) -> Dict[str, float]:
    """Issued-collective counts per pipeline tick, by kind: the recorded
    counts of one 1F1B step (its stage hops, ``collective-permute``, and
    its reductions) over the schedule's ``n_ticks``. The regression
    surface of the double-buffered transport: ``"overlap"`` moves the hops
    to the top of the tick but must not issue more of them than
    ``"sync"``."""
    return {k: c / n_ticks for k, c in stats.counts.items()}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM5 datasheet figures, per GPU
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s per direction (NVLink 4, 18 links)


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0  # 6 N D (train) / 2 N D (decode), per device
    useful_ratio: float = 0.0

    def as_dict(self):
        return dict(
            flops_per_device=self.flops_per_device,
            hbm_bytes_per_device=self.hbm_bytes_per_device,
            wire_bytes_per_device=self.wire_bytes_per_device,
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            model_flops=self.model_flops,
            useful_ratio=self.useful_ratio,
        )


def roofline_from(cost: Optional[dict], coll: Optional[CollectiveStats],
                  model_flops_per_device: float = 0.0) -> Roofline:
    """The three terms of ``cost`` (``"flops"``, ``"bytes accessed"``)
    and ``coll``'s wire bytes at the H100's rates, and the largest.
    ``coll=None`` (no collective count) leaves the collective term out
    of the pick."""
    flops = float(cost.get("flops", 0.0)) if cost else 0.0
    hbm = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    wire = coll.total_wire_bytes if coll is not None else 0.0
    c_s = flops / PEAK_FLOPS_BF16
    m_s = hbm / HBM_BW
    k_s = wire / NVLINK_BW
    terms = [("compute", c_s), ("memory", m_s)]
    if coll is not None:
        terms.append(("collective", k_s))
    dom = max(terms, key=lambda t: t[1])[0]
    return Roofline(
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        wire_bytes_per_device=wire,
        compute_s=c_s,
        memory_s=m_s,
        collective_s=k_s,
        dominant=dom,
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / flops) if flops else 0.0,
    )
