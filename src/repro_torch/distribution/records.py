"""What a collective moved: per-kind counts, per-rank result bytes and
wire-byte estimates, under the reference's kind names
(``repro.launch.hlo_analysis``).

``distribution.collectives.record_collectives()`` fills a
:class:`CollectiveStats` from the transfers a run issues;
``launch.hlo_analysis`` reads it (and re-exports these names under the
reference's module).

Wire-byte factors per collective (ring algorithms, n = group size), the
reference's:
  all-reduce        2 (n-1)/n * result_bytes
  all-gather          (n-1)/n * result_bytes   (result = gathered)
  reduce-scatter      (n-1)   * result_bytes   (result = one shard)
  all-to-all          (n-1)/n * result_bytes
  collective-permute          result_bytes     (one send)
  broadcast           (n-1)/n * result_bytes   (a pipelined ring: every
                                                rank but the source
                                                receives the tensor once)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """The bytes one rank puts on the wire for a ``kind`` collective of
    ``result_bytes`` per-rank result over a group of ``n``."""
    if kind == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    """Per-rank result bytes, wire-byte estimates and issue counts per
    collective kind; ``group_sizes`` counts the collectives of each kind
    by their group size ``n``."""

    result_bytes: Dict[str, int] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    group_sizes: Dict[str, Dict[int, int]] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())

    def add(self, kind: str, result_bytes: int, n: int) -> None:
        """One ``kind`` collective with ``result_bytes`` per rank over a
        group of ``n``."""
        wb = wire_bytes(kind, result_bytes, n)
        self.result_bytes[kind] = self.result_bytes.get(kind, 0) + int(result_bytes)
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) + wb
        self.counts[kind] = self.counts.get(kind, 0) + 1
        sizes = self.group_sizes.setdefault(kind, {})
        sizes[n] = sizes.get(n, 0) + 1

    def as_dict(self):
        return dict(result_bytes=dict(self.result_bytes),
                    wire_bytes=dict(self.wire_bytes), counts=dict(self.counts),
                    group_sizes={k: dict(v) for k, v in self.group_sizes.items()})
