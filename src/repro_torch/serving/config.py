"""Serving knobs and the config-driven launcher contract.

Port of ``repro.serving.config``: the same fields, the same JSON files
and ``--set`` overrides, so one file configures both packages.
``model_config()`` reads the port's own copy of the zoo
(``repro_torch.configs.<arch>``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ServeConfig:
    """Engine, scheduler and trace knobs.

    ``num_slots`` is the continuous batch width (N draining slots),
    ``arrival_slots`` bounds admissions per tick (A), ``decode_chunk`` is
    the tokens decoded per engine tick (a slot freed mid-chunk re-admits
    only at the next tick). ``boundaries``: None serves on one device;
    else the split plan's cumulative cut points, served stage by stage
    with per-stage KV rings. ``replan_every``: re-score the split plan
    every K engine ticks (0 = off); re-plans are recorded, not applied.
    ``deadline_s``: the completion budget after arrival (0 = none); a
    request still queued past it is dropped. ``max_retries``,
    ``retry_backoff_s`` and ``fault_tick_s`` drive the reference's fault
    handling, which the port's service does not run yet."""

    arch: str = "qwen2_5_3b"      # repro_torch.configs module name
    reduced: bool = True          # .reduced() dry-run arch (CPU-sized)
    num_layers: Optional[int] = None  # override depth (benchmarks)
    num_slots: int = 8
    arrival_slots: int = 4
    prompt_pad: int = 32          # admitted prompts pad to this length
    max_new: int = 32             # gen_buf depth / decode loop bound
    decode_chunk: int = 8
    temperature: float = 0.0
    seed: int = 0
    boundaries: Optional[Tuple[int, ...]] = None
    compute_dtype: str = "float32"
    wire_dtype: Optional[str] = None
    replan_every: int = 0
    deadline_s: float = 0.0
    max_retries: int = 3
    retry_backoff_s: float = 0.01
    fault_tick_s: float = 0.0

    def model_config(self):
        import importlib

        mod = importlib.import_module(f"repro_torch.configs.{self.arch}")
        cfg = mod.CONFIG.reduced() if self.reduced else mod.CONFIG
        if self.num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=self.num_layers)
        return cfg

    @classmethod
    def load(cls, path: Optional[str] = None,
             overrides: Optional[dict] = None) -> "ServeConfig":
        """JSON file -> ServeConfig, with ``overrides`` applied on top.
        Unknown keys are an error (a typoed knob must not silently run
        the defaults)."""
        raw = {}
        if path is not None:
            with open(path) as f:
                raw.update(json.load(f))
        raw.update(overrides or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - fields)
        if unknown:
            raise KeyError(f"unknown ServeConfig keys: {unknown}")
        if raw.get("boundaries") is not None:
            raw["boundaries"] = tuple(int(b) for b in raw["boundaries"])
        return cls(**raw)

    @staticmethod
    def parse_override(key: str, value: str):
        """CLI override coercion: ``--set num_slots 16``, ``--set
        boundaries 2,4``, ``--set reduced false``."""
        fields = {f.name: f for f in dataclasses.fields(ServeConfig)}
        if key not in fields:
            raise KeyError(f"unknown ServeConfig key: {key}")
        if key == "boundaries":
            return tuple(int(x) for x in value.split(","))
        typ = fields[key].type
        if value.lower() in ("none", "null"):
            return None
        if "bool" in str(typ):
            return value.lower() in ("1", "true", "yes")
        if "int" in str(typ):
            return int(value)
        if "float" in str(typ):
            return float(value)
        return value
