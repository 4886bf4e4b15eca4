"""The port's plan-side figure drivers on the CPU: the power table against
``benchmarks/table_power.py``, and the zoo plan-scoring, fig 5 and fig 9
drivers end to end at tiny sizes.

The power table is held to the reference's rows for the same seed at
rtol 1e-5 (f32 physics on both sides; measured equal), each side's grid
cut to 30 x 30 points (the reference's ``grid_best`` with ``n=30``) to
keep the reference's per-point loop short. The drivers run at 2 episodes
of 2 envs, inside warmup, and must write their JSON keys.
"""
import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import table_power as JTP  # noqa: E402
from benchmarks.common import BenchConfig  # noqa: E402
from repro_torch.figures import common  # noqa: E402
from repro_torch.figures import fig5_monitoring, fig9_example  # noqa: E402
from repro_torch.figures import table_power as TTP  # noqa: E402
from repro_torch.figures import zoo_plan_scoring  # noqa: E402

GRID = 30


@pytest.fixture()
def out_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    return tmp_path


def _json(out_dir, name):
    with open(out_dir / f"{name}.json") as f:
        return json.load(f)


def test_table_power_rows_match_reference(out_dir, monkeypatch):
    saved = {}
    monkeypatch.setattr(JTP, "save_json", lambda name, payload: saved.update(payload))
    monkeypatch.setattr(JTP, "grid_best", functools.partial(JTP.grid_best, n=GRID))
    JTP.main(BenchConfig(quick=True), seed=0)
    out = TTP.main(seed=0, trials=len(saved["rows"]), n=GRID, device="cpu")
    assert len(out["rows"]) == len(saved["rows"]) == 5
    for got, want in zip(out["rows"], saved["rows"]):
        assert got["trial"] == want["trial"]
        for k in ("closed_leak", "grid_leak", "p_s", "p_d", "gap_pct"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["worst_gap_pct"], saved["worst_gap_pct"],
                               rtol=1e-5)
    assert out["recv_power_spread"] < 1e-9  # water-levelled
    data = _json(out_dir, "table_power")
    assert data["device"] == "cpu" and len(data["rows"]) == 5


def test_zoo_plan_scoring_driver_runs(out_dir):
    """Smoke size: S 3 full enumerations of the four zoo configs, the
    10-layer scorer-vs-loop comparison and the S 2 transport ratios."""
    payload = zoo_plan_scoring.main(device="cpu", smoke=True)
    data = _json(out_dir, "zoo_plan_scoring")
    assert data["device"] == "cpu"
    zoo = payload["zoo_plan_scoring"]
    assert [c["config"] for c in zoo["configs"]] == zoo_plan_scoring.ZOO
    for c in zoo["configs"]:
        assert c["plans"] == (c["layers"] - 1) * (c["layers"] - 2) // 2
        assert c["plans_per_sec"] > 0 and c["kernels_per_call"] is None
        assert len(c["best_boundaries_state_priced"]) == 3
    scoring = payload["plan_scoring"]
    assert scoring["plans"] == 36 and scoring["max_rel_err_vs_loop"] < 1e-5
    for row in payload["transport_model"]:
        assert row["model_speedup"] >= 1.0
        assert 0.0 < row["bubble_fraction"] < 1.0


def test_fig5_driver_runs(out_dir):
    derived = fig5_monitoring.main(num_envs=2, device="cpu", episodes=2,
                                   warmup=2, eval_episodes=2)
    assert set(derived["mean_leak"]) == {"icm_ca", "sac", "ppo"}
    data = _json(out_dir, "fig5_monitoring")
    assert data["device"] == "cpu" and data["leakage"] == "analytic"
    assert [float(q) for q in data["rows"]] == fig5_monitoring.QS
    for name in ("icm_ca", "sac", "ppo"):
        leaks = [data["rows"][q][name] for q in data["rows"]]
        assert np.all(np.diff(leaks) >= 0.0), name
    # the attacker-measured EmpiricalLeakage prices the same sweep
    emp = fig5_monitoring.main(num_envs=2, device="cpu", episodes=2, warmup=2,
                               eval_episodes=2, leakage="empirical", smoke=True)
    data = _json(out_dir, "fig5_monitoring")
    assert data["leakage"] == "empirical"
    assert all(np.isfinite(v) for v in emp["mean_leak"].values())
    for name in ("icm_ca", "sac", "ppo"):
        leaks = [data["rows"][q][name] for q in data["rows"]]
        assert np.all(np.diff(leaks) >= 0.0), name


def test_fig9_driver_runs(out_dir):
    payload = fig9_example.main(num_envs=2, device="cpu", episodes=2, warmup=2)
    data = _json(out_dir, "fig9_example")
    assert data["device"] == "cpu"
    for k in ("dev_pos", "eav_pos", "stage_devices", "boundaries",
              "decoy_usage", "mean_trainer_dist_to_eave",
              "mean_decoy_dist_to_eave"):
        assert k in data, k
    assert payload["boundaries"][-1] == 35 and payload["stage_devices"][-1] == 6
    assert np.all(np.diff(payload["boundaries"]) > 0)
