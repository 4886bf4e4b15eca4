"""The population band on the CPU: the port's ``train_population`` held to
the JAX package's in distribution.

The JAX runs of ``repro_torch.figures.band.POP_CPU_BAND`` (fig 6's
four-scenario ICM-CA population on the env padded to four eavesdroppers,
at the CPU band's tiny widths; 16 seeds) are committed in
``tests/data/torch_population_reference.json`` by
``tools/jax_band_reference.py --only population``. The port trains the
band's first ``POP_CPU_TORCH_SEEDS`` seeds. Per metric (per scenario the
mean reward and leak over the last 16 episodes and the states explored,
and the paired ``reward_diff`` of scenarios 0 and 1) the port's mean must
lie within ``4 s sqrt(1/n_jax + 1/n_torch) + 2% |mean_jax|`` of the JAX
mean (``band.compare``). The negative control, the population that never
leaves warmup, must fall outside.

torch runs on one thread here, so that its f32 sums, and so the runs, do
not depend on the machine's core count.
"""
import importlib.util
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.figures import band as B  # noqa: E402

BAND = B.POP_CPU_BAND


@pytest.fixture(scope="module")
def env():
    return B.pop_env(BAND, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return B.load_reference(B.POP_REFERENCE)["cpu"]


def _runs(env, warmup=None):
    return [B.pop_metrics(B.run_population(env, BAND, seed, warmup=warmup),
                          BAND["last_k"])
            for seed in BAND["seeds"][:B.POP_CPU_TORCH_SEEDS]]


def _show(label, result):
    print(label, "; ".join(
        f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
        f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
        f"margin {r['margin']:.4f}" for m, r in result.items()))


def test_reference_holds_the_bands():
    """The committed JAX runs were made at the bands the port runs
    (``POP_CPU_BAND`` here, ``POP_CARD_BAND`` in ``chip_smoke.py``'s
    population band phase), one row per seed with every metric."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", B.POP_REFERENCE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.pop_band_config() is B.POP_CARD_BAND
    ref = B.load_reference(B.POP_REFERENCE)
    for name, band in (("card", B.POP_CARD_BAND), ("cpu", B.POP_CPU_BAND)):
        assert ref[name]["config"] == json.loads(json.dumps(band)), name
        runs = ref[name]["runs"]
        assert [r["seed"] for r in runs] == band["seeds"]
        assert all(set(r) == {"seed", *B.pop_metric_names(band)} for r in runs)
    assert len(ref["card"]["runs"]) >= 16


def test_population_cpu_band(env, reference):
    result = B.compare(reference["runs"], _runs(env), B.pop_metric_names(BAND))
    _show("population", result)
    assert B.inside(result), result


def test_population_band_negative_control(env, reference):
    """Never leaving warmup (the uniform policy throughout) is outside the
    band."""
    result = B.compare(reference["runs"], _runs(env, warmup=BAND["episodes"]),
                       B.pop_metric_names(BAND))
    _show("control", result)
    assert not B.inside(result), result
