"""The fig-3 band on the CPU: the port's ``train_sac`` held to the JAX
package's runs in distribution.

The JAX runs of ``repro_torch.figures.band.CPU_BAND`` (two arms, ICM-CA
and neither, at tiny widths; 8 seeds) are committed in
``tests/data/torch_band_reference.json`` by ``tools/jax_band_reference.py``
(training them here would take minutes of JAX compiles). The port trains
each arm on the band's first 4 seeds. Per arm and metric (mean reward and
mean leak over the last 16 episodes, distinct states explored), the
port's mean must lie within ``4 s sqrt(1/8 + 1/4) + 2% |mean_jax|`` of
the JAX mean, ``s`` the larger spread across seeds (``band.compare``).
The negative control, the ICM-CA arm that never leaves warmup (the
uniform policy throughout), must fall outside the ICM-CA band.

torch runs on one thread here, so that its f32 sums, and so the runs, do
not depend on the machine's core count.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core.env import MHSLEnv  # noqa: E402
from repro_torch.core.profiles import resnet101_profile  # noqa: E402
from repro_torch.figures import band as B  # noqa: E402


@pytest.fixture(scope="module")
def env():
    return MHSLEnv(profile=resnet101_profile(batch=1), device="cpu")


@pytest.fixture(scope="module")
def reference():
    return B.load_reference()["cpu"]["arms"]


def _runs(env, arm, warmup=None):
    band = B.CPU_BAND
    return [B.run_metrics(B.run_arm(env, arm, band, seed, warmup=warmup),
                          band["last_k"])
            for seed in band["seeds"][:B.CPU_TORCH_SEEDS]]


def _show(label, result):
    print(label, "; ".join(
        f"{m} torch {r['torch_mean']:.4f}+-{r['torch_std']:.4f} jax "
        f"{r['jax_mean']:.4f}+-{r['jax_std']:.4f} |d| {r['distance']:.4f} "
        f"margin {r['margin']:.4f}" for m, r in result.items()))


@pytest.mark.parametrize("arm", B.CPU_BAND["arms"])
def test_cpu_band(env, reference, arm):
    result = B.compare(reference[arm], _runs(env, arm))
    _show(arm, result)
    assert B.inside(result), result


def test_cpu_band_negative_control(env, reference):
    """The uniform policy throughout is outside the ICM-CA band: the
    trained arm explores fewer distinct states."""
    result = B.compare(reference["icm_ca"],
                       _runs(env, "icm_ca", warmup=B.CPU_BAND["episodes"]))
    _show("control", result)
    assert not B.inside(result), result
    assert not result["states"]["inside"], result
