"""The port's examples (``repro_torch.examples.power_allocation`` and
``.serve``) against the JAX package's ``examples/power_allocation.py``
and ``examples/serve.py``.

* ``power_allocation``: every value the example prints, from the same
  inputs through the JAX package's functions, at ``rtol 1e-6`` (both
  evaluate in f32; measured equal to the last bit or within 1e-7).
* ``serve``: the greedy tokens of one ``generate_static`` of the reduced
  Qwen2.5-3B, the JAX example's arguments cut to 2 x 16 + 8, on the JAX
  package's seed-0 weights carried across by ``repro_torch.weights``:
  equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import leakage as JL  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.examples import power_allocation as PA  # noqa: E402
from repro_torch.examples import serve as SV  # noqa: E402

RTOL = 1e-6


def _jax_values():
    """The JAX example's values, computed as it computes them."""
    net = JCH.NetworkConfig()
    d_tx_rx, d_tx_d = jnp.asarray(150.0), jnp.asarray(180.0)
    dist_e, dd_e = jnp.asarray([250.0]), jnp.asarray([[90.0]])
    q = jnp.asarray([net.monitor_prob])
    bits, b_t, b_e = jnp.asarray(2e6), jnp.asarray(1.5), jnp.asarray(3.0)
    one = jnp.asarray(1.0)
    out = {"trainer": [], "decoy": []}
    for ps in PA.TRAINER_POWERS:
        leak = JL.expected_leakage(jnp.asarray(ps), dist_e, jnp.asarray([0.5]), dd_e, q, one)
        rate = JCH.data_rate(jnp.asarray(ps), d_tx_rx, jnp.asarray([0.5]),
                             jnp.asarray([d_tx_d]), net)
        out["trainer"].append(dict(p_s=ps, leak=float(leak),
                                   hop_time=float(JCH.tx_time(bits, rate))))
    for pd in PA.DECOY_POWERS:
        leak = JL.expected_leakage(jnp.asarray(0.5), dist_e, jnp.asarray([pd]), dd_e, q, one)
        out["decoy"].append(dict(p_d=pd, leak=float(leak)))
    p_s, p_d = JL.optimal_powers_single_decoy(bits, d_tx_rx, d_tx_d, b_t, b_e, net)
    leak = JL.expected_leakage(p_s, dist_e, jnp.asarray([p_d]), dd_e, q, one)
    rate = JCH.data_rate(p_s, d_tx_rx, jnp.asarray([p_d]), jnp.asarray([d_tx_d]), net)
    out["corollary1"] = dict(p_s=float(p_s), p_d=float(p_d), leak=float(leak),
                             hop_time=float(JCH.tx_time(bits, rate)),
                             energy=(float(p_s) + float(p_d)) * float(b_t))
    dd_many = jnp.asarray(PA.DECOY_DISTS)
    p_s2, p_d2 = JL.optimal_powers_single_eave(bits, d_tx_rx, dd_many, b_t, b_e, net)
    p_d2 = [float(x) for x in np.asarray(p_d2)]
    out["corollary2"] = dict(p_s=float(p_s2), p_d=p_d2,
                             received=[pd / float(d) ** 2 for pd, d in
                                       zip(p_d2, np.asarray(dd_many))])
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_power_allocation_matches_jax(capsys):
    got = PA.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Corollary 1" in printed and "water-levelled" in printed
    want = _jax_values()
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k, v in fw.items():
        assert fg[k] == pytest.approx(v, rel=RTOL), k
    # the closed forms hit the budgets: the hop takes B_T, the energy is B_E
    assert got["corollary1"]["hop_time"] == pytest.approx(1.5, rel=1e-4)
    assert got["corollary1"]["energy"] == pytest.approx(3.0, rel=1e-6)


def test_serve_matches_jax_greedy_tokens(capsys):
    from repro.models import init_params as jinit
    from repro.serving import SingleDeviceRunner as JRunner
    from repro.serving import generate_static as jgen
    from repro.serving.config import ServeConfig as JServeConfig

    batch, plen, gen = 2, 16, 8
    jcfg = JServeConfig(arch="qwen2_5_3b").model_config()
    jp = jax.jit(lambda k: jinit(k, jcfg))(jax.random.PRNGKey(0))
    prompts = SV.example_prompts(jcfg, batch, plen)
    want, want_n = jgen(JRunner(jcfg), jp, prompts, np.full((batch,), plen, np.int32),
                        np.full((batch,), gen, np.int32), max_new=gen)
    params = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = SV.main(["--batch", str(batch), "--prompt-len", str(plen), "--gen",
                   str(gen), "--device", "cpu"], params=params)
    assert "tok/s" in capsys.readouterr().out
    assert got["tokens"].shape == (batch, gen)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got["n_gen"].numpy(), np.asarray(want_n))
    assert got["tokens_per_s"] > 0 and got["device"] == "cpu"


def test_serve_from_seed_zero_is_deterministic():
    """Without weights the example draws its own from seed 0: two calls
    give the same tokens."""
    cfg = SV.ServeConfig(arch="qwen2_5_3b").model_config()
    a = SV.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    b = SV.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["n_gen"].tolist() == [4, 4]
