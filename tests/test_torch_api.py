"""The port's facade and its quickstart, on the CPU.

``repro_torch.api`` exports the counterpart of every name
``repro.api`` exports, and ``repro_torch.examples.quickstart`` (which
imports only through it) trains the JAX quickstart's model: on the JAX
package's initial weights, carried, its first losses are the JAX
quickstart loop's on the same batches (``synthetic_stream`` draws them
with numpy on both sides). Both compute in bf16 over f32 weights, which
the two frameworks round in different places: measured here, the losses
differ by 1.4e-4 relative at the first step and at most 3.0e-4 over the
four, and the gate is the bf16 loss-curve gate of
``tests/test_torch_train_launcher.py``, 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.api as JAPI  # noqa: E402
import repro_torch.api as TAPI  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.examples import quickstart as QS  # noqa: E402

LOSS_RTOL = 1e-3
ARGV = ["--steps", "4", "--d-model", "64", "--layers", "2", "--batch", "2",
        "--seq", "16", "--device", "cpu"]


def test_facade_exports_the_reference_names():
    assert TAPI.__all__ == JAPI.__all__
    missing = [n for n in TAPI.__all__ if not hasattr(TAPI, n)]
    assert not missing, missing
    assert TAPI.make_stage_mesh.__module__ == "repro_torch.launch.mesh"


def _jax_quickstart(args):
    """The JAX quickstart's loop (``examples/quickstart.py``) at ``args``:
    its initial params and its losses."""
    jcfg = dataclasses.replace(
        JAPI.get_config(args.arch).reduced(), num_layers=args.layers,
        d_model=args.d_model, head_dim=64, vocab_size=2048,
        num_heads=max(JAPI.get_config(args.arch).reduced().num_heads, 4) or 4,
        num_kv_heads=max(JAPI.get_config(args.arch).reduced().num_kv_heads, 2) or 2,
        name=f"{args.arch}-quickstart")
    params = JAPI.init_params(jax.random.PRNGKey(0), jcfg)
    opt = JAPI.adamw(JAPI.linear_warmup_cosine(3e-4, warmup=20,
                                               total_steps=args.steps),
                     weight_decay=0.01, max_grad_norm=1.0)
    state = opt.init(params)
    step_fn = jax.jit(JAPI.make_train_step(jcfg, opt, remat=False))
    stream = JAPI.synthetic_stream(jcfg, args.batch, args.seq)
    p, losses = params, []
    for _ in range(args.steps):
        p, state, m = step_fn(p, state, next(stream))
        losses.append(float(m["loss"]))
    return jax.tree.map(np.asarray, params), losses


def test_quickstart_matches_jax_quickstart(tmp_path):
    args = QS.parse_args(ARGV)
    jparams, jlosses = _jax_quickstart(args)
    out = QS.main(ARGV + ["--ckpt", str(tmp_path / "qs.npz")],
                  params=W.model_params_from_jax(jparams, "cpu"))
    assert out["cfg"].name == "stablelm-1.6b-quickstart"
    np.testing.assert_allclose(out["losses"], jlosses, rtol=LOSS_RTOL)
    assert (tmp_path / "qs.npz").exists()


def test_quickstart_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        QS.main(["--steps", "1"])
