"""Parity of the port's split executor on mixed block periods with the JAX
package, on the CPU.

Mixed periods are Jamba's attention/Mamba hybrid (MoE every other
layer) and attention stacks with an MoE every k layers. The port applies
layer ``r`` with slot ``r % period``'s block, where the reference runs a
union layout under ``lax.switch``; both must give the plain forward's
gradients in the ``params["slots"]`` layout.

* The port's 1F1B ``(loss, grads)`` against ``jax.value_and_grad`` of the
  reference's plain ``forward`` (f32, ``remat=False``; the MoE router's
  ``aux`` is not in either loss): reduced Jamba (period 2) and reduced
  Qwen3-MoE at one stage, reduced Jamba as ``AMAM`` at the uneven split
  ``(1, 4)``, and Qwen3-MoE with ``moe_every=2`` at ``(2, 4)``; the
  ``AMAM`` case also against JAX's own ``pipeline_step_fn`` on an
  in-process 1-stage mesh (the union layout).
* The gradient tree has the reference's slots; ``fill_drain`` refuses
  mixed periods, naming ``1f1b``.
* Pipelined serving of the ``moe_every=2`` stack on 2 stages against
  JAX's ``pipeline_serve_fns`` on a 1-stage mesh: prefill and decode
  logits, and the greedy tokens.
* The split launcher on reduced Jamba, its pattern cut to the depth.

Tolerance: loss ``rtol 2e-5`` and gradients leaf-scale ``rtol 2e-5``
(``atol = rtol * max|ref|``), the JAX package's own 1F1B gate (the
reduced Jamba case's largest leaf error is 1.6e-5 of its leaf's max);
serving logits at the same leaf-scale gate.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import pipeline as JPIPE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RTOL = 2e-5
ROWS, SEQ, MICRO = 4, 16, 2


def _moe_every_2(mod):
    base = mod.get_config("qwen3-moe-30b-a3b").reduced()
    return dataclasses.replace(base, num_layers=4, d_ff=96,
                               moe=dataclasses.replace(base.moe, moe_every=2))


def _amam(mod):
    return dataclasses.replace(mod.get_config("jamba-v0.1-52b").reduced(),
                               num_layers=4, block_pattern="AMAM")


CONFIGS = {
    "jamba": lambda mod: mod.get_config("jamba-v0.1-52b").reduced(),
    "qwen3-moe": lambda mod: mod.get_config("qwen3-moe-30b-a3b").reduced(),
    "jamba-amam": _amam,
    "moe-every-2": _moe_every_2,
}


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _assert_grads_close(ref_np, port_np):
    assert jax.tree.structure(ref_np) == jax.tree.structure(port_np)
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, what=jax.tree_util.keystr(path)),
        ref_np, port_np)


@pytest.fixture(scope="module")
def reference():
    """Per config, once: JAX params (numpy), the batch, and value_and_grad
    of the plain f32 forward's loss."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = CONFIGS[name](JC)
            jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
            rng = np.random.default_rng(0)
            tok = rng.integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
            lab = rng.integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)

            def loss(p):
                logits, _, _ = JM.forward(p, jnp.asarray(tok), jcfg,
                                          compute_dtype=jnp.float32, remat=False)
                return JM.softmax_xent(logits, jnp.asarray(lab))

            lref, gref = jax.jit(jax.value_and_grad(loss))(jp)
            cache[name] = (jcfg, jax.tree.map(np.asarray, jp), tok, lab,
                           float(lref), jax.tree.map(np.asarray, gref))
        return cache[name]

    return get


def _port_step(name, np_params, tok, lab, bounds):
    tcfg = CONFIGS[name](TC)
    step = TPIPE.pipeline_step_fn(
        tcfg, bounds, MICRO, pipe=TPIPE.PipelineConfig(compute_dtype="float32"))
    loss, grads = step(W.model_params_from_jax(np_params, "cpu"),
                       torch.from_numpy(tok).long(), torch.from_numpy(lab).long())
    return float(loss), grads


@pytest.mark.parametrize("name,bounds", [
    ("jamba", (2,)),             # period 2: Mamba + MoE, attention + MLP
    ("qwen3-moe", (2,)),         # MoE every layer, one stage
    ("jamba-amam", (1, 4)),      # uneven split, stage lengths 1/3
    ("moe-every-2", (2, 4)),     # MoE then dense MLP, 2 stages
])
def test_mixed_1f1b_matches_jax_value_and_grad(reference, name, bounds):
    jcfg, np_params, tok, lab, lref, gref = reference(name)
    assert JM.find_period(JM.signature(jcfg)) == (1 if name == "qwen3-moe" else 2)
    loss, grads = _port_step(name, np_params, tok, lab, bounds)
    np.testing.assert_allclose(loss, lref, rtol=RTOL)
    _assert_grads_close(gref, W.model_params_to_numpy(grads))


def test_amam_matches_jax_pipeline_step_fn(reference):
    """The reference's own 1F1B (the union layout under ``lax.switch``, one
    stage on a 1-device mesh) against the port's at ``(1, 4)``."""
    jcfg, np_params, tok, lab, _, _ = reference("jamba-amam")
    step = JPIPE.pipeline_step_fn(jcfg, JPIPE.make_stage_mesh(1), (4,), MICRO,
                                  pipe=JPIPE.PipelineConfig(compute_dtype="float32"))
    lj, gj = jax.jit(step)(jax.tree.map(jnp.asarray, np_params),
                           jnp.asarray(tok), jnp.asarray(lab))
    loss, grads = _port_step("jamba-amam", np_params, tok, lab, (1, 4))
    np.testing.assert_allclose(loss, float(lj), rtol=RTOL)
    _assert_grads_close(jax.tree.map(np.asarray, gj), W.model_params_to_numpy(grads))


def test_grad_tree_has_the_reference_slots(reference):
    """Slot ``j`` of the gradients holds exactly its own fields, with the
    rows of layers ``j, j + period, ...``: the reference's
    ``split_union_grads`` layout."""
    _, np_params, tok, lab, _, _ = reference("jamba-amam")
    _, grads = _port_step("jamba-amam", np_params, tok, lab, (1, 4))
    assert len(grads["slots"]) == 2
    assert set(grads["slots"][0]) == {"norm1", "attn", "norm2", "moe"}
    assert set(grads["slots"][1]) == {"norm1", "mamba", "norm2", "mlp"}
    for j in range(2):
        for g, p in zip(jax.tree.leaves(W.model_params_to_numpy(grads["slots"][j])),
                        jax.tree.leaves(np_params["slots"][j])):
            assert g.shape == p.shape and g.shape[0] == 2


def test_fill_drain_refuses_mixed_periods():
    """The fill-drain reference stays period-1, as in the reference; the
    refusal names the schedule that runs mixed periods."""
    tcfg = CONFIGS["jamba-amam"](TC)
    for fn in (TPIPE.pipeline_loss_fn, lambda *a: TPIPE.pipeline_step_fn(
            *a, pipe=TPIPE.PipelineConfig(schedule="fill_drain"))):
        with pytest.raises(ValueError, match="1f1b"):
            fn(tcfg, (1, 4), 2)
    # period 1 still runs it
    TPIPE.pipeline_loss_fn(CONFIGS["qwen3-moe"](TC), (1, 2), 2)


B, P, EXTRA = 3, 8, 4


def test_mixed_serving_matches_jax_pipeline_serve_fns(reference):
    """MoE every other layer through the token ring on 2 stages, f32,
    against JAX's ``pipeline_serve_fns`` (one stage, the union layout's
    ``lax.switch``): prefill logits, one decode tick at per-row
    positions, and the greedy tokens of both."""
    jcfg, np_params, _, _, _, _ = reference("moe-every-2")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([P, P - 3, P - 1], np.int32)

    pipe = JPIPE.PipelineConfig(compute_dtype="float32")
    jpre, jdec = JPIPE.pipeline_serve_fns(jcfg, JPIPE.make_stage_mesh(1), (4,),
                                          pipe=pipe)
    jp = jax.tree.map(jnp.asarray, np_params)
    caches = JPIPE.stage_kv_caches(jcfg, (4,), B, P + EXTRA)
    jl, caches = jax.jit(jpre)(jp, caches, jnp.asarray(prompts))
    jd, _ = jax.jit(jdec)(jp, jnp.asarray(tok), caches, jnp.asarray(pos))

    tcfg = CONFIGS["moe-every-2"](TC)
    prefill, decode = TPIPE.pipeline_serve_fns(
        tcfg, (2, 4), pipe=TPIPE.PipelineConfig(compute_dtype="float32"))
    params = W.model_params_from_jax(np_params, "cpu")
    tcaches = TPIPE.stage_kv_caches(tcfg, (2, 4), B, P + EXTRA, device="cpu")
    tl, tcaches = prefill(params, tcaches, torch.from_numpy(prompts).long())
    td, _ = decode(params, torch.from_numpy(tok).long(), tcaches,
                   torch.from_numpy(pos).long())
    _close(tl.numpy(), np.asarray(jl), what="prefill")
    _close(td.numpy(), np.asarray(jd), what="decode")
    np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                  np.asarray(jl)[:, -1].argmax(-1))
    np.testing.assert_array_equal(td.argmax(-1).numpy(), np.asarray(jd).argmax(-1))
    assert TM.find_period(TM.signature(tcfg)) == 2


def test_split_launcher_runs_jamba_on_cpu():
    """The split launcher on Jamba: planned on the 32-layer profile, its
    pattern cut to the executed depth (``"AMAM"`` reduced), trained as a
    mixed-period 1F1B pipeline, with a held-out loss."""
    from repro_torch.launch import train_mhsl_rl as LAUNCH

    res = LAUNCH.main(["--arch", "jamba-v0.1-52b", "--reduced", "--device", "cpu",
                       "--depth", "4", "--stages", "2", "--episodes", "4",
                       "--num-envs", "2", "--pipeline-steps", "2", "--batch", "4",
                       "--seq", "16", "--eval-batch", "2", "--eval-seq", "32"])
    assert res["cfg"].pattern == "AMAM" and res["boundaries"][-1] == 4
    assert len(res["params"]["slots"]) == 2
    assert all(np.isfinite(res["losses"])) and np.isfinite(res["eval_loss"])
