"""Parity of the port's modality frontends with the JAX package, on the CPU.

Reduced Pixtral-12B (vision, 1024-wide patch features) and MusicGen-large
(audio, 128-wide frame features), weights drawn by the JAX package and
carried by ``weights.model_params_from_jax``, features drawn by numpy:

* ``frontend_apply``, ``forward(frontend_feats=)`` logits over the
  joined length and the text-region ``loss_fn``, at f32;
* ``make_prefill_step(frontend_feats=)``: the last logits and the caches;
* ``init_params`` has the reference's layout, ``"frontend"`` included;
* the split executor runs tokens only: its 1F1B ``(loss, grads)`` against
  JAX's ``pipeline_step_fn`` on a 1-stage mesh, with zero gradients on
  the projector.

Tolerance: f32 leaf-scale ``rtol 2e-5`` (``atol = rtol * max|ref|``),
the JAX package's own f32 gate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import pipeline as JPIPE  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.models import frontends as TF  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RTOL = 2e-5
ARCHS = ("pixtral-12b", "musicgen-large")
B, S = 2, 12


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


@pytest.fixture(scope="module")
def case():
    """Per arch, once: the reduced configs, JAX params as numpy and as the
    port's tensors, tokens, labels and features."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = JC.get_config(arch).reduced()
            tcfg = TC.get_config(arch).reduced()
            np_params = jax.tree.map(np.asarray,
                                     JM.init_params(jax.random.PRNGKey(0), jcfg))
            rng = np.random.default_rng(0)
            tok = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
            lab = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
            feats = rng.standard_normal(
                (B, jcfg.frontend_tokens, TF.FRONTEND_DIMS[jcfg.frontend]),
                dtype=np.float32)
            cache[arch] = (jcfg, tcfg, np_params,
                           W.model_params_from_jax(np_params, "cpu"), tok, lab, feats)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_apply_matches_jax(case, arch):
    _, _, np_params, tp, _, _, feats = case(arch)
    ref = JF.frontend_apply(jax.tree.map(jnp.asarray, np_params["frontend"]),
                            jnp.asarray(feats))
    got = TF.frontend_apply(tp["frontend"], torch.from_numpy(feats))
    assert TF.FRONTEND_DIMS == JF.FRONTEND_DIMS
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_text_loss_match_jax(case, arch):
    """Logits over the feature prefix plus the text (positions over the
    joined length), and the loss over the text region only."""
    jcfg, tcfg, np_params, tp, tok, lab, feats = case(arch)
    jp = jax.tree.map(jnp.asarray, np_params)

    def jref(p):
        logits, _, _ = JM.forward(p, jnp.asarray(tok), jcfg,
                                  frontend_feats=jnp.asarray(feats),
                                  compute_dtype=jnp.float32)
        f = logits.shape[1] - lab.shape[1]
        return logits, JM.softmax_xent(logits[:, f:], jnp.asarray(lab))

    lref, loss_ref = jax.jit(jref)(jp)
    with torch.no_grad():
        logits, _, _ = TM.forward(tp, torch.from_numpy(tok), tcfg,
                                  frontend_feats=torch.from_numpy(feats),
                                  compute_dtype=torch.float32)
        _, (loss, _) = TM.loss_fn(
            tp, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
                 "frontend": torch.from_numpy(feats)},
            tcfg, compute_dtype=torch.float32)
    assert logits.shape == (B, jcfg.frontend_tokens + S, jcfg.vocab_size)
    _close(logits.numpy(), np.asarray(lref), what="logits")
    _close(float(loss), float(loss_ref), what="loss")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_frontend_matches_jax(case, arch):
    """A cached prefill of features then prompt: the last logits and every
    cache entry, f32."""
    jcfg, tcfg, np_params, tp, tok, _, feats = case(arch)
    cache_len = jcfg.frontend_tokens + S + 4
    jpre = JM.make_prefill_step(jcfg, compute_dtype=jnp.float32)
    jl, jc = jax.jit(jpre)(jax.tree.map(jnp.asarray, np_params), jnp.asarray(tok),
                           JM.init_caches(jcfg, B, cache_len, jnp.float32),
                           jnp.asarray(feats))
    tpre = TM.make_prefill_step(tcfg, compute_dtype=torch.float32)
    with torch.no_grad():
        tl, tc = tpre(tp, torch.from_numpy(tok),
                      TM.init_caches(tcfg, B, cache_len, torch.float32, device="cpu"),
                      frontend_feats=torch.from_numpy(feats))
    _close(tl.numpy(), np.asarray(jl), what="logits")
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, what=jax.tree_util.keystr(path)),
        jax.tree.map(np.asarray, jc), W.model_params_to_numpy(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    jshape = jax.tree.map(lambda a: (a.shape, a.dtype.name), jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), JC.get_config(arch).reduced())))
    tp = TM.init_params(torch.Generator().manual_seed(0),
                        TC.get_config(arch).reduced(), device="cpu")
    tshape = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                          W.model_params_to_numpy(tp))
    assert tshape == jshape
    assert set(tp["frontend"]) == {"proj", "bias"}


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_step_matches_jax_with_zero_frontend_grads(case, arch):
    """The executor runs a frontend config's tokens: 1F1B against the
    reference's ``pipeline_step_fn`` on a 1-stage mesh (port on 2 stages),
    and the projector's gradients exactly zero on both sides."""
    jcfg, tcfg, np_params, tp, tok, lab, _ = case(arch)
    pipe = dict(compute_dtype="float32")
    jstep = JPIPE.pipeline_step_fn(jcfg, JPIPE.make_stage_mesh(1),
                                   (jcfg.num_layers,), 2,
                                   pipe=JPIPE.PipelineConfig(**pipe))
    lj, gj = jax.jit(jstep)(jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(tok), jnp.asarray(lab))
    step = TPIPE.pipeline_step_fn(tcfg, (1, 2), 2, pipe=TPIPE.PipelineConfig(**pipe))
    loss, grads = step(tp, torch.from_numpy(tok).long(), torch.from_numpy(lab).long())
    np.testing.assert_allclose(float(loss), float(lj), rtol=RTOL)
    gnp = W.model_params_to_numpy(grads)
    assert jax.tree.structure(gnp) == jax.tree.structure(np_params)
    jax.tree_util.tree_map_with_path(
        lambda path, a, b: _close(b, a, what=jax.tree_util.keystr(path)),
        jax.tree.map(np.asarray, gj), gnp)
    for g in jax.tree.leaves(gnp["frontend"]):
        assert not g.any()
