"""The port's synthetic data pipeline, bf16 weight copy and zoo trainer
against the JAX package, on the CPU.

* ``synthetic_batch`` and ``synthetic_stream`` equal the reference's
  arrays value for value (numpy draws in the reference's order), for a
  plain and a frontend config.
* ``make_train_step(compute_copy_dtype=bfloat16)``: the loss and the
  gradients it hands its optimizer against the reference's, on reduced
  Jamba (attention, Mamba, MoE and a dense MLP); the cast takes the
  reference's leaves; ``compute_copy_dtype=None`` is the step as it was.
* A 5-step loss curve of reduced StableLM-1.6B from carried weights,
  the port's parts (``make_train_step``, ``adamw(linear_warmup_cosine(
  3e-4, 10, 5))``, ``synthetic_stream``) against the same JAX parts; the
  reference's forward computes in bf16, so the curve is held at bf16.
* On a 1-rank mesh, ``make_train_step(param_shardings_tree=)`` with the
  bf16 copy is the one-process step (``rtol 1e-5``, the mean of its loss
  summed in another order).
* The trainer's ``main`` on reduced StableLM, Pixtral and Jamba on the
  CPU, ``--ckpt``, and a mesh larger than the world.

Tolerances (bf16: two frameworks round different sums):
- bf16 copy: loss ``rtol 1e-3`` (measured 1.2e-4); gradients in
  relative Frobenius norm, over all leaves and per leaf of more than
  10 000 entries, at most ``GRAD_REL`` = 0.04 (measured at most 0.019).
  The port's step without the copy sits 0.092 from the reference's
  bf16-copy gradients, so the gate tells the copy from none.
- loss curve: each step's loss ``rtol 1e-3`` (measured at most 1.6e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro import data as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.checkpoint.store import load_pytree  # noqa: E402
from repro_torch.distribution.context import activation_sharding  # noqa: E402
from repro_torch.distribution.sharding import param_shardings  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

COPY_LOSS_RTOL = 1e-3
GRAD_REL = 0.04
BIG_LEAF = 10_000
CURVE_RTOL = 1e-3


def _rel(a, r):
    return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))


@pytest.mark.parametrize("arch,batch,seq", [("stablelm-1.6b", 3, 17),
                                            ("pixtral-12b", 2, 24)])
def test_synthetic_batches_equal_jax(arch, batch, seq):
    jcfg, tcfg = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    ref = [JD.synthetic_batch(jcfg, batch, seq, seed=5)]
    got = [TD.synthetic_batch(tcfg, batch, seq, seed=5, device="cpu")]
    js, ts = (JD.synthetic_stream(jcfg, batch, seq, seed=2),
              TD.synthetic_stream(tcfg, batch, seq, seed=2, device="cpu"))
    ref += [next(js) for _ in range(3)]
    got += [next(ts) for _ in range(3)]
    for r, g in zip(ref, got):
        assert set(r) == set(g) == ({"tokens", "labels", "frontend"}
                                    if jcfg.frontend != "none" else {"tokens", "labels"})
        for k in r:
            a = np.asarray(r[k])
            assert g[k].dtype == getattr(torch, a.dtype.name)
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), a, err_msg=k)
    assert got[0]["tokens"].shape == (batch, seq - tcfg.frontend_tokens)


class _JaxCapture:
    """An optimizer that returns zero updates and keeps the gradients as
    its state (so a jitted step hands them back)."""

    def update(self, grads, state, params):
        return jax.tree.map(jnp.zeros_like, grads), grads


class _Capture:
    def update(self, grads, state, params, shardings=None):
        return tree_map(torch.zeros_like, grads), grads


def _copy_step_case(arch):
    jcfg, tcfg = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    step = JM.make_train_step(jcfg, _JaxCapture(), remat=False,
                              compute_copy_dtype=jnp.bfloat16)
    _, gref, m = jax.jit(step)(jp, None, JD.synthetic_batch(jcfg, 4, 32))
    batch = TD.synthetic_batch(tcfg, 4, 32, device="cpu")

    def port(copy):
        _, g, mt = TM.make_train_step(tcfg, _Capture(), remat=False,
                                      compute_copy_dtype=copy)(
            W.model_params_from_jax(np_params, "cpu"), None, batch)
        return float(mt["loss"]), W.model_params_to_numpy(g)

    return np_params, float(m["loss"]), jax.tree.map(np.asarray, gref), port


def _flat(tree):
    return np.concatenate([x.ravel() for x in jax.tree.leaves(tree)])


def test_bf16_copy_step_matches_jax():
    np_params, lref, gref, port = _copy_step_case("jamba-v0.1-52b")
    loss, grads = port(torch.bfloat16)
    np.testing.assert_allclose(loss, lref, rtol=COPY_LOSS_RTOL)
    assert jax.tree.structure(grads) == jax.tree.structure(gref)
    for g, p in zip(jax.tree.leaves(grads), jax.tree.leaves(np_params)):
        assert g.dtype == p.dtype  # cast back to the masters' dtype
    assert _rel(_flat(grads), _flat(gref)) <= GRAD_REL
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(gref)[0],
                            jax.tree.leaves(grads)):
        if r.size > BIG_LEAF:
            assert _rel(g, r) <= GRAD_REL, jax.tree_util.keystr(path)
    _, plain = port(None)  # the gate tells the copy from none
    assert _rel(_flat(plain), _flat(gref)) > GRAD_REL


def test_compute_copy_casts_what_the_reference_casts():
    """The reference's rule, leaf for leaf: f32 leaves of two or more dims
    are cast. A slot stacks its layers on a leading axis, so every slot
    leaf (the router, the norms, Mamba's ``a_log``, ``dt_bias`` and
    ``d_skip`` too) is cast, as are the embedding and head; the final norm
    and the frontend bias (1-D) stay f32."""
    for arch in ("jamba-v0.1-52b", "pixtral-12b"):
        shapes = jax.eval_shape(lambda a=arch: JM.init_params(
            jax.random.PRNGKey(0), JC.get_config(a).reduced()))
        rule = jax.tree.map(lambda a: "bfloat16" if a.ndim >= 2 else "float32",
                            shapes)
        params = TM.init_params(torch.Generator().manual_seed(0),
                                TC.get_config(arch).reduced(), device="cpu")
        got = tree_map(lambda a: str(a.dtype).replace("torch.", ""),
                       TM.compute_copy(params, torch.bfloat16))
        assert jax.tree.leaves(got) == jax.tree.leaves(rule)
        assert TM.compute_copy(params, torch.bfloat16)["final_norm"].dtype == torch.float32
    # the copy is cast on the masters' blocks: on a 1-rank mesh the sharded
    # step is the one-process step (its loss's mean sums in another order)
    cfg = TC.get_config("jamba-v0.1-52b").reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = TD.synthetic_batch(cfg, 2, 16, device="cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    psh = param_shardings(params, cfg, mesh)
    step = TM.make_train_step(cfg, _Capture(), compute_copy_dtype=torch.bfloat16,
                              param_shardings_tree=psh)
    with pytest.raises(ValueError, match="activation_sharding"):
        step(params, None, batch)
    with activation_sharding(mesh, ("data",)):
        _, got, m = step(params, None, batch)
    _, ref, mref = TM.make_train_step(cfg, _Capture(), compute_copy_dtype=torch.bfloat16)(
        params, None, batch)
    assert float(m["loss"]) == pytest.approx(float(mref["loss"]), rel=1e-6)
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_no_copy_step_is_unchanged():
    """``compute_copy_dtype=None``: autograd of the loss on the masters,
    then the update, bit for bit what ``loss_and_grads`` and the optimizer
    give."""
    cfg = TC.get_config("stablelm-1.6b").reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = TD.synthetic_batch(cfg, 2, 16, device="cpu")
    opt = TO.adamw(1e-3, max_grad_norm=1.0)
    new, _, m = TM.make_train_step(cfg, opt)(params, opt.init(params), batch)
    (_, (loss, _)), grads = TM.loss_and_grads(params, batch, cfg)
    ups, _ = opt.update(grads, opt.init(params), params)
    assert float(m["loss"]) == float(loss)
    for a, b in zip(tree_leaves(new), tree_leaves(TO.apply_updates(params, ups))):
        assert torch.equal(a, b)


def test_loss_curve_matches_jax():
    """Five steps of reduced StableLM-1.6B from carried weights: the
    reference's trainer parts on both sides, bf16 forward, f32 masters."""
    jcfg = JC.get_config("stablelm-1.6b").reduced()
    tcfg = TC.get_config("stablelm-1.6b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = JO.adamw(JO.linear_warmup_cosine(3e-4, 10, 5), max_grad_norm=1.0)
    topt = TO.adamw(TO.linear_warmup_cosine(3e-4, 10, 5), max_grad_norm=1.0)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(JM.make_train_step(jcfg, jopt))
    tstep = TM.make_train_step(tcfg, topt)
    jstream = JD.synthetic_stream(jcfg, 8, 64)
    tstream = TD.synthetic_stream(tcfg, 8, 64, device="cpu")
    ref, got = [], []
    for _ in range(5):
        jp, js, jm = jstep(jp, js, next(jstream))
        tp, ts, tm = tstep(tp, ts, next(tstream))
        ref.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, ref, rtol=CURVE_RTOL)
    assert int(ts.step) == 5


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "pixtral-12b", "jamba-v0.1-52b"])
def test_main_trains_on_cpu(arch, tmp_path, capsys):
    ckpt = tmp_path / "params.npz"
    res = TRAIN.main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32",
                      "--device", "cpu", "--bf16-compute", "--ckpt", str(ckpt)])
    assert len(res["losses"]) == len(res["step_seconds"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert res["cfg"] == TC.get_config(arch).reduced()
    out = capsys.readouterr().out
    assert "step    0  loss" in out and "step    2  loss" in out
    assert f"saved -> {ckpt}" in out
    back = load_pytree(str(ckpt), res["params"])
    for a, b in zip(tree_leaves(back), tree_leaves(res["params"])):
        assert torch.equal(a, b)


def test_main_refuses_meshes_and_takes_published_widths():
    args = TRAIN.parse_args(["--data-par", "2", "--model-par", "2"])
    assert (args.data_par, args.model_par) == (2, 2)
    assert (TRAIN.parse_args([]).data_par, TRAIN.parse_args([]).model_par) == (1, 1)
    # a mesh larger than the world raises (one rank here)
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        TRAIN.main(["--data-par", "2", "--model-par", "2", "--device", "cpu"])
    args = TRAIN.parse_args(["--no-reduced", "--depth", "2"])
    assert not args.reduced and args.depth == 2
    assert TRAIN.parse_args([]).reduced  # reduced stays the default
    cfg = TRAIN.executed_config("jamba-v0.1-52b", 2, reduced=False)
    assert (cfg.num_layers, cfg.block_pattern, cfg.d_model) == (2, "MM", 4096)
    assert TRAIN.executed_config("jamba-v0.1-52b", 4, reduced=True).pattern == "AMAM"
