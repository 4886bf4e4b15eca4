"""The port's checkpoints: the tree store, the train-state pairs and the
generator states, and cross-reading with the JAX package's archives.

Trees round-trip exactly (bf16 leaves through their f32 copy, int and
bool leaves as they are); writes leave no temp file; an orphan half of a
pair is ignored and a garbage ``LATEST`` falls back to the scan;
``validate_resume`` refuses another run's fingerprint and a checkpoint
past the requested episodes. SAC params and AdamW states written by the
JAX ``save_pytree`` load in the port equal to the JAX values, and the
reverse: both sides name a leaf by its key path.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.checkpoint import store as JST  # noqa: E402
from repro.core.agents import sac as JSAC  # noqa: E402
from repro.core.env import MHSLEnv as JEnv  # noqa: E402
from repro.core.profiles import resnet101_profile  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.checkpoint import store as ST  # noqa: E402
from repro_torch.checkpoint import train_state as TS  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(3, 4, generator=g),
        "half": torch.randn(5, generator=g).to(torch.bfloat16),
        "layers": [{"b": torch.arange(6, dtype=torch.int32)},
                   (torch.tensor([True, False, True]), torch.tensor(7, dtype=torch.int64))],
        "opt": OptState(step=torch.tensor(3, dtype=torch.int32),
                        mu={"x": torch.ones(2)}, nu={"x": torch.zeros(2)}),
        "empty": (),
        "gen": TS.generator_leaf(g),
    }


def _zeros_like(tree):
    from repro_torch.tree import tree_map

    return tree_map(torch.zeros_like, tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_round_trip_nested_tree(tmp_path):
    tree = _tree()
    path = os.fspath(tmp_path / "t.npz")
    ST.save_pytree(tree, path)
    got = ST.load_pytree(path, _zeros_like(tree))
    assert _equal(got, tree)
    assert isinstance(got["opt"], OptState) and got["empty"] == ()
    with np.load(path) as z:
        manifest = json.loads(str(z["__manifest__"]))
        assert "half::bf16" in manifest and z["half"].dtype == np.float32
        assert {"layers/0/b", "layers/1/0", "opt/.step", "opt/.mu/x", "gen"} <= set(z.files)


def test_load_checks_names_and_shapes(tmp_path):
    path = os.fspath(tmp_path / "t.npz")
    ST.save_pytree({"a": torch.zeros(3)}, path)
    with pytest.raises(KeyError, match="missing leaf b"):
        ST.load_pytree(path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ST.load_pytree(path, {"a": torch.zeros(4)})
    got = ST.load_pytree(path, {"a": torch.zeros(3, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64  # cast to the like leaf's dtype


def test_atomic_write_leaves_nothing_behind(tmp_path, monkeypatch):
    path = os.fspath(tmp_path / "sub" / "t.npz")
    ST.save_pytree({"a": torch.ones(2)}, path)
    assert sorted(os.listdir(tmp_path / "sub")) == ["t.npz"]

    def torn(f, **arrays):
        f.write(b"half an archive")
        raise OSError("disk full")

    monkeypatch.setattr(ST.np, "savez", torn)
    with pytest.raises(OSError):
        ST.save_pytree({"a": torch.zeros(2)}, path)
    assert sorted(os.listdir(tmp_path / "sub")) == ["t.npz"]  # no .tmp left
    monkeypatch.undo()
    assert torch.equal(ST.load_pytree(path, {"a": torch.zeros(2)})["a"], torch.ones(2))


def test_latest_step_orphans_and_garbage(tmp_path):
    d = os.fspath(tmp_path / "ck")
    assert TS.latest_checkpoint_step(d) is None
    TS.save_train_checkpoint(d, 4, {"a": torch.ones(1)}, {"ep": 4})
    TS.save_train_checkpoint(d, 8, {"a": torch.ones(1)}, {"ep": 8})
    assert TS.latest_checkpoint_step(d) == 8
    # a crash between the two writes of step 12 leaves an orphan npz
    ST.save_pytree({"a": torch.ones(1)}, os.path.join(d, "step_00000012.npz"))
    assert TS.latest_checkpoint_step(d) == 8
    # LATEST naming an incomplete step, or garbage, falls back to the scan
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("12")
    assert TS.latest_checkpoint_step(d) == 8
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("not a step")
    assert TS.latest_checkpoint_step(d) == 8
    os.remove(os.path.join(d, "step_00000008.json"))  # an orphan npz again
    step, dev, host = TS.load_train_checkpoint(d, {"a": torch.zeros(1)})
    assert (step, host["ep"], host["step"]) == (4, 4, 4)
    assert torch.equal(dev["a"], torch.ones(1))
    with pytest.raises(FileNotFoundError):
        TS.load_train_checkpoint(os.fspath(tmp_path / "none"), {"a": torch.zeros(1)})


def test_validate_resume_refusals():
    meta = dict(seed=1, num_envs=2, cfg="SACConfig()", scenario=None)
    assert TS.validate_resume({"meta": meta, "ep": 6}, meta, 10, "d") == 6
    with pytest.raises(ValueError, match="cannot resume"):
        TS.validate_resume({"meta": dict(meta, seed=2), "ep": 6}, meta, 10, "d")
    with pytest.raises(ValueError, match="cannot resume"):
        TS.validate_resume({"ep": 6}, meta, 10, "d")
    with pytest.raises(ValueError, match="past the requested"):
        TS.validate_resume({"meta": meta, "ep": 12}, meta, 10, "d")


def test_pytree_fingerprint():
    a = {"x": torch.ones(3), "y": torch.arange(2)}
    assert TS.pytree_fingerprint(None) is None
    assert TS.pytree_fingerprint(a) == TS.pytree_fingerprint(
        {"x": torch.ones(3), "y": torch.arange(2)})
    assert TS.pytree_fingerprint(a) != TS.pytree_fingerprint(
        {"x": torch.ones(3) * 2, "y": torch.arange(2)})


def test_generator_state_round_trip(tmp_path):
    """A CPU generator's state survives the archive: the draws after a
    restore repeat the draws after the save, bit for bit."""
    g = torch.Generator().manual_seed(11)
    torch.rand(5, generator=g)
    path = os.fspath(tmp_path / "g.npz")
    ST.save_pytree({"gen": TS.generator_leaf(g)}, path)
    after = torch.rand(7, generator=g)
    fresh = torch.Generator().manual_seed(0)
    like = {"gen": TS.generator_leaf(fresh)}
    TS.restore_generator(fresh, ST.load_pytree(path, like)["gen"])
    assert torch.equal(torch.rand(7, generator=fresh), after)
    # a row of stacked states restores too
    rows = torch.stack([TS.generator_leaf(torch.Generator().manual_seed(s))
                        for s in (1, 2)])
    h = TS.restore_generator(torch.Generator(), rows[1])
    assert torch.equal(torch.rand(3, generator=h),
                       torch.rand(3, generator=torch.Generator().manual_seed(2)))


SMALL = dict(hidden=32, feat_dim=8, attn_dim=8, batch=16)


@pytest.fixture(scope="module")
def jax_agent():
    """JAX SAC params and AdamW state (moments made nonzero by one step of
    made-up gradients), as JAX arrays."""
    env = JEnv(profile=resnet101_profile(batch=1))
    cfg = JSAC.SACConfig(**SMALL)
    params = JSAC.init_agent(jax.random.PRNGKey(4), env.obs_dim, env.action_dims, cfg)
    _, init_opt = JSAC.make_update(env.action_dims, cfg)
    opt = init_opt(params)
    from repro.optim.optimizers import adamw

    grads = jax.tree.map(lambda x: 0.01 * x + 0.001, params["actor"])
    _, opt_actor = adamw(1e-3).update(grads, opt["actor"], params["actor"])
    opt = dict(opt, actor=opt_actor)
    return params, opt


def test_jax_archive_loads_in_the_port(tmp_path, jax_agent):
    params, opt = jax_agent
    path = os.fspath(tmp_path / "jax.npz")
    JST.save_pytree({"params": params, "opt_state": opt}, path)
    np_params = jax.tree.map(np.asarray, params)
    np_opt = jax.tree.map(np.asarray, opt)
    like = {"params": W.sac_params_from_jax(np_params, "cpu"),
            "opt_state": W.sac_opt_state_from_jax(np_opt, "cpu")}
    like = {"params": _zeros_like(like["params"]),
            "opt_state": _zeros_like(like["opt_state"])}
    got = ST.load_pytree(path, like)
    want = {"params": W.sac_params_from_jax(np_params, "cpu"),
            "opt_state": W.sac_opt_state_from_jax(np_opt, "cpu")}
    assert _equal(got, want)
    assert int(got["opt_state"]["actor"].step) == 1


def test_port_archive_loads_in_jax(tmp_path, jax_agent):
    params, opt = jax_agent
    tree = {"params": W.sac_params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
            "opt_state": W.sac_opt_state_from_jax(jax.tree.map(np.asarray, opt), "cpu")}
    path = os.fspath(tmp_path / "port.npz")
    ST.save_pytree(tree, path)
    like = jax.tree.map(lambda x: jax.numpy.zeros_like(x), {"params": params,
                                                           "opt_state": opt})
    got = JST.load_pytree(path, like)
    want = {"params": params, "opt_state": opt}
    flat_g, tdef_g = jax.tree_util.tree_flatten(got)
    flat_w, tdef_w = jax.tree_util.tree_flatten(want)
    assert tdef_g == tdef_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
