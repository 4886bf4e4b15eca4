"""The population mesh on ``torch.distributed`` ranks, on the CPU.

* The placement rules (``population_axes``, ``population_sharding``,
  ``stage_sharding``, ``microbatch_sharding``) give, on every rank of the
  JAX package's test meshes, the rows the JAX rules' ``PartitionSpec``s
  place on the matching device.
* A 1-rank mesh is bit for bit ``mesh=None`` for ``train_sac`` and
  ``train_population`` (``tests/test_population_mesh.py``'s arguments).
* On gloo ranks (``tests/_torch_ranks.py``): ``train_population`` over 4
  ranks, and over a (2 x 2) stage x env mesh, is bit for bit the 1-rank
  run; ``train_sac`` over 2 ranks, each rolling out half of the envs, is
  bit for bit the 1-rank run; a stop and resume at 2 ranks is bit for bit
  the uninterrupted unsharded run, for both trainers; the launcher runs
  with ``--shard-envs``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from jax.sharding import AbstractMesh  # noqa: E402

import _torch_ranks as TR  # noqa: E402
from repro.distribution import sharding as JS  # noqa: E402
from repro_torch.core.agents.loops import train_sac  # noqa: E402
from repro_torch.core.agents.sac import SACConfig  # noqa: E402
from repro_torch.core.scenario import train_population  # noqa: E402
from repro_torch.distribution import population as PD  # noqa: E402
from repro_torch.distribution import sharding as TS  # noqa: E402
from repro_torch.launch import train_mhsl_rl as LAUNCH  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_population_mesh, make_stage_mesh)
from repro_torch.tree import tree_leaves  # noqa: E402


class _JaxGrid(AbstractMesh):
    """A device-free JAX mesh: the reference's rules read only its axis
    names and ``devices.shape``."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes)


def _jax_rows(spec_axes, mesh: Mesh, dim: int):
    """The rows of a ``dim``-long dimension that a ``PartitionSpec`` entry
    places on the device at ``mesh.coords`` of a row-major device grid:
    the dimension split into equal blocks over the named axes, the first
    outermost."""
    names = () if spec_axes is None else (
        (spec_axes,) if isinstance(spec_axes, str) else tuple(spec_axes))
    n, block = 1, 0
    for a in names:
        size = mesh.shape[a]
        n, block = n * size, block * size + mesh.coords[mesh.axis_names.index(a)]
    per = dim // n
    return list(range(block * per, (block + 1) * per))


MESHES = [(("env",), (4,)), (("stage", "env"), (2, 2)), (("data", "model"), (2, 1)),
          (("data", "model"), (4, 2)), (("stage",), (2,))]


@pytest.mark.parametrize("names,sizes", MESHES)
def test_rules_place_the_rows_jax_places(names, sizes):
    jmesh = _JaxGrid(sizes, names)
    for num in (1, 2, 3, 4, 6, 8):
        assert TS.population_axes(Mesh(names, sizes, (0,) * len(sizes)), num) == \
            JS.population_axes(jmesh, num), (num, names)
        for coords in np.ndindex(*sizes):
            mesh = Mesh(names, sizes, coords)
            want = _jax_rows(JS.population_sharding(jmesh, num, 2).spec[0], mesh, num)
            assert list(range(num)[TS.population_sharding(mesh, num, 2)]) == want
            assert list(PD.population_rows(mesh, num)) == want
    for coords in np.ndindex(*sizes):
        mesh = Mesh(names, sizes, coords)
        s = sizes[names.index("stage")] if "stage" in names else 2
        want = _jax_rows(JS.stage_sharding(jmesh, 2).spec[0], mesh, s)
        assert list(range(s)[TS.stage_sharding(mesh, 2, num=s)]) == want
        mb = 4 * (sizes[names.index("env")] if "env" in names else 1)
        want = _jax_rows(JS.microbatch_sharding(jmesh, 3).spec[1], mesh, mb)
        assert list(range(mb)[TS.microbatch_sharding(mesh, 3, rows=mb)]) == want


def test_mesh_grid_and_refusals():
    """The rank grid is stage-major; a 1-rank mesh needs no group; a
    mesh larger than the world raises; the population helpers are
    identities without a mesh and keep this rank's rows with one."""
    m = Mesh(("stage", "env"), (2, 3), (1, 2))
    assert m.rank == 1 * 3 + 2 and m.ranks.shape == (2, 3)
    assert m.axis_ranks("stage") == (2, 5) and m.axis_ranks("env") == (3, 4, 5)
    one = make_population_mesh(1, device="cpu")
    assert one.size == 1 and one.rank == 0 and one.groups == {}
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    for make in (lambda: make_population_mesh(2, device="cpu"),
                 lambda: make_stage_mesh(4, device="cpu"),
                 lambda: make_host_mesh(2, 1, device="cpu")):
        with pytest.raises(ValueError, match="ranks"):
            make()
    with pytest.raises(ValueError):
        Mesh(("env",), (2,), (2,))
    x = torch.arange(12.0).reshape(4, 3)
    tree = {"a": x, "b": torch.zeros(2)}
    assert PD.shard_population(tree, None, 4) is tree
    half = PD.shard_population(tree, Mesh(("env",), (2,), (1,)), 4)
    assert torch.equal(half["a"], x[2:]) and half["b"].shape == (2,)
    assert _trees_equal(PD.gather_population(half, one, 2), half)


def test_population_generator_keeps_its_rows():
    """A rank's draws are its rows of the whole population's draw, and
    the generator advances as the unsharded one does."""
    g0 = torch.Generator().manual_seed(3)
    g1 = torch.Generator().manual_seed(3)
    full = PD.population_rand((6, 4, 2), g0, "cpu")
    mine = PD.population_rand((2, 4, 2), PD.PopulationGenerator(g1, 6, range(2, 4)),
                              "cpu")
    assert torch.equal(mine, full[2:4])
    assert torch.equal(g0.get_state(), g1.get_state())
    with pytest.raises(ValueError):
        PD.population_rand((3, 4), PD.PopulationGenerator(g1, 6, range(2, 4)), "cpu")


@pytest.fixture(scope="module")
def env():
    return TR._env()


def _curves_equal(a, b):
    return TR.curves(a) == TR.curves(b)


def _trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_train_sac_one_rank_mesh_bit_identical(env):
    cfg = SACConfig()
    kw = dict(episodes=10, warmup_episodes=4, seed=5, num_envs=2)
    ref = train_sac(env, cfg, **kw)
    got = train_sac(env, cfg, mesh=make_population_mesh(1, device="cpu"), **kw)
    assert _curves_equal(got, ref)
    assert _trees_equal(got.params, ref.params)


def test_train_population_one_rank_mesh_bit_identical(env):
    cfg = SACConfig()
    scens = TR._scens(env, [0.3, 0.8])
    kw = dict(episodes=8, warmup_episodes=3, seed=5, num_envs=2)
    ref = train_population(env, cfg, scens, **kw)
    got = train_population(env, cfg, scens,
                           mesh=make_population_mesh(1, device="cpu"), **kw)
    for a, b in zip(got.results, ref.results):
        assert _curves_equal(a, b)
    assert _trees_equal(got.params, ref.params)


@pytest.fixture(scope="module")
def small():
    return SACConfig(**TR.SMALL_SAC)


# each rank group's limit: ~15 s when run alone, and up to ~130 s was seen
# beside five busy test workers on 8 cores
GROUP_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory, env, small):
    """The 2-rank and the 4-rank groups, side by side, and meanwhile the
    unsharded runs they are held to, on one torch thread as the ranks
    run."""
    tmp = tmp_path_factory.mktemp("mesh")
    two = TR.start("sac_runs", 2, tmp / "two")
    four = TR.start("population_runs", 4, tmp / "four")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = dict(
            sac=train_sac(env, small, **TR.SAC_KW),
            pop4=train_population(env, small, TR._scens(env, TR.POP_QS), **TR.POP_KW),
            pop2=train_population(env, small, TR._scens(env, TR.POP_QS[:2]),
                                  **TR.POP_KW))
    finally:
        torch.set_num_threads(threads)
    return dict(refs, two=TR.finish(two, GROUP_TIMEOUT_S),
                four=TR.finish(four, GROUP_TIMEOUT_S))


def test_two_rank_train_sac_bit_identical(runs):
    """Each rank rolls out 2 of the 4 envs on its rows of the shared
    draws; the gathered transitions feed one replay buffer on both ranks.
    The CPU computes a row the same at 2 and 4 rows, so it is bit for
    bit, updates included."""
    ref = runs["sac"]
    assert ref.metrics, "the run must update"
    for r in runs["two"]:
        got = r["sac"]
        assert {k: got[k] for k in TR.curves(ref)} == TR.curves(ref)
        assert got["metrics"] == ref.metrics
        assert _trees_equal(got["params"], ref.params)


def test_two_rank_resume_bit_identical(runs):
    """Stopped at episode 8 and resumed, on 2 ranks: the unsharded
    uninterrupted run, for both trainers."""
    for r in runs["two"]:
        got = r["sac_resumed"]
        assert {k: got[k] for k in TR.curves(runs["sac"])} == TR.curves(runs["sac"])
        assert _trees_equal(got["params"], runs["sac"].params)
        got = r["pop_resumed"]
        assert got["results"] == [TR.curves(x) for x in runs["pop2"].results]
        assert _trees_equal(got["params"], runs["pop2"].params)


def test_four_rank_population_bit_identical(runs):
    """Four scenarios over four ranks, one each: the 1-rank run."""
    ref = runs["pop4"]
    assert any(r.metrics for r in ref.results), "the run must update"
    for r in runs["four"]:
        assert r["pop4"]["results"] == [TR.curves(x) for x in ref.results]
        assert _trees_equal(r["pop4"]["params"], ref.params)


def test_stage_env_mesh_population_bit_identical(runs):
    """On a (2 x 2) stage x env mesh the scenarios ride 'env' (picked by
    name); ranks sharing an env column compute the same scenario."""
    for r in runs["four"]:
        assert r["stage_env"]["results"] == [TR.curves(x) for x in runs["pop2"].results]
        assert _trees_equal(r["stage_env"]["params"], runs["pop2"].params)


def test_launcher_shard_envs(runs):
    """``--shard-envs`` parses and runs on 2 ranks: both train the same
    controller and run a stage each of the plan's pipeline; rank 0 goes
    on to the eval."""
    assert LAUNCH.parse_args(["--shard-envs"]).shard_envs
    lead, other = (r["launcher"] for r in runs["two"])
    assert lead["rewards"] == other["rewards"] and len(lead["rewards"]) == 4
    assert {"losses", "eval_loss", "boundaries"} <= set(lead["keys"])
    assert {"losses", "boundaries", "stage_mesh"} <= set(other["keys"])
    assert "eval_loss" not in other["keys"]
