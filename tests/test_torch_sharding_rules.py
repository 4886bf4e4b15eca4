"""The parameter, cache and batch placement rules, the activation
context and ``flash_decode``'s local math, in one process (no ranks).

* ``spec_for_param``, ``param_shardings`` (both modes, over the params
  and the AdamW state) and ``cache_shardings`` equal the JAX package's,
  leaf for leaf, for every zoo config at published shapes
  (``jax.eval_shape`` of the JAX ``init_params`` / ``init_caches``:
  nothing is allocated), on device-free grids ``(data, model) = (16,
  16), (2, 2), (4, 2)`` and ``(pod, data, model) = (2, 16, 16)``; and
  each rank's block is the rows the JAX spec places at its coordinates.
* ``tests/test_distribution.py::test_spec_for_param_rules`` and
  ``::test_batch_axes_divisibility``, mirrored.
* The context's predicates against the reference's on the same grids.
* ``flash_decode`` on a 1-rank mesh against the JAX package's
  ``flash_attention_ref`` (``tests/test_flash_decode.py``'s cases) at
  ``atol 1e-5``, the reference's gate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distribution import context as JCTX  # noqa: E402
from repro.distribution import sharding as JS  # noqa: E402
from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distribution import context as TCTX  # noqa: E402
from repro_torch.distribution import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.flash_decode import flash_decode  # noqa: E402

GRIDS = [(("data", "model"), (16, 16)), (("data", "model"), (2, 2)),
         (("data", "model"), (4, 2)), (("pod", "data", "model"), (2, 16, 16))]
GRID_IDS = ["16x16", "2x2", "4x2", "2x16x16"]
CACHE_BATCH, CACHE_LEN = 32, 4096
DECODE_ATOL = 1e-5


class _JaxGrid(AbstractMesh):
    """A device-free JAX mesh: the reference's rules read only its axis
    names and ``devices.shape``."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes)


@pytest.fixture(scope="module")
def shapes():
    """Per zoo config: the JAX params, AdamW state and cache shape trees."""
    out = {}
    for arch in JC.ARCH_IDS:
        cfg = JC.get_config(arch)
        p = jax.eval_shape(lambda c=cfg: JM.init_params(jax.random.PRNGKey(0), c))
        out[arch] = dict(params=p, opt=jax.eval_shape(jax_adamw(1e-3).init, p),
                         caches=jax.eval_shape(lambda c=cfg: JM.init_caches(
                             c, CACHE_BATCH, CACHE_LEN)))
    return out


def _jax_rows(entry, names, sizes, coords, dim):
    """The rows of a ``dim``-long dimension a ``PartitionSpec`` entry
    places on the device at ``coords`` of a row-major device grid."""
    axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    n, block = 1, 0
    for a in axes:
        i = names.index(a)
        n, block = n * sizes[i], block * sizes[i] + coords[i]
    per = dim // n
    return range(block * per, (block + 1) * per)


def _check_blocks(names, sizes, placed):
    """Each record's block, on every coordinate, is the JAX rows of every
    dimension. ``placed``: ``{(spec, shape)}`` pairs."""
    for coords in np.ndindex(*sizes):
        mesh = Mesh(names, sizes, coords)
        for spec, shape in placed:
            got = TS.Sharding(mesh, spec).index(shape)
            for d, (sl, n) in enumerate(zip(got, shape)):
                assert range(n)[sl] == _jax_rows(spec[d], names, sizes, coords, n), \
                    (spec, shape, coords)


def _compare(jax_tree, torch_tree):
    """Leaf for leaf (matched by key path), the same spec."""
    from repro_torch.tree import tree_leaves_with_path

    want = {JS._path_str(p): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = {TS._path_str(p): s.spec for p, s in tree_leaves_with_path(torch_tree)}
    assert got == want


@pytest.mark.parametrize("names,sizes", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_rules_equal_the_reference(shapes, arch, names, sizes):
    jmesh = _JaxGrid(sizes, names)
    tmesh = Mesh(names, sizes, (0,) * len(sizes))
    cfg = TC.get_config(arch)
    sh = shapes[arch]
    placed = set()
    for tree in ("params", "opt"):
        for mode in ("train", "serve"):
            got = TS.param_shardings(sh[tree], cfg, tmesh, mode=mode)
            _compare(JS.param_shardings(sh[tree], JC.get_config(arch), jmesh, mode=mode),
                     got)
            placed |= {(s.spec, tuple(x.shape)) for s, x in zip(
                jax.tree.leaves(got, is_leaf=lambda t: isinstance(t, TS.Sharding)),
                jax.tree.leaves(sh[tree]))}
    got = TS.cache_shardings(sh["caches"], cfg, tmesh, CACHE_BATCH)
    _compare(JS.cache_shardings(sh["caches"], JC.get_config(arch), jmesh, CACHE_BATCH), got)
    placed |= {(s.spec, tuple(x.shape)) for s, x in zip(
        jax.tree.leaves(got, is_leaf=lambda t: isinstance(t, TS.Sharding)),
        jax.tree.leaves(sh["caches"]))}
    # every leaf shape was placed; a block's global shape is the leaf's
    for spec, shape in placed:
        rec = TS.Sharding(tmesh, spec)
        assert rec.global_shape(rec.block_shape(shape)) == shape
    _check_blocks(names, sizes, placed)


def test_spec_for_param_rules():
    cfg = TC.get_config("qwen2.5-3b")
    mesh = Mesh(("data", "model"), (16, 16), (0, 0))
    assert TS.spec_for_param("embed", (cfg.vocab_size, cfg.d_model), cfg, mesh) == ("model", "data")
    assert TS.spec_for_param("slots/0/attn/wq", (36, 2048, 2048), cfg, mesh) == (None, "data", "model")
    assert TS.spec_for_param("slots/0/attn/wo", (36, 2048, 2048), cfg, mesh) == (None, "model", "data")
    assert TS.spec_for_param("slots/0/norm1", (36, 2048), cfg, mesh) == (None, None)
    # indivisible dims are not sharded
    assert TS.spec_for_param("slots/0/attn/wq", (36, 100, 2048), cfg, mesh) == (None, None, "model")
    # MoE experts on the model axis
    moe = TC.get_config("qwen3-moe-30b-a3b")
    assert TS.spec_for_param("slots/0/moe/w_up", (48, 128, 2048, 768), moe, mesh) == (
        None, "model", "data", None)


def test_batch_axes_divisibility():
    m3 = Mesh(("pod", "data", "model"), (2, 16, 16), (0, 0, 0))
    assert TS.batch_axes(m3, 256) == ("pod", "data")
    assert TS.batch_axes(m3, 2) == ("pod",)
    assert TS.batch_axes(m3, 1) is None
    assert TS.batch_axes(Mesh(("data", "model"), (16, 16), (0, 0)), 128) == ("data",)
    rec = TS.batch_sharding(m3, 64, extra_dims=2)
    assert rec.spec == (("pod", "data"), None, None)
    assert rec.block_shape((64, 3, 5)) == (2, 3, 5)


@pytest.mark.parametrize("names,sizes", GRIDS, ids=GRID_IDS)
def test_context_predicates_equal_the_reference(names, sizes):
    jmesh, tmesh = _JaxGrid(sizes, names), Mesh(names, sizes, (0,) * len(sizes))
    assert not TCTX.active() and not TCTX.model_axis_divides(4)
    for kv, a2a in ((False, False), (True, True)):
        with JCTX.activation_sharding(jmesh, ("data",), kv_seq_shard=kv, moe_a2a=a2a), \
                TCTX.activation_sharding(tmesh, ("data",), kv_seq_shard=kv, moe_a2a=a2a):
            assert TCTX.active() and TCTX.batch_axes() == ("data",)
            assert TCTX.kv_seq_shard_enabled() == JCTX.kv_seq_shard_enabled() == kv
            assert TCTX.moe_a2a_enabled() == JCTX.moe_a2a_enabled() == a2a
            for n in range(1, 40):
                assert TCTX.model_axis_divides(n) == JCTX.model_axis_divides(n), n
            x = torch.zeros(4, 6)
            assert TCTX.constrain(x, {0: "batch", 1: "model"}) is x
    assert not TCTX.active()


_REF = jax.jit(flash_attention_ref, static_argnames=("causal", "window"))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("idx", [0, 7, 19, 31])
def test_flash_decode_local_math_matches_reference(idx, window):
    """The reference test slices the cache to ``idx + 1`` entries; here
    the reference runs over the whole cache, where its causal mask at
    ``q_offset = idx`` leaves the same entries out (one compile a
    window)."""
    b, l, h, kh, hd = 4, 32, 4, 2, 16
    rng = np.random.default_rng(0)
    q, ck, cv = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, 1, h, hd), (b, l, kh, hd), (b, l, kh, hd)))
    ref = _REF(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), causal=True,
               window=window, q_offset=jnp.int32(idx))
    mesh = Mesh(("data", "model"), (1, 1), (0, 0))
    with TCTX.activation_sharding(mesh, ("data",)):
        got = flash_decode(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), torch.tensor(idx), window=window)
        # per-row positions: every row at idx
        rows = flash_decode(torch.from_numpy(q), torch.from_numpy(ck),
                            torch.from_numpy(cv), torch.full((b,), idx), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DECODE_ATOL)
    np.testing.assert_array_equal(rows.numpy(), got.numpy())
