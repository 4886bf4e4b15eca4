"""Parity of the port's cached model (serving) with the JAX package, on
the CPU.

Cached attention (a scalar cache index, a per-row vector index, the
sliding-window ring, a write clamped at the cache's edge) against JAX
``attention_apply``; the port's vector index bitwise equal to its scalar
index; the conv state, ``ssd_decode_step`` and cached ``mamba_apply``
(decode, a prefill from ``h0``, the kernel route that drops the state);
``init_caches``; and a prefill plus 6 teacher-forced decode steps of
``forward`` for reduced Qwen2.5-3B, Qwen3-MoE-30B-A3B (dropless),
Mamba2-370m and Jamba-v0.1-52B. Inputs are numpy draws from a seed;
params are drawn by the JAX package and carried with
``weights.model_params_from_jax``. The JAX references are ``jax.jit``-ed.

Tolerance: f32 leaf-scale ``rtol 2e-5`` (``atol = rtol * max|ref|``),
the JAX package's own f32 gate, for outputs, logits and caches alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

RTOL = 2e-5


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_config(arch).reduced(), **kw),
            dataclasses.replace(TC.get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------------------
# cached attention
# ---------------------------------------------------------------------------

# (case, B, s, cache_len, window, index): scalar and vector indices, the
# ring (cache_len == window, one token, positions past the window), and a
# scalar write at the edge that jax.lax.dynamic_update_slice clamps
ATTN_CASES = [
    ("scalar_prefill", 2, 5, 12, None, 0),
    ("scalar_decode", 3, 1, 12, None, 7),
    ("vector_decode", 3, 1, 12, None, [0, 5, 11]),
    ("vector_chunk", 2, 3, 12, None, [2, 6]),
    ("window_mask", 2, 1, 12, 4, [3, 9]),
    ("ring_scalar", 2, 1, 8, 8, 13),
    ("ring_vector", 3, 1, 8, 8, [2, 8, 21]),
    ("edge_clamp", 2, 4, 10, None, 8),
]


@pytest.mark.parametrize("case,b,s,cache_len,window,index", ATTN_CASES,
                         ids=[c[0] for c in ATTN_CASES])
def test_cached_attention_matches_jax(case, b, s, cache_len, window, index):
    jcfg, tcfg = _cfgs("qwen2.5-3b", attention_window=window)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    shape = (b, cache_len, jcfg.num_kv_heads, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    idx = np.asarray(index, np.int32)
    pos = (idx[:, None] + np.arange(s)) if idx.ndim else idx + np.arange(s)
    ref, rc = jax.jit(lambda p, xx, k, v, i, ps: JL.attention_apply(
        p, xx, jcfg, positions=ps, kv_cache={"k": k, "v": v},
        cache_index=i))(jp, x, ck, cv, idx, pos.astype(np.int32))
    with torch.no_grad():
        out, nc = TL.attention_apply(
            tp, _t(x), tcfg, positions=_t(pos).long(),
            kv_cache={"k": _t(ck), "v": _t(cv)}, cache_index=_t(idx).long())
    _close(out.numpy(), ref, what=case)
    _close(nc["k"].numpy(), rc["k"], what=case)
    _close(nc["v"].numpy(), rc["v"], what=case)


def test_row_cache_update_clamps_like_dynamic_update_slice():
    """Each row's write lands where ``jax.lax.dynamic_update_slice`` puts
    it, also past either edge, bitwise: per-row starts and a scalar one,
    through ``cache_plan``'s rows and ``_row_cache_update``."""
    _, tcfg = _cfgs("qwen2.5-3b")
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((4, 6, 2, 3)).astype(np.float32)
    fresh = rng.standard_normal((4, 2, 2, 3)).astype(np.float32)
    idx = np.asarray([0, 3, 5, 9], np.int32)
    ref = jax.vmap(lambda c, u, i: jax.lax.dynamic_update_slice(
        c, u, (i, 0, 0)))(cache, fresh, idx)
    pos = _t(idx).long()[:, None] + torch.arange(2)
    plan = TL.cache_plan(tcfg, pos, _t(idx).long(), 4, 2, 6)
    got = TL._row_cache_update(_t(cache), _t(fresh), plan.rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    plan = TL.cache_plan(tcfg, 7 + torch.arange(2), 7, 4, 2, 6)
    got = TL._row_cache_update(_t(cache), _t(fresh), plan.rows)
    ref = jax.lax.dynamic_update_slice(cache, fresh, (0, 7, 0, 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _prefilled(cfg, params, b=3, p=6, extra=4, seed=0):
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)))
    caches = TM.init_caches(cfg, b, p + extra, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        _, caches, _ = TM.forward(params, prompts, cfg, caches=caches,
                                  cache_index=0, compute_dtype=torch.float32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
    return caches, tok


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b"])
def test_vector_index_bitwise_equals_scalar(arch):
    """Decoding every row at one common position through a (B,) cache
    index is bitwise the scalar-index path: logits and every cache."""
    cfg = TC.get_config(arch).reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches, tok = _prefilled(cfg, params)
    with torch.no_grad():
        ls, cs, _ = TM.forward(params, tok, cfg, caches=caches, cache_index=6,
                               compute_dtype=torch.float32)
        lv, cv, _ = TM.forward(params, tok, cfg, caches=caches,
                               cache_index=torch.full((3,), 6),
                               compute_dtype=torch.float32)
    assert torch.equal(ls, lv)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, cs, is_leaf=torch.is_tensor)),
                    jax.tree.leaves(jax.tree.map(np.asarray, cv, is_leaf=torch.is_tensor))):
        np.testing.assert_array_equal(a, b)


def test_init_caches_has_the_reference_layout():
    """Same tree, shapes and dtypes as JAX ``init_caches``, all zeros,
    for every block kind and a sliding window."""
    for arch, kw in (("qwen2.5-3b", {}), ("jamba-v0.1-52b", {}),
                     ("mamba2-370m", {}), ("qwen2.5-3b", {"attention_window": 8})):
        jcfg, tcfg = _cfgs(arch, **kw)
        ref = JM.init_caches(jcfg, 3, 12)
        got = TM.init_caches(tcfg, 3, 12, device="cpu")
        rl = jax.tree_util.tree_flatten_with_path(ref)[0]
        gl = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor))[0]
        assert [jax.tree_util.keystr(p) for p, _ in rl] == \
            [jax.tree_util.keystr(p) for p, _ in gl]
        for (_, r), (_, g) in zip(rl, gl):
            assert tuple(g.shape) == r.shape, arch
            assert str(g.dtype).split(".")[-1] == str(r.dtype), arch
            assert not bool(g.any())


# ---------------------------------------------------------------------------
# Mamba decode
# ---------------------------------------------------------------------------


def test_causal_conv1d_state_matches_jax():
    """The conv continued from a state over 1 and over 5 steps."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    for s in (1, 5):
        x = rng.standard_normal((2, s, 24)).astype(np.float32)
        yr, sr = JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(bias), state=jnp.asarray(st))
        y, sn = TS.causal_conv1d(_t(x), _t(w), _t(bias), state=_t(st))
        _close(y.numpy(), yr)
        np.testing.assert_array_equal(sn.numpy(), np.asarray(sr))


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    b, h, p, n = 3, 4, 8, 16
    x = rng.standard_normal((b, 1, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, 1, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, h).astype(np.float32)
    bm = rng.standard_normal((b, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, 1, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    yr, hr = JS.ssd_decode_step(x, dt, a, bm, cm, h0)
    y, hn = TS.ssd_decode_step(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(h0))
    _close(y.numpy(), yr)
    _close(hn.numpy(), hr)


@pytest.mark.parametrize("mode", ["decode", "prefill_h0", "pallas_prefill"])
def test_cached_mamba_apply_matches_jax(mode):
    """Cached ``mamba_apply`` at ``mamba2-370m.reduced()`` widths: one
    decode step from random states, a 70-step prefill from a random
    ``h0`` through ``ssd_chunked``, and the kernel route, which like the
    reference starts from zero whatever ``ssm_state`` is passed."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp = JS.init_mamba(jax.random.PRNGKey(2), jcfg)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    sc = jcfg.ssm
    di, nh = sc.d_inner(jcfg.d_model), sc.num_heads(jcfg.d_model)
    rng = np.random.default_rng(len(mode))
    s = 1 if mode == "decode" else 70
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, nh, sc.head_dim, sc.d_state)).astype(np.float32)
    c0 = rng.standard_normal((2, sc.d_conv - 1, di + 2 * sc.d_state)).astype(np.float32)
    pallas = mode == "pallas_prefill"
    ref, (hr, cr) = jax.jit(lambda p, xx, h, c: JS.mamba_apply(
        p, xx, jcfg, ssm_state=h, conv_state=c, use_pallas=pallas))(jp, x, h0, c0)
    with torch.no_grad():
        out, (hn, cn) = TS.mamba_apply(tp, _t(x), tcfg, ssm_state=_t(h0),
                                       conv_state=_t(c0), use_pallas=pallas)
        if pallas:  # the passed state is dropped: the same as a zero state
            out0, _ = TS.mamba_apply(tp, _t(x), tcfg, ssm_state=torch.zeros_like(_t(h0)),
                                     conv_state=_t(c0), use_pallas=True)
            assert torch.equal(out, out0)
    _close(out.numpy(), ref, what=mode)
    _close(hn.numpy(), hr, what=mode)
    _close(cn.numpy(), cr, what=mode)


# ---------------------------------------------------------------------------
# the cached model: prefill + decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m", "jamba-v0.1-52b"])
def test_prefill_and_decode_match_jax(arch):
    """``make_prefill_step`` over a (2, 8) prompt, then 6 decode steps
    of teacher-forced tokens at per-row positions (a vector index whose
    rows differ by one), f32: the last logits of every step and the final
    caches against JAX's."""
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = W.model_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(7)
    b, p, steps = 2, 8, 6
    prompts = rng.integers(0, jcfg.vocab_size, (b, p)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (steps, b, 1)).astype(np.int32)
    jpre = jax.jit(JM.make_prefill_step(jcfg, compute_dtype=jnp.float32))
    jdec = jax.jit(JM.make_decode_step(jcfg, compute_dtype=jnp.float32))
    tpre = TM.make_prefill_step(tcfg, compute_dtype=torch.float32)
    tdec = TM.make_decode_step(tcfg, compute_dtype=torch.float32)
    jc = JM.init_caches(jcfg, b, p + steps + 1, dtype=jnp.float32)
    tc = TM.init_caches(tcfg, b, p + steps + 1, dtype=torch.float32, device="cpu")
    jl, jc = jpre(jp, jnp.asarray(prompts), jc)
    with torch.no_grad():
        tl, tc = tpre(tp, torch.from_numpy(prompts), tc)
    _close(tl.numpy(), jl, what="prefill")
    # the second row starts one token later (it re-reads position p - 1)
    pos = np.asarray([p, p - 1], np.int32)
    for i in range(steps):
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tdec(tp, torch.from_numpy(feed[i]), tc, torch.from_numpy(pos))
        _close(tl.numpy(), jl, what=f"decode step {i}")
        pos = pos + 1
    rl = jax.tree.leaves(jc)
    gl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc, is_leaf=torch.is_tensor))
    assert len(rl) == len(gl)
    for r, g in zip(rl, gl):
        _close(g, r, what="caches")
