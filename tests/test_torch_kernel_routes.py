"""Host-side logic of the port's tensor-core bodies, on the CPU: which
body a dtype takes, the split-K plan of the stage kernel's down product,
the check of what TMA can take, the grouped FFN's tile schedule (held to
``dropless_layout``), and emulations of the TF32 numerics of the SSD scan
and of ``ca_attention``.

These are pure functions of shapes, dtypes, addresses and data; the
kernels themselves run only on the card (``tests/test_torch_gpu.py``).
Only the ``ca_attention`` emulation's test imports JAX (inside the test),
to hold the emulation to the JAX kernel."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import stage_block as SB  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.kernels._tma import check_tma  # noqa: E402


@pytest.mark.parametrize("module", [FA, SB], ids=["flash_attention", "stage_mlp_block"])
@pytest.mark.parametrize("dtype,expect", [
    (torch.bfloat16, "wgmma"), (torch.float16, "wgmma"), (torch.float32, "fma")])
def test_dtype_fixes_the_body(module, dtype, expect):
    """16-bit inputs take the tensor-core body, f32 the FMA body."""
    assert module.body(dtype) == expect


@pytest.mark.parametrize("module", [FA, SB], ids=["flash_attention", "stage_mlp_block"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.float8_e4m3fn])
def test_no_body_for_other_dtypes(module, dtype):
    with pytest.raises(TypeError):
        module.body(dtype)


def _covered(splits, per, k_tiles):
    seen = []
    for z in range(splits):
        seen.extend(range(z * per, min((z + 1) * per, k_tiles)))
    return seen


@pytest.mark.parametrize("rows,d,f", [
    (512, 2048, 11008),   # the Split call (Qwen2.5-3B, 2 x 256 tokens)
    (130, 3072, 9216),    # Minitron-4B, ragged rows
    (37, 256, 512),       # small widths
    (8192, 2048, 11008),  # many rows: output tiles alone fill the card
    (1, 64, 100),         # F not a multiple of the k-tile
])
def test_split_k_plan_covers_f_once(rows, d, f):
    """Each k-tile of F belongs to exactly one split, every split is
    non-empty, and the splits tile F in multiples of the k-tile depth."""
    bm, bn, bk = SB.TC_TILE
    splits, per = SB.split_k_plan(rows, d, f)
    k_tiles = math.ceil(f / bk)
    assert splits >= 1 and per >= 1
    assert _covered(splits, per, k_tiles) == list(range(k_tiles))
    assert (splits - 1) * per < k_tiles <= splits * per
    ctas = math.ceil(rows / bm) * math.ceil(d / bn) * splits
    assert ctas >= min(SB.H100_SMS, math.ceil(rows / bm) * math.ceil(d / bn) * k_tiles)


def test_split_k_plan_at_the_split_shape():
    """At the Split call's shape the down product's 32 output tiles alone
    would leave most of 132 SMs idle; the plan gives at least 132 CTAs."""
    bm, bn, _ = SB.TC_TILE
    splits, per = SB.split_k_plan(512, 2048, 11008, sms=132)
    tiles = math.ceil(512 / bm) * math.ceil(2048 / bn)
    assert tiles * splits >= 132
    assert (splits, per) == (8, 22)


def test_split_k_plan_follows_the_sm_count():
    few = SB.split_k_plan(512, 2048, 11008, sms=16)
    many = SB.split_k_plan(512, 2048, 11008, sms=264)
    assert few[0] <= SB.split_k_plan(512, 2048, 11008)[0] <= many[0]


def test_tma_check_takes_aligned_tensors():
    check_tma("x", 0x7F0000000000, [256, 4096])
    check_tma("x", 16, [16])


@pytest.mark.parametrize("ptr,strides", [
    (0x7F0000000002, [256]),   # base off 16 bytes
    (0x7F0000000000, [40]),    # row of 20 bf16
    (0x7F0000000000, [256, 100]),
])
def test_tma_check_raises_where_tma_cannot_take(ptr, strides):
    with pytest.raises(ValueError, match="TMA"):
        check_tma("x", ptr, strides)


def test_cpu_tensors_take_the_plain_version_whatever_the_dtype():
    """The route applies to CUDA tensors only: on the CPU a 16-bit input
    with widths TMA could not take still runs the plain version."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 2, 16, generator=g).bfloat16()
    out = FA.flash_attention(q, q, q)
    assert torch.equal(out, FA.flash_attention_ref(q, q, q))
    p = {"w_up": torch.randn(20, 12, generator=g), "w_down": torch.randn(12, 20, generator=g)}
    x = torch.randn(3, 20, generator=g).bfloat16()
    nw = torch.ones(20)
    out = SB.stage_mlp_block(nw, p, x, activation="gelu")
    assert torch.equal(out, SB.stage_mlp_block_ref(nw, p, x, activation="gelu"))


@pytest.mark.parametrize("dtype,hd,expect", [
    (torch.bfloat16, 128, True), (torch.float16, 64, True), (torch.bfloat16, 48, True),
    (torch.bfloat16, 16, False), (torch.bfloat16, 96, False), (torch.bfloat16, 256, False),
    (torch.bfloat16, 272, False), (torch.float32, 128, False)])
def test_flash_backward_head_dims(dtype, hd, expect):
    """The backward is built for the tensor-core body at head dims 64 and
    128, and widths padded to them (48 -> 64); f32 has none."""
    assert FA.has_backward(dtype, hd) == expect


def test_flash_gradient_raises_off_the_card():
    """CPU tensors have no backward through the kernel's wrapper, whatever
    the dtype (the plain version is no kernel)."""
    q = torch.randn(1, 4, 2, 64).bfloat16().requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        FA.flash_attention(q, q, q)


def _qkv(b, s, h, kh, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, s, n, hd, generator=g).to(dtype) for n in (h, kh, kh))


@pytest.mark.parametrize("s,window", [(17, None), (300, 64), (2048, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_on_cpu_is_the_dense_route_up_to_2048(s, window, dtype):
    """On CPU tensors ``"auto"`` keeps its route bit for bit: dense at
    <= 2048 tokens (the kernel takes only CUDA f16/bf16 tensors)."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-3b").reduced()
    cfg = cfg if window is None else cfg.with_window(window)
    q, k, v = _qkv(1, s, 2, 1, 8, dtype, s)
    got = L._attention_core(q, k, v, cfg, "auto")
    assert torch.equal(got, L.dense_attention(q, k, v, q_offset=0, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_on_cpu_is_the_chunked_route_above_2048(dtype):
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-3b").reduced()
    q, k, v = _qkv(1, 2049, 2, 1, 8, dtype, 3)
    got = L._attention_core(q, k, v, cfg, "auto")
    assert torch.equal(got, L.chunked_attention(q, k, v, q_offset=0))


def test_auto_on_meta_and_cpu_never_takes_the_kernel():
    for dev, dt in (("meta", torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float16)):
        assert not L._kernel_route(torch.empty(1, 8, 2, 128, device=dev, dtype=dt))


@pytest.mark.parametrize("impl,kernel", [("auto", 0), ("dense", 0), ("chunked", 0), ("pallas", 1)])
def test_attention_counters_follow_the_route(impl, kernel):
    """A traced forward counts every core call in ``attention.calls`` and
    those routed to the flash kernel in ``attention.kernel_calls`` (on the
    CPU only ``"pallas"``, whose wrapper runs the plain version there);
    with tracing off nothing is counted."""
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen2.5-3b").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    tracing.reset()
    with torch.no_grad():
        M.forward(params, tokens, cfg, impl=impl)
    assert tracing.summary()["counters"] == {}
    with tracing.recording(), torch.no_grad():
        M.forward(params, tokens, cfg, impl=impl)
    counters = tracing.summary()["counters"]
    tracing.reset()
    n = cfg.num_attn_layers
    assert counters.get("attention.calls") == n
    assert counters.get("attention.kernel_calls", 0) == kernel * n


def _emulate_flash_backward(q, k, v, do, terms):
    """The backward kernels' arithmetic in f32 on the CPU: P and dS as
    ``terms`` bf16 terms in their products (``T(x) + T(x - T(x))`` or
    ``T(x)``), D from the output's two terms (or its bf16 rounding alone),
    every sum in f32, the gradients rounded to bf16 once."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    T = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    split = (lambda x: T(x) + T(x - T(x))) if terms == 2 else T
    kr, vr = (t.float().repeat_interleave(g, 2) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    d = (do.float() * split(o)).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.float(), vr) - d)
    dv = torch.einsum("bhqk,bqhd->bkhd", split(p), do.float()).reshape(b, s, kh, g, hd).sum(3)
    dk = torch.einsum("bhqk,bqhd->bkhd", split(ds), q.float()).reshape(b, s, kh, g, hd).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", split(ds), kr)
    return [x.to(torch.bfloat16) for x in (dq * scale, dk * scale, dv)]


@pytest.mark.parametrize("seed", range(4))
def test_flash_backward_emulation_two_terms_meet_the_dense_route(seed):
    """Why the backward takes dS and P as two bf16 terms: emulated, its
    dq, dk and dv are no further from the f32 autograd of the plain
    version (max|err| over max|ref|) than the dense route's bf16
    autograd, while one bf16 term (with D from the rounded output) moves
    dq or dk further than two do."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = ((3.0 if i < 2 else 1.0) * torch.randn(1, 256, n, 64, generator=g)
                   for i, n in enumerate((4, 2, 2, 4)))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention_ref(*leaves).backward(do.float())
    ref = [t.grad for t in leaves]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    L.dense_attention(*leaves, q_offset=0).backward(do)

    def rel(xs):
        return [float((x.float() - r).abs().max() / r.abs().max()) for x, r in zip(xs, ref)]

    two, one = (rel(_emulate_flash_backward(q, k, v, do, n)) for n in (2, 1))
    dense = rel([t.grad for t in leaves])
    assert all(a <= b for a, b in zip(two, dense)), (two, dense)
    assert max(one[:2]) > max(two[:2]), (one, two)


# ---------------------------------------------------------------------------
# the SSM and MoE kernels' tensor-core bodies
# ---------------------------------------------------------------------------

from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.kernels import ssd_scan as SK  # noqa: E402


@pytest.mark.parametrize("dtype,expect", [
    (torch.bfloat16, "wgmma"), (torch.float16, "wgmma"), (torch.float32, "fma")])
def test_grouped_moe_ffn_dtype_fixes_the_body(dtype, expect):
    assert MD.body(dtype) == expect


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.float8_e4m3fn])
def test_grouped_moe_ffn_no_body_for_other_dtypes(dtype):
    with pytest.raises(TypeError):
        MD.body(dtype)


def test_ssd_scan_has_one_tensor_core_body_for_f32():
    """The scan takes f32 only: one body, 3xTF32 ``mma.sync``."""
    assert SK.body(torch.float32) == "mma"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64,
                                   torch.int32])
def test_ssd_scan_no_body_for_other_dtypes(dtype):
    with pytest.raises(TypeError):
        SK.body(dtype)


def _routing(kind, t, k, e, seed):
    """(T, k) expert ids: uniform, skewed (most choices on two experts), or
    with experts that get no rows (only the even ones are chosen)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, e, (t, k), generator=g)
    if kind == "skewed":
        ids[: 3 * t // 4, 0] = 1
        ids[: t // 2, 1 % k] = e - 1
    elif kind == "empty experts":
        ids = (ids // 2) * 2
    return ids


@pytest.mark.parametrize("blk", [8, 32, 128])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty experts"])
def test_tile_schedule_covers_every_row_once_with_its_expert(blk, kind):
    """Against ``dropless_layout``: the tensor-core body's 128-row tiles
    cover every buffer row exactly once, each tile rows of one expert
    only; every routed row lands in a tile of its own expert; no more
    tiles than ``max_tiles``."""
    e, t, k = 16, 150, 4
    ids = _routing(kind, t, k, e, seed=blk)
    order, dest, p_rows, block_eid = L.dropless_layout(ids, e, blk)
    buf = torch.ones(p_rows, 8)
    sched = MD.tile_schedule(buf, block_eid, blk, e)
    assert sched.dtype == torch.int32 and sched.shape == (
        MD.max_tiles(p_rows, blk, e), 4)
    cover = torch.zeros(p_rows, dtype=torch.long)
    owner = torch.full((p_rows,), -1, dtype=torch.long)
    for ex, first, end, live in sched.tolist():
        if first >= end:
            continue
        stop = min(first + MD.TC_ROWS, end)
        cover[first:stop] += 1
        owner[first:stop] = ex
        assert live == 1
    assert bool((cover == 1).all())
    assert torch.equal(owner, block_eid.long().repeat_interleave(blk))
    assert torch.equal(owner[dest], ids.reshape(-1)[order])
    # the tiles come in expert order, each expert's from its range's start
    live = sched[sched[:, 1] < sched[:, 2]]
    assert bool((live[1:, 0] >= live[:-1, 0]).all())


def test_tile_schedule_marks_all_zero_tiles():
    """A tile is live iff one of its rows is not all zero (padding rows
    are zero; a NaN row counts as live)."""
    e, t, k, blk = 8, 40, 2, 8
    ids = _routing("uniform", t, k, e, seed=3)
    order, dest, p_rows, block_eid = L.dropless_layout(ids, e, blk)
    g = torch.Generator().manual_seed(4)
    buf = torch.zeros(p_rows, 16)
    buf[dest] = torch.randn(dest.numel(), 16, generator=g)
    buf[dest[:3]] = 0.0  # routed rows that are zero count as zero
    buf[dest[-1], 5] = float("nan")
    # one expert's whole range zero: its tile is not live
    _, first, end, _ = MD.tile_schedule(buf, block_eid, blk, e)[1].tolist()
    buf[first:end] = 0.0
    sched = MD.tile_schedule(buf, block_eid, blk, e)
    for ex, first, end, live in sched.tolist():
        if first >= end:
            continue
        rows = buf[first:min(first + MD.TC_ROWS, end)]
        assert live == int(bool((rows != 0).any()) or bool(rows.isnan().any()))
    assert int(sched[:, 3].sum()) < int((sched[:, 1] < sched[:, 2]).sum())


# ---------------------------------------------------------------------------
# why the scan's tensor-core body pays three TF32 products
# ---------------------------------------------------------------------------


def _tf32(v):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does (nearest, ties away
    from zero): add half of the 13 dropped mantissa bits, then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(terms):
    """``a @ b`` with TF32 operands and f32 sums: ``terms`` 1 takes one
    product of the rounded operands, 3 the split hi.hi + hi.lo + lo.hi."""
    def mm(a, b):
        ah, bh = _tf32(a), _tf32(b)
        out = ah @ bh
        if terms == 3:
            out = _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + out
        return out
    return mm


def _ssd_emulated(x, dt, a, b, c, chunk, mm):
    """The kernel's chunk recurrence (one batch row), each of its four
    products through ``mm``; decays, dt and cum in the inputs' dtype."""
    s, h, p = x.shape
    n = b.shape[-1]
    state = x.new_zeros((h, p, n))
    ys = []
    for s0 in range(0, s, chunk):
        xz, dz, bz, cz = (t[s0:s0 + chunk] for t in (x, dt, b, c))
        cum = torch.cumsum(dz * a, 0)  # (L, H)
        tril = torch.tril(torch.ones(len(xz), len(xz), dtype=torch.bool))
        cb = mm(cz, bz.T)  # (L, L), once per chunk, not per head
        y = []
        for hh in range(h):
            seg = cum[:, None, hh] - cum[None, :, hh]
            sc = torch.where(tril, cb * torch.exp(torch.where(tril, seg, 0)), 0)
            sc = sc * dz[None, :, hh]
            y_h = mm(sc, xz[:, hh]) + mm(cz * torch.exp(cum[:, hh])[:, None],
                                         state[hh].T)
            w = torch.exp(cum[-1, hh] - cum[:, hh]) * dz[:, hh]
            state[hh] = (torch.exp(cum[-1, hh]) * state[hh]
                         + mm(xz[:, hh].T, bz * w[:, None]))
            y.append(y_h)
        ys.append(torch.stack(y, 1))
    return torch.cat(ys, 0), state


def test_one_tf32_pass_misses_the_scan_gate_and_3xtf32_meets_it():
    """At a Mamba-like shape (H 4, P 32, N 64, chunk 64, Mamba's rates a =
    -linspace(1, 16)), every product of the scan taken with TF32 operands
    (10-bit mantissa) misses the card's gate of 1e-4 x max|ref| (the f32
    reference, here in f64), while the 3xTF32 split of each operand meets
    it with room: the tensor-core body pays three products for that."""
    rng = np.random.default_rng(0)
    s, h, p, n, chunk = 256, 4, 32, 64, 64
    x = torch.from_numpy(rng.standard_normal((s, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((s, h)))).astype(np.float32))
    a = torch.from_numpy((-np.linspace(1.0, 16.0, h)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    ref = _ssd_emulated(*(t.double() for t in (x, dt, a, b, c)), chunk,
                        lambda u, v: u @ v)
    # the emulation is the kernel's product structure; in f64 it gives the
    # plain version's answer (which computes in f32: its cum rounding
    # moves outputs by ~1e-5 of their largest)
    plain = SK.ssd_scan_ref(x[None], dt[None], a, b[None], c[None], chunk=chunk)
    for got, want in zip(ref, plain):
        want = want[0].double()
        assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())

    def rel(terms):
        out = _ssd_emulated(x, dt, a, b, c, chunk, _product(terms))
        return max(float((o.double() - r).abs().max() / r.abs().max())
                   for o, r in zip(out, ref))

    one, three = rel(1), rel(3)
    assert one > 1e-4
    assert three < 1e-5


# ---------------------------------------------------------------------------
# ca_attention's arithmetic on the tensor cores
# ---------------------------------------------------------------------------


def _split_rz(v):
    """The kernel's split_rz: hi = v with the low 13 mantissa bits cleared,
    lo = v - hi (exact in f32)."""
    hi = (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, v - hi


def _tc_product(a, b, terms):
    """a @ b as the kernel's mma.sync takes it: each operand split, the
    tensor cores reading only a TF32 operand's top 19 bits (so lo enters
    truncated), f32 accumulation; terms 3 sums lo.hi, hi.lo and hi.hi in
    separate accumulators, small terms first, terms 1 takes hi.hi alone."""
    ah, al = _split_rz(a)
    bh, bl = _split_rz(b)
    hh = ah @ bh
    if terms == 1:
        return hh
    return (_split_rz(al)[0] @ bh + ah @ _split_rz(bl)[0]) + hh


def _ca_emulated(obs, hist, mask, wq, wk, wv, terms):
    """The kernel's arithmetic: q = obs wq_s, u = q wk^T / sqrt(C), scores
    <hist_i, u>, the -FLT_MAX mask and an online softmax over groups of 4
    pairs, hbar / l (zero without a valid pair), s' = hbar wv."""
    b, i_len, dp = hist.shape
    c = wq.shape[1]
    q = _tc_product(obs, wq, terms)
    u = _tc_product(q, wk.T, terms) * (1.0 / math.sqrt(c))
    scores = (hist * u[:, None, :]).sum(-1)
    valid = mask > 0
    scores = torch.where(valid, scores, torch.full_like(scores, -torch.finfo(torch.float32).max))
    m = torch.full((b,), -math.inf)
    l = torch.zeros(b)
    hb = torch.zeros(b, dp)
    for i0 in range(0, i_len, 4):
        s = scores[:, i0:i0 + 4]
        m_new = torch.maximum(m, s.max(-1).values)
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new[:, None])
        l = l * corr + e.sum(-1)
        hb = hb * corr[:, None] + (e[:, :, None] * hist[:, i0:i0 + 4]).sum(1)
        m = m_new
    hb = torch.where(valid.any(-1, keepdim=True), hb / l[:, None], torch.zeros_like(hb))
    return torch.cat([obs, _tc_product(hb, wv, terms)], dim=-1)


@pytest.mark.parametrize("b,obs_dim,pair_dim,i_len,c", [
    (128, 28, 52, 4, 64),  # the SAC update's call
    (64, 76, 132, 16, 64),  # U 22, hist_len 16
])
def test_ca_attention_emulation_meets_the_gate_with_three_tf32_terms(b, obs_dim, pair_dim,
                                                                      i_len, c):
    """The kernel's arithmetic emulated on the CPU (3xTF32 products from
    split_rz operands, the online softmax over groups of 4 pairs) is within
    1e-5 of the JAX kernel (Pallas, interpret mode), the card's f32 gate
    CA_FWD_ATOL, with an all-masked row exactly zero; one TF32 product per
    multiply (hi.hi alone) misses that gate."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ops import ca_attention as jax_ca_attention

    rng = np.random.default_rng(b + i_len)
    f = np.float32
    params = {"wq_s": (rng.standard_normal((obs_dim, c)) / np.sqrt(obs_dim)).astype(f),
              "wq_h": (rng.standard_normal((pair_dim, c)) / np.sqrt(pair_dim)).astype(f),
              "wk": (rng.standard_normal((pair_dim, c)) / np.sqrt(pair_dim)).astype(f),
              "wv": (rng.standard_normal((pair_dim, c)) / np.sqrt(pair_dim)).astype(f)}
    obs = rng.standard_normal((b, obs_dim)).astype(f)
    hist = rng.standard_normal((b, i_len, pair_dim)).astype(f)
    mask = (rng.uniform(size=(b, i_len)) > 0.3).astype(f)
    mask[0] = 0.0
    ref = np.asarray(jax_ca_attention({k: jnp.asarray(v) for k, v in params.items()},
                                      obs, hist, mask, interpret=True))
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    args = (torch.from_numpy(obs), torch.from_numpy(hist), torch.from_numpy(mask),
            t["wq_s"], t["wk"], t["wv"])
    three = _ca_emulated(*args, terms=3).numpy()
    one = _ca_emulated(*args, terms=1).numpy()
    assert np.abs(three - ref).max() <= 1e-5
    np.testing.assert_array_equal(three[0, obs_dim:], 0.0)
    assert np.abs(one - ref).max() > 1e-5
