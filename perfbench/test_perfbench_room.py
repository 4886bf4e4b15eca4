"""What lets the benchmark take a long-context cell and a new family's
cell with new files alone: the plain reference's attention in blocks of
queries (equal to the one-call form, and that form itself unchanged at
or below ``QUERY_BLOCK``), a family's ``tiny`` widths, the cut of the
vocabulary to a slice, and the flash kernel's least time and its
calls counted from the plan."""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from perfbench import spec, yardstick  # noqa: E402
from perfbench.reference import decoder_lm as R  # noqa: E402
from perfbench.test_perfbench_spec import cut_allowed  # noqa: E402

CONF = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 96, "num_hidden_layers": 2,
        "vocab_size": 50, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "tie_word_embeddings": True, "qkv_bias": True}


def _params(seed=0):
    d, h, kh, hd, f, n = 64, 4, 2, 16, 96, 2
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.1):
        return torch.randn(*shape, generator=g) * std

    return {"embed": w(50, d, std=0.5), "final_norm": 1 + w(d),
            "slots/0/norm1": 1 + w(n, d), "slots/0/norm2": 1 + w(n, d),
            "slots/0/attn/wq": w(n, d, h * hd), "slots/0/attn/wk": w(n, d, kh * hd),
            "slots/0/attn/wv": w(n, d, kh * hd), "slots/0/attn/wo": w(n, h * hd, d),
            "slots/0/attn/bq": w(n, h * hd), "slots/0/attn/bk": w(n, kh * hd),
            "slots/0/attn/bv": w(n, kh * hd), "slots/0/mlp/w_gate": w(n, d, f),
            "slots/0/mlp/w_up": w(n, d, f), "slots/0/mlp/w_down": w(n, f, d)}


def _loss_and_grads(model, s, seed=0):
    p = {k: v.requires_grad_(True) for k, v in _params(seed).items()}
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, 50, (2, s), generator=g)
    labs = torch.randint(0, 50, (2, s), generator=g)
    loss = model.loss(p, toks, labs)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in p.items()}


class OneCall(R.DecoderLM):
    """The attention as one call over all queries, as the reference took it
    before it had blocks."""

    def _attention(self, p, r, x, cos, sin):
        b, s, _ = x.shape
        h, kh, hd = self.h, self.kh, self.hd
        q = self.mm(x, self._w(p, r, "attn/wq")) + self._w(p, r, "attn/bq")
        k = self.mm(x, self._w(p, r, "attn/wk")) + self._w(p, r, "attn/bk")
        v = self.mm(x, self._w(p, r, "attn/wv")) + self._w(p, r, "attn/bv")
        q = R._rope(q.view(b, s, h, hd), cos, sin)
        k = R._rope(k.view(b, s, kh, hd), cos, sin)
        v = v.view(b, s, kh, hd)
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        w = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * hd)
        return self.mm(o, self._w(p, r, "attn/wo"))


@pytest.mark.parametrize("s, block", [(40, 16), (48, 16), (33, 32)])
def test_blocked_attention_equals_the_one_call_form(s, block, monkeypatch):
    """Queries in blocks under checkpointing (the last block may be short):
    the loss and every gradient as the one call's, to f32 round-off."""
    want_loss, want = _loss_and_grads(OneCall(CONF), s)
    monkeypatch.setattr(R, "QUERY_BLOCK", block)
    calls = []
    real = R.checkpoint
    monkeypatch.setattr(R, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got_loss, got = _loss_and_grads(R.DecoderLM(CONF), s)
    assert len(calls) == 2 * -(-s // block)  # every block of both layers checkpointed
    assert float(abs(got_loss - want_loss)) <= 1e-6 * float(abs(want_loss))
    for k, g in want.items():
        assert float((got[k] - g).abs().max()) <= 2e-6 * float(g.abs().max()), k


@pytest.mark.parametrize("s", [1, 31, 64])
def test_at_or_below_the_block_the_attention_is_bit_equal_to_the_one_call(s, monkeypatch):
    monkeypatch.setattr(R, "QUERY_BLOCK", 64)
    want_loss, want = _loss_and_grads(OneCall(CONF), s)
    got_loss, got = _loss_and_grads(R.DecoderLM(CONF), s)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(got[k], g) for k, g in want.items())


def test_query_block_is_2048():
    """The existing cells' 2 048 and 1 024 queries take the one call."""
    assert R.QUERY_BLOCK == 2048


# the port's ModelConfig.reduced() widths, as Hugging Face keys, which the
# CPU tests cut both decoder LMs to
WIDTHS = {"hidden_size": 256, "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 64, "intermediate_size": 512, "num_hidden_layers": 2,
          "vocab_size": 512}
EXPERTS = {"num_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 128}


@pytest.mark.parametrize("name, want", [
    ("qwen2.5-3b-d8", WIDTHS), ("qwen3-moe-30b-a3b-d2", {**WIDTHS, **EXPERTS})])
def test_decoder_tiny_is_the_tests_widths(name, want):
    from perfbench.ports import decoder_lm

    conf = spec.load_json(spec.ROOT / "perfbench" / "configs" / f"{name}.json")
    assert decoder_lm.tiny(conf) == want


def _vocab_conf(here, published=151936, run=None, chips=8,
                deployment="the vocabulary split over 8 chips, as is the head"):
    cut = {"published": published, "here": here, "why": "."}
    if chips is not None:
        cut["chips"] = chips
    return {"vocab_size": here if run is None else run, "deployment": deployment,
            "cut": {"vocab_size": cut}}


@pytest.mark.parametrize("conf, ok", [
    (_vocab_conf(151936 // 8), True),  # an eighth
    (_vocab_conf(151936 // 4, chips=4,
                 deployment="embedding and head: the vocabulary split over 4 chips"), True),
    (_vocab_conf(100352 // 8), False),  # under an eighth of 151 936
    (_vocab_conf(12544, published=100352), True),  # Granite's eighth
    (_vocab_conf(12543, published=100352), False),
    (_vocab_conf(75968, run=151936), False),  # the file runs another size than its cut says
    (_vocab_conf(151936), False),  # no cut at all
    (_vocab_conf(151936 // 8, chips=None), False),  # no split named
    (_vocab_conf(151936 // 4, chips=4), False),  # the deployment states another split
    (_vocab_conf(151936 // 8, deployment="one card"), False),  # nor any split
    (_vocab_conf(151936 // 16, chips=16,
                 deployment="the vocabulary split over 16 chips"), False),  # past an eighth
    (_vocab_conf(151936 // 8, chips=4,
                 deployment="the vocabulary split over 4 chips"), False),  # 4 slices miss half
])
def test_vocab_cut_keeps_an_eighth(conf, ok):
    assert cut_allowed("vocab_size", conf) is ok


@pytest.mark.parametrize("key, ok", [
    ("num_hidden_layers", True), ("num_experts", True), ("hidden_size", False),
    ("intermediate_size", False), ("head_dim", False), ("kv_lora_rank", False),
    ("num_attention_heads", False), ("num_experts_per_tok", False)])
def test_other_cuts_are_never_widths(key, ok):
    assert cut_allowed(key, {}) is ok


def test_flash_forward_bound_is_the_smoke_logs():
    """(8, 1024, 16/2, 128) bf16 causal: 34.39 GFLOP of reachable pairs,
    0.034776 ms at 989 TFLOP/s."""
    ms, by, nbytes, flops = yardstick.flash_bound(8, 1024, 16, 2, 128, 2, False)
    assert flops == 4 * 128 * (1024 * 1025 // 2) * 8 * 16
    assert nbytes == 2 * 2 * (8 * 1024 * 16 * 128 + 8 * 1024 * 2 * 128) + 4 * 8 * 16 * 1024
    assert by == "operations" and ms == pytest.approx(0.034776, abs=1e-6)


def test_flash_backward_bound_at_the_dense_cells_shape():
    """(2, 2048, 16/2, 128): five products, 2.5 times the forward's, ~0.087 ms."""
    fwd = yardstick.flash_bound(2, 2048, 16, 2, 128, 2, False)
    ms, by, nbytes, flops = yardstick.flash_bound(2, 2048, 16, 2, 128, 2, True)
    assert flops == 2.5 * fwd[3] and by == "operations"
    assert ms == pytest.approx(0.087, abs=2e-4)
    assert nbytes == 2 * 4 * (2 * 2048 * 16 * 128 + 2 * 2048 * 2 * 128) + 4 * 2 * 16 * 2048


@pytest.mark.parametrize("s, window", [(1, None), (10, None), (10, 4), (10, 10), (10, 1)])
def test_causal_pairs_count_each_query_s_keys(s, window):
    want = sum(min(i + 1, window or s) for i in range(s))
    assert yardstick.causal_pairs(s, window) == want


@pytest.mark.parametrize("cell, fwd, bwd", [
    ("qwen2.5-3b-d8.train-2k", 120, 64),  # M 8 x (2 x 7 + 1), M x 8
    ("qwen3-moe-30b-a3b-d2.train-1k", 24, 16),  # 8 x (2 x 1 + 1), 8 x 2
    ("qwen2.5-3b-d8.train-8k", 60, 32),  # 4 x (2 x 7 + 1), 4 x 8
])
def test_attention_calls_from_the_plan(cell, fwd, bwd):
    c = spec.cell(cell)
    mcfg = spec.family("ports", c.config["family"]).model_config(c.config)
    plan = c.config["plan"]
    train = spec.runner(c.traffic["kind"])
    assert train.attention_calls(mcfg, tuple(plan["boundaries"]), c.traffic["microbatches"],
                                 plan["schedule"]) == (fwd, bwd)
    stage = train.expected_stage_launches(mcfg, tuple(plan["boundaries"]),
                                          c.traffic["microbatches"], plan["schedule"],
                                          torch.device("cuda"))
    assert stage == (0 if c.config.get("num_experts") else fwd)


class _Trace:
    def __init__(self, by_name, steps=2):
        self._by_name, self.steps = by_name, steps

    def by_name(self):
        return self._by_name


def _run(cell, trace, launches=None):
    """A run of ``cell`` with ``trace``, whose flash wrapper counted
    ``launches`` calls (default: the plan's, over the trace's steps)."""
    c = spec.cell(cell)
    mcfg = spec.family("ports", c.config["family"]).model_config(c.config)
    plan = c.config["plan"]
    if launches is None:
        per_step = sum(spec.runner(c.traffic["kind"]).attention_calls(
            mcfg, tuple(plan["boundaries"]), c.traffic["microbatches"], plan["schedule"]))
        launches = per_step * (trace.steps if trace is not None else 0)
    return SimpleNamespace(trace=trace, mcfg=mcfg, traffic=c.traffic, conf=c.config,
                           trace_launches={"flash_attention": launches})


def test_flash_roofline_reader_arithmetic():
    """Two dense steps' 2 x (120 forwards + 64 backwards) least times over
    the flash grids' device seconds; other grids do not count."""
    read = spec.reader("flash_attention_roofline")
    grids = {"void flash_fwd_tc<__nv_bfloat16, 128>(CUtensorMap)": 0.040,
             "flash_bwd_delta<bf16>": 0.002, "flash_bwd_dq_tc": 0.018,
             "flash_bwd_dkdv_tc": 0.036, "flash_bwd_sum_groups": 0.004,
             "flash_fwd": 9.0, "gemm_tc": 5.0}
    fwd = yardstick.flash_bound(2, 2048, 16, 2, 128, 2, False)[0]
    bwd = yardstick.flash_bound(2, 2048, 16, 2, 128, 2, True)[0]
    want = 100.0 * 2 * (120 * fwd + 64 * bwd) / 1e3 / 0.100
    got = read(_run("qwen2.5-3b-d8.train-2k", _Trace(grids)))
    assert got == pytest.approx(want) and 0 < got < 100


@pytest.mark.parametrize("trace", [None, _Trace({}), _Trace({"gemm_tc": 1.0}),
                                   _Trace({"flash_fwd_tc": 0.0})])
def test_flash_roofline_reader_gives_none_without_the_kernels_time(trace):
    assert spec.reader("flash_attention_roofline")(_run("qwen2.5-3b-d8.train-8k", trace)) is None


@pytest.mark.parametrize("launches", [0, 2 * 120, 2 * (120 + 64) - 1, 2 * (120 + 64) + 32])
def test_flash_roofline_reader_gives_none_when_the_calls_are_not_the_plans(launches):
    """Two dense steps are 2 x (120 + 64) wrapper calls; any other count in
    the traced window (say, a forward no longer recomputed, or calls routed
    away from the kernel) leaves the share unread."""
    grids = {"flash_fwd_tc": 0.040, "flash_bwd_dq_tc": 0.018, "flash_bwd_dkdv_tc": 0.036}
    read = spec.reader("flash_attention_roofline")
    assert read(_run("qwen2.5-3b-d8.train-2k", _Trace(grids), 2 * (120 + 64))) is not None
    assert read(_run("qwen2.5-3b-d8.train-2k", _Trace(grids), launches)) is None
