"""Host-side logic of the tensor-core bodies of the split executor's
kernels, on the CPU: which body a dtype takes, the split-K plan of the
stage kernel's down product, and the check of what TMA can take.

These are pure functions of shapes, dtypes and addresses; the kernels
themselves run only on the card (``tests/test_torch_gpu.py``)."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import stage_block as SB  # noqa: E402
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
