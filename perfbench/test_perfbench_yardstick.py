"""The frozen arithmetic: the stage kernel's least time and a training
token's model FLOPs, against counts made by hand."""
import json
from pathlib import Path

import pytest

from perfbench import yardstick

ROOT = Path(__file__).resolve().parent.parent


def _conf(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_stage_bound_matches_the_smoke_log():
    """512 rows, D 2048, F 11008, swiglu, bf16 x, f32 weights: the bytes
    and FLOPs ``chip_smoke.py`` logged, and its bound of 0.082010 ms."""
    ms, by, nbytes, flops = yardstick.stage_bound(512, 2048, 11008, True, 2, 4)
    assert nbytes == 274_735_104 and flops == 69_256_347_648
    assert by == "bytes" and ms == pytest.approx(0.082010, abs=1e-6)


def test_stage_bound_at_the_dense_cells_rows():
    """A microbatch of 2 x 2048 rows is bound by its operations."""
    ms, by, _, flops = yardstick.stage_bound(4096, 2048, 11008, True, 2, 4)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)


# per token, by hand: the layers' attention and MLP products and norms,
# the final norm and the head; attention 4 hd per key, causal-halved
DENSE_ATTN = 2048 * 2048 + 2 * 2048 * 256 + 2048 * 2048 + (2048 + 512)
DENSE_LAYER = 2 * 2048 + DENSE_ATTN + 3 * 2048 * 11008
MOE_ATTN = 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
MOE_LAYER = 2 * 2048 + MOE_ATTN + 8 * 3 * 2048 * 768 + 2048 * 128


@pytest.mark.parametrize("name, seq, params, heads", [
    ("qwen2.5-3b-d8", 2048, 8 * DENSE_LAYER + 2048 + 151936 * 2048, 16),
    ("qwen3-moe-30b-a3b-d2", 1024, 2 * MOE_LAYER + 2048 + 151936 * 2048, 32),
])
def test_flops_per_token_by_hand(name, seq, params, heads):
    conf = _conf(name)
    assert yardstick.active_matmul_params(conf) == params
    layers = conf["num_hidden_layers"]
    fwd = 2 * params + 4 * seq * heads * 128 * 0.5 * layers
    assert yardstick.train_flops_per_token(conf, seq) == pytest.approx(3 * fwd, rel=1e-12)


def test_flops_per_token_magnitudes():
    """5.77 and 2.60 GFLOP a trained token."""
    dense = yardstick.train_flops_per_token(_conf("qwen2.5-3b-d8"), 2048)
    moe = yardstick.train_flops_per_token(_conf("qwen3-moe-30b-a3b-d2"), 1024)
    assert dense == pytest.approx(5.77e9, rel=2e-3)
    assert moe == pytest.approx(2.60e9, rel=2e-3)


@pytest.mark.parametrize("name", ["qwen2.5-3b-d8", "qwen3-moe-30b-a3b-d2"])
def test_parameter_count_matches_the_port(name):
    """The yardstick reads the configuration file alone; the port's count
    of the same model agrees (embedding and every block)."""
    pytest.importorskip("torch")
    from perfbench.ports.decoder_lm import model_config

    conf = _conf(name)
    cfg = model_config(conf)
    total = cfg.param_count()
    emb = 151936 * 2048 * (1 if conf["tie_word_embeddings"] else 2)
    # the yardstick counts the head once, the embedding's gather not at all,
    # and only the routed experts of a token
    active = yardstick.active_matmul_params(conf)
    if conf.get("num_experts"):
        routed_off = (128 - 8) * 3 * 2048 * 768 * conf["num_hidden_layers"]
        assert active == total - emb + 151936 * 2048 - routed_off
    else:
        assert active == total - emb + 151936 * 2048
