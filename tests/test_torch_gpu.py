"""Tests of the port that need a CUDA card (marker ``gpu``).

They skip without a card. On the card, where JAX is not installed, run
them with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``;
this file imports only torch, numpy and the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ca_attention as CA  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("b,i", [(128, 4), (130, 8)])
def test_ca_attention_kernel_matches_plain_on_card(b, i):
    """The hand-written kernel vs its plain version at the SAC shapes
    (obs_dim 28, pair_dim 52, C 64), f32 ``atol 1e-5``, an all-masked row
    exactly zero, and one launch counted per call."""
    _card()
    rng = np.random.default_rng(b + i)
    obs = torch.from_numpy(rng.standard_normal((b, 28), dtype=np.float32))
    hist = torch.from_numpy(rng.standard_normal((b, i, 52), dtype=np.float32))
    mask = torch.from_numpy((rng.uniform(size=(b, i)) > 0.4).astype(np.float32))
    mask[0] = 0.0
    params = {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.15)
              for k, shape in (("wq_s", (28, 64)), ("wq_h", (52, 64)),
                               ("wk", (52, 64)), ("wv", (52, 64)))}
    cp = {k: v.cuda() for k, v in params.items()}
    before = CA.launches
    out = CA.ca_attention(cp, obs.cuda(), hist.cuda(), mask.cuda())
    torch.cuda.synchronize()
    assert CA.launches == before + 1
    ref = CA.ca_attention_ref(obs, hist, mask, params["wq_s"], params["wk"],
                              params["wv"])
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-5)
    assert float(out[0, 28:].abs().max()) == 0.0


@pytest.mark.gpu
def test_ca_attention_kernel_rejects_what_it_does_not_take():
    """On a CUDA tensor the wrapper launches or raises: mixed dtypes,
    non-contiguous inputs, and I or pair_dim above the kernel's maximum
    raise."""
    _card()
    p = {k: torch.randn(s, device="cuda") for k, s in
         (("wq_s", (6, 8)), ("wq_h", (10, 8)), ("wk", (10, 8)), ("wv", (10, 8)))}
    obs = torch.randn(4, 6, device="cuda")
    hist = torch.randn(4, 3, 10, device="cuda")
    mask = torch.ones(4, 3, device="cuda")
    with pytest.raises(TypeError):
        CA.ca_attention(p, obs, hist, mask.half())
    with pytest.raises(ValueError):
        CA.ca_attention(p, obs, hist.transpose(0, 1).contiguous().transpose(0, 1), mask)
    with pytest.raises(ValueError):
        CA.ca_attention(p, obs, torch.randn(4, 9, 10, device="cuda"),
                        torch.ones(4, 9, device="cuda"))
    wide = {k: torch.randn((6 if k == "wq_s" else 129, 8), device="cuda")
            for k in p}
    with pytest.raises(ValueError):
        CA.ca_attention(wide, obs, torch.randn(4, 3, 129, device="cuda"), mask)
