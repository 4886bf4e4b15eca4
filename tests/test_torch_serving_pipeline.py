"""The port's pipelined serving (per-stage KV rings, the serial token
ring in one process), on the CPU.

* ``PipelineRunner`` at f32 (compute and wire) serves bitwise the tokens
  of ``SingleDeviceRunner``, through the engine, and its prefill logits
  and caches are bitwise the single-device runner's.
* Against the JAX package's 2-stage ``pipeline_serve_fns`` on a 2-device
  stage mesh (run in a subprocess): f32 compute with a bf16 wire, the
  stage kernel's route (``stage_impl="pallas"``: the Pallas kernel in
  interpret mode there, the kernel's plain version ``stage_mlp_block_ref``
  here), and the dropless MoE prefill; prefill logits, one decode tick at
  per-row positions, and the KV rings.
* The stage kernel's wrapper is called once per layer per pass; the
  configs the ring does not serve are refused.

Tolerances: f32 leaf-scale ``rtol 2e-5`` (``atol = rtol * max|ref|``),
the JAX package's own f32 gate; the bf16 wire at ``WIRE_REL`` in
relative Frobenius norm per output, which a port run without the wire
cast fails (the two frameworks' f32 sums put a few stage outputs on the
other side of a bf16 rounding, one bf16 ulp each; measured 5.4e-5 to
7.3e-5 with the cast, 1.4e-3 to 1.9e-3 without); the stage kernel's
route at ``STAGE_REL`` of max|ref| (its plain version against the Pallas
kernel, f32, as ``tests/test_torch_models.py`` holds it, over 3 layers
and the LM head; measured 1.2e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import weights as W  # noqa: E402
from repro_torch.core import pipeline as TPIPE  # noqa: E402
from repro_torch.kernels import stage_block as SB  # noqa: E402
from repro_torch.serving import (PipelineRunner, ServeConfig,  # noqa: E402
                                 ServingService, SingleDeviceRunner,
                                 poisson_trace)

RTOL = 2e-5
WIRE_REL = 1e-3
STAGE_REL = 1e-5
B, P, EXTRA = 3, 8, 4
BOUNDS = (1, 3)


def _close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _rel(a, r):
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


def test_pipeline_runner_f32_equals_single_device():
    """The same trace through the engine on both runners: bitwise the
    same completions, greedy and sampled; one prefill bitwise the same
    logits and KV entries (the ring's caches, stage by stage)."""
    kw = dict(num_slots=3, arrival_slots=2, prompt_pad=8, max_new=8,
              decode_chunk=2, num_layers=3)
    for temperature in (0.0, 0.7):
        single = ServingService(ServeConfig(temperature=temperature, **kw),
                                device="cpu")
        piped = ServingService(ServeConfig(boundaries=BOUNDS,
                                           temperature=temperature, **kw),
                               params=single.params, device="cpu")
        assert isinstance(piped.runner, PipelineRunner)
        trace = poisson_trace(n_requests=6, rate_per_sec=50.0,
                              vocab_size=single.model_cfg.vocab_size,
                              plen_range=(2, 8), gen_range=(2, 8), seed=3)
        a, b = single.run(list(trace)), piped.run(list(trace))
        assert a["completions"].keys() == b["completions"].keys()
        for rid, toks in a["completions"].items():
            assert np.array_equal(toks, b["completions"][rid]), rid
    cfg = single.model_cfg
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P)))
    sr = SingleDeviceRunner(cfg, device="cpu")
    pr = PipelineRunner(cfg, BOUNDS, device="cpu")
    with torch.no_grad():
        ls, cs = sr.prefill(single.params, sr.init_caches(B, P + EXTRA), prompts)
    lp, cp = pr.prefill(single.params, pr.init_caches(B, P + EXTRA), prompts)
    assert lp.dtype == torch.float32 and torch.equal(ls, lp)
    for layer, (t, i) in enumerate(((0, 0), (1, 0), (1, 1))):
        assert torch.equal(cs[0]["k"][layer], cp["k"][t, i])
        assert torch.equal(cs[0]["v"][layer], cp["v"][t, i])
    assert not bool(cp["k"][0, 1].any())  # stage 0's padding row stays zero


JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from repro.configs import get_config
from repro.core.pipeline import (PipelineConfig, make_stage_mesh,
                                 pipeline_serve_fns, stage_kv_caches)
from repro.models.model import init_params

mesh = make_stage_mesh(2)
out = {{}}
cases = {{
    'wire16': ('qwen2.5-3b', 3, (1, 3),
               PipelineConfig(compute_dtype='float32', wire_dtype='bfloat16')),
    'pallas': ('qwen2.5-3b', 3, (1, 3),
               PipelineConfig(compute_dtype='float32', stage_impl='pallas')),
    'moe': ('qwen3-moe-30b-a3b', 2, (1, 2), PipelineConfig(compute_dtype='float32')),
}}
for name, (arch, layers, bounds, pipe) in cases.items():
    cfg = replace(get_config(arch).reduced(), num_layers=layers)
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab_size, ({b}, {p})), jnp.int32)
    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, ({b}, 1)), jnp.int32)
    pos = jnp.asarray([{p}, {p} - 3, {p} - 1], jnp.int32)
    prefill, decode = pipeline_serve_fns(cfg, mesh, bounds, pipe=pipe)
    caches = stage_kv_caches(cfg, bounds, {b}, {p} + {extra})
    lg, caches = jax.jit(prefill)(params, caches, prompts)
    dl, caches = jax.jit(decode)(params, tok, caches, pos)
    out[name + '/prefill'] = np.asarray(lg)
    out[name + '/decode'] = np.asarray(dl)
    out[name + '/k'] = np.asarray(caches['k'])
    out[name + '/v'] = np.asarray(caches['v'])
np.savez({path!r}, **out)
print('SERVE_JAX_OK')
"""


@pytest.fixture(scope="module")
def jax_serve(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "jax_serve.npz"
    out = subproc(JAX_SCRIPT.format(b=B, p=P, extra=EXTRA, path=str(path)),
                  n_devices=2)
    assert "SERVE_JAX_OK" in out
    return np.load(path)


def _port_case(arch, layers, bounds, pipe):
    jcfg = dataclasses.replace(JC.get_config(arch).reduced(), num_layers=layers)
    tcfg = dataclasses.replace(TC.get_config(arch).reduced(), num_layers=layers)
    params = W.model_params_from_jax(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, P)))
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, 1)))
    pos = torch.tensor([P, P - 3, P - 1])
    prefill, decode = TPIPE.pipeline_serve_fns(tcfg, bounds, pipe=pipe)
    caches = TPIPE.stage_kv_caches(tcfg, bounds, B, P + EXTRA, device="cpu")
    lg, caches = prefill(params, caches, prompts)
    dl, caches = decode(params, tok, caches, pos)
    return {"prefill": lg, "decode": dl, "k": caches["k"], "v": caches["v"]}


def test_bf16_wire_matches_jax_pipeline_serving(jax_serve):
    """f32 stages, bf16 hops: prefill and decode logits and the KV rings
    against JAX's, within WIRE_REL; a run without the wire cast is
    further from JAX's than the gate on the logits."""
    got = _port_case("qwen2.5-3b", 3, BOUNDS, TPIPE.PipelineConfig(
        compute_dtype="float32", wire_dtype="bfloat16"))
    no_wire = _port_case("qwen2.5-3b", 3, BOUNDS,
                         TPIPE.PipelineConfig(compute_dtype="float32"))
    for k in ("prefill", "decode", "k", "v"):
        ref = jax_serve["wire16/" + k]
        assert got[k].shape == ref.shape
        assert _rel(got[k].numpy(), ref) <= WIRE_REL, (k, _rel(got[k].numpy(), ref))
    for k in ("prefill", "decode"):
        assert _rel(no_wire[k].numpy(), jax_serve["wire16/" + k]) > WIRE_REL, k


def test_stage_kernel_route_matches_jax_pipeline_serving(jax_serve, monkeypatch):
    """``stage_impl="pallas"``: every dense MLP half-block goes through the
    stage kernel's wrapper (its plain version on the CPU), once per layer
    per pass, and the outputs match JAX's Pallas route."""
    calls = []
    orig = SB._forward

    def counting(*a, **k):
        calls.append(a[2].shape)
        return orig(*a, **k)

    monkeypatch.setattr(SB, "_forward", counting)
    got = _port_case("qwen2.5-3b", 3, BOUNDS, TPIPE.PipelineConfig(
        compute_dtype="float32", stage_impl="pallas"))
    assert calls == [(B, P, 256)] * 3 + [(B, 1, 256)] * 3
    for k in ("prefill", "decode", "k", "v"):
        _close(got[k].numpy(), jax_serve["pallas/" + k], rtol=STAGE_REL, what=k)


def test_moe_dropless_prefill_matches_jax_pipeline_serving(jax_serve):
    """MoE stages through the ring under dropless dispatch: prefill and
    decode logits and the rings against JAX's, f32."""
    got = _port_case("qwen3-moe-30b-a3b", 2, (1, 2),
                     TPIPE.PipelineConfig(compute_dtype="float32"))
    for k in ("prefill", "decode", "k", "v"):
        _close(got[k].numpy(), jax_serve["moe/" + k], what=k)


def test_pipeline_serving_refuses_what_it_does_not_run():
    """SSM and hybrid configs and capacity MoE are refused as the
    reference refuses them; MoE every other layer (period 2) is served
    (held to the reference in ``tests/test_torch_mixed_pipeline.py``)."""
    base = TC.get_config("qwen3-moe-30b-a3b").reduced()
    with pytest.raises(ValueError, match="SSM/hybrid"):
        TPIPE.pipeline_serve_fns(TC.get_config("mamba2-370m").reduced(), (1, 2))
    with pytest.raises(ValueError, match="SSM/hybrid"):
        TPIPE.stage_kv_caches(TC.get_config("jamba-v0.1-52b").reduced(), (1, 2),
                              2, 8, device="cpu")
    with pytest.raises(ValueError, match="dropless"):
        TPIPE.pipeline_serve_fns(dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, dispatch="capacity")), (1, 2))
    mixed = dataclasses.replace(base, num_layers=4, d_ff=96,
                                moe=dataclasses.replace(base.moe, moe_every=2))
    prefill, decode = TPIPE.pipeline_serve_fns(mixed, (2, 4))
    assert callable(prefill) and callable(decode)
    with pytest.raises(ValueError):
        TPIPE.pipeline_serve_fns(base, (1, 3))  # last boundary != layers
