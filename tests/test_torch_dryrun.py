"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

One JAX subprocess with 512 forced host devices (importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import, so it cannot run in
this process) computes the reference's values:

* for every arch of ``ARCH_IDS`` x every shape of ``INPUT_SHAPES``, its
  ``arch_for_shape`` (the config's name and window),
  ``model_flops_per_device`` and ``analytic_hlo_flops_per_device`` at 256
  and 512 devices;
* for Qwen2.5-3B, Qwen3-MoE-30B-A3B and Jamba-v0.1-52B x ``train_4k`` /
  ``decode_32k`` x both production meshes, the per-device bytes of the
  parameters, AdamW's state and the caches: ``NamedSharding(mesh,
  spec).shard_shape(leaf.shape)`` summed over ``jax.eval_shape`` trees
  under the reference's ``param_shardings`` / ``cache_shardings``.

The port's values come from the meta device and the production mesh's
shape record in this process. FLOPs are held at ``rel=1e-12`` (the same
arithmetic), bytes exactly.

The collective term has no JAX counterpart to hold it to (XLA combines
and reorders collectives; the port's counts are what it issues, and
``tests/test_torch_tensor_parallel.py`` holds the meta step's record to
what four gloo ranks issue). Here every arch's decode step, and train,
prefill and variant steps of a few archs, run on the production shape
records: each record carries positive counts, result and wire bytes, a
collective term above zero and the largest of three terms as its
``dominant``; ``moe_a2a`` records two all-to-alls per MoE layer where
the baseline records none; and the combinations whose step cannot run on
meta tensors are exactly ``COLLECTIVES_ERRORS``.
"""
import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import signature  # noqa: E402

FLOPS_REL = 1e-12
BYTE_ARCHS = ("qwen2.5-3b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
BYTE_SHAPES = ("train_4k", "decode_32k")
MAIN_LIMIT_S = 10.0
# (arch, shape, variant) whose step reads a meta tensor's values on the
# host, so that its record has no collective count: none (every
# combination of ``--all`` on both meshes and under every variant runs)
COLLECTIVES_ERRORS = frozenset()
# (arch, shape, variant, multi_pod) run through ``run_one`` below
COUNT_CASES = ([(a, "decode_32k", "baseline", False) for a in ARCH_IDS]
               + [("stablelm-1.6b", "train_4k", "baseline", False),
                  ("stablelm-1.6b", "train_4k", "bf16cast", True),
                  ("qwen2.5-3b", "prefill_32k", "serve_resident_bf16", True),
                  ("mamba2-370m", "long_500k", "serve_resident", False)])

REFERENCE = """
import json
import numpy as np
import jax
from repro.launch import dryrun as D
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro.distribution.sharding import cache_shardings, param_shardings
from repro.launch.mesh import make_production_mesh
from repro.models import init_caches, init_params
from repro.optim import adamw

out = {"flops": {}, "bytes": {}}
for a in ARCH_IDS:
    for s in INPUT_SHAPES:
        cfg = D.arch_for_shape(get_config(a), s)
        out["flops"][a + "|" + s.name] = dict(
            name=cfg.name, window=cfg.attention_window,
            model={n: D.model_flops_per_device(cfg, s, n) for n in (256, 512)},
            analytic={n: D.analytic_hlo_flops_per_device(cfg, s, n) for n in (256, 512)})


def nbytes(tree, shardings):
    return int(sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings))))


for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for a in %(archs)r:
        for sname in %(shapes)r:
            s = get_shape(sname)
            cfg = D.arch_for_shape(get_config(a), s)
            p = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
            rec = dict(params=nbytes(p, param_shardings(p, cfg, mesh)))
            if s.kind == "train":
                o = jax.eval_shape(adamw(1e-4, max_grad_norm=1.0).init, p)
                rec["moments"] = nbytes(o, param_shardings(o, cfg, mesh))
            else:
                c = jax.eval_shape(lambda: init_caches(cfg, s.global_batch, s.seq_len))
                rec["caches"] = nbytes(c, cache_shardings(c, cfg, mesh, s.global_batch))
            out["bytes"]["%%s|%%s|%%s" %% (a, sname, multi)] = rec
print("DRYRUN_REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(subproc):
    out = subproc(REFERENCE % dict(archs=BYTE_ARCHS, shapes=BYTE_SHAPES),
                  n_devices=512)
    line = next(ln for ln in out.splitlines() if ln.startswith("DRYRUN_REF "))
    return json.loads(line[len("DRYRUN_REF "):])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_match_the_reference(ref, arch):
    for shape in INPUT_SHAPES:
        want = ref["flops"][f"{arch}|{shape.name}"]
        cfg = DR.arch_for_shape(get_config(arch), shape)
        assert (cfg.name, cfg.attention_window) == (want["name"], want["window"])
        for n in (256, 512):
            assert DR.model_flops_per_device(cfg, shape, n) == pytest.approx(
                want["model"][str(n)], rel=FLOPS_REL)
            assert DR.analytic_hlo_flops_per_device(cfg, shape, n) == pytest.approx(
                want["analytic"][str(n)], rel=FLOPS_REL)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", BYTE_ARCHS)
def test_per_device_bytes_match_the_reference(ref, arch, multi_pod):
    """Parameters, AdamW's state (train) and caches (decode), one rank's
    blocks on the production mesh, equal the reference's shard shapes."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.size == (512 if multi_pod else 256)
    for sname in BYTE_SHAPES:
        shape = get_shape(sname)
        cfg = DR.arch_for_shape(get_config(arch), shape)
        got = DR.resident_bytes(cfg, shape, mesh)
        want = ref["bytes"][f"{arch}|{sname}|{multi_pod}"]
        assert got["params_bytes"] == want["params"], sname
        if shape.kind == "train":
            assert got["moments_bytes"] == want["moments"], sname
            assert got["cache_bytes"] == 0
        else:
            assert got["cache_bytes"] == want["caches"], sname
            assert got["moments_bytes"] == 0
        assert got["argument_bytes"] == (got["params_bytes"] + got["moments_bytes"]
                                         + got["cache_bytes"] + got["batch_bytes"])


def test_variants_change_what_they_say():
    """``serve_resident`` drops FSDP from the weights (more bytes a rank),
    ``serve_resident_bf16`` halves them again, ``bf16cast`` adds a bf16
    copy of the train weights."""
    mesh = make_production_mesh()
    cfg = get_config("qwen2.5-3b")
    dec, train = get_shape("decode_32k"), get_shape("train_4k")
    base = DR.resident_bytes(cfg, dec, mesh)
    res = DR.resident_bytes(cfg, dec, mesh, "serve_resident")
    res16 = DR.resident_bytes(cfg, dec, mesh, "serve_resident_bf16")
    assert res["params_bytes"] > base["params_bytes"]
    assert res16["params_bytes"] * 2 == res["params_bytes"]
    assert res["cache_bytes"] == base["cache_bytes"]
    cast = DR.resident_bytes(cfg, train, mesh, "bf16cast")
    plain = DR.resident_bytes(cfg, train, mesh)
    assert plain["compute_copy_bytes"] == 0
    assert 0 < cast["compute_copy_bytes"] <= plain["params_bytes"] // 2
    # the all-to-all moves activations, which the dry run does not count
    assert DR.resident_bytes(cfg, train, mesh, "moe_a2a") == plain
    with pytest.raises(ValueError):
        DR.resident_bytes(cfg, train, mesh, "unknown")


def test_run_one_writes_the_reference_keys(tmp_path):
    from repro.launch.hlo_analysis import Roofline

    rec = DR.run_one("qwen3-moe-30b-a3b", "decode_32k", multi_pod=True,
                     out_dir=os.fspath(tmp_path), verbose=False)
    assert rec["ok"], rec.get("error")
    for key in ("arch", "shape", "mesh", "variant", "perf_variant", "n_devices",
                "ok", "memory", "roofline", "collectives"):
        assert key in rec, key
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert set(rec["collectives"]) == {"result_bytes", "wire_bytes", "counts"}
    ref_keys = set(Roofline(0, 0, 0, 0, 0, 0, "compute").as_dict())
    assert set(rec["roofline"]) == ref_keys
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["flops_per_device"] == pytest.approx(
        DR.analytic_hlo_flops_per_device(get_config("qwen3-moe-30b-a3b"),
                                         get_shape("decode_32k"), 512), rel=FLOPS_REL)
    assert rec["roofline"]["hbm_bytes_per_device"] == rec["memory"]["argument_bytes"]
    with open(tmp_path / "qwen3-moe-30b-a3b__decode_32k__2_16_16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    long = DR.run_one("qwen2.5-3b", "long_500k", out_dir=os.fspath(tmp_path),
                      verbose=False, variant="serve_resident")
    assert long["variant"] == "qwen2.5-3b-sw8192" and long["perf_variant"] == "serve_resident"
    assert (tmp_path / "qwen2.5-3b__long_500k__16_16__serve_resident.json").is_file()
    # the all-to-all moves activations: the resident bytes are the
    # baseline's, the collectives are not
    a2a = DR.run_one("qwen3-moe-30b-a3b", "decode_32k", multi_pod=True,
                     out_dir=os.fspath(tmp_path), verbose=False, variant="moe_a2a")
    assert a2a["memory"] == rec["memory"]
    assert "all-to-all" not in rec["collectives"]["counts"]
    cfg = get_config("qwen3-moe-30b-a3b")
    moe_layers = sum(is_moe for _, is_moe, _ in signature(cfg))
    assert moe_layers == cfg.num_layers
    # one exchange out and one back per MoE layer of the decode step
    assert a2a["collectives"]["counts"]["all-to-all"] == 2 * moe_layers


@pytest.mark.parametrize("arch,shape,variant,multi_pod", COUNT_CASES)
def test_run_one_counts_the_steps_collectives(tmp_path, arch, shape, variant,
                                              multi_pod):
    """Rank 0's step on the production shape record: positive counts,
    result and wire bytes per kind; the roofline's collective term is
    the wire bytes at the link's rate, and ``dominant`` the largest of
    the three terms."""
    from repro_torch.launch.hlo_analysis import NVLINK_BW

    rec = DR.run_one(arch, shape, multi_pod=multi_pod, out_dir=os.fspath(tmp_path),
                     verbose=False, variant=variant)
    assert rec["ok"], rec.get("error")
    failed = (arch, shape, variant) in COLLECTIVES_ERRORS
    assert ("collectives_error" in rec) == failed, rec.get("collectives_error")
    if failed:
        assert rec["collectives"] is None
        return
    coll, roof = rec["collectives"], rec["roofline"]
    assert set(coll["counts"]) == set(coll["result_bytes"]) == set(coll["wire_bytes"])
    for kind, n in coll["counts"].items():
        assert n > 0 and coll["result_bytes"][kind] > 0, kind
        assert coll["wire_bytes"][kind] > 0, kind
    wire = sum(coll["wire_bytes"].values())
    assert roof["wire_bytes_per_device"] == pytest.approx(wire, rel=FLOPS_REL)
    assert roof["collective_s"] == pytest.approx(wire / NVLINK_BW, rel=FLOPS_REL)
    assert roof["collective_s"] > 0
    terms = {"compute": roof["compute_s"], "memory": roof["memory_s"],
             "collective": roof["collective_s"]}
    assert roof["dominant"] == max(terms, key=terms.get)


def test_main_exits_zero_quickly(tmp_path):
    """``main`` on one combination returns 0 within ``MAIN_LIMIT_S`` of
    this process's CPU time (its own work: the wall clock of a loaded
    host also counts the time it waits for a core), and the module's
    command line exits 0 in a process of its own with no device
    visible."""
    t0 = time.process_time()
    rc = DR.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--out",
                  os.fspath(tmp_path)])
    secs = time.process_time() - t0
    assert rc == 0 and secs < MAIN_LIMIT_S, (rc, secs)
    assert DR.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--out",
                    os.fspath(tmp_path), "--skip-existing"]) == 0
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2.5-3b",
         "--shape", "decode_32k", "--out", os.fspath(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "src"),
            CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dry-run: 1/1 ok" in out.stdout
