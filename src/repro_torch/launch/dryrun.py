"""The production dry run's counts without compiling, the counterpart of
``repro.launch.dryrun``.

Usage (no device is touched; it runs wherever the port imports)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The reference lowers and compiles every (arch x input shape) on 512
placeholder devices and reads XLA's memory, cost and collective
analyses. The port compiles nothing. For each combination it builds the
parameter, AdamW moment and cache trees on the meta device (shapes and
dtypes, no storage), places them on the production mesh's shape record
(``launch.mesh.make_production_mesh``: ``(16, 16)`` or ``(2, 16, 16)``)
under the port's sharding rules, and sums the bytes of each leaf's block
on one rank: the counterpart of XLA's ``argument_size_in_bytes`` (every
rank's blocks have the same shape, as the rules shard only where an axis
divides). Then it runs rank 0's step on those meta blocks
(:func:`step_collectives`) under
``distribution.collectives.record_collectives``: on a shape record each
collective records what it would issue on ranks and returns an empty
meta tensor, so the record's ``collectives`` (``result_bytes``,
``wire_bytes``, ``counts``, the reference's keys) are exactly what a rank
of the production mesh issues in one step, and no rank is started. Per
variant:

* ``baseline``: f32 parameters, FSDP + tensor parallel (``mode="train"``);
  a train shape adds AdamW's two moments (and its step), a prefill or
  decode shape its caches; every shape its batch;
* ``serve_resident``: prefill and decode with ``mode="serve"`` (no FSDP
  axis on the weights);
* ``serve_resident_bf16``: the same with the weights stored in bf16;
* ``bf16cast``: a train shape's bf16 compute copy, counted beside the
  arguments as ``compute_copy_bytes``;
* ``moe_a2a``: the MoE blocks' all-to-all dispatch, which moves
  activations, not resident bytes: its resident counts are the
  baseline's, its collectives its own (all-to-alls where the baseline
  has none).

A prefill's cache is made inside the reference's step (an output, not an
argument); the port counts it with the arguments, as what a rank holds.

The roofline (``launch.hlo_analysis``, at an H100's rates) takes the
analytic FLOPs as its compute term (the reference's too), the resident
bytes read once as its memory term (a lower bound on what a step moves:
the reference scales XLA's bytes accessed, which has no counterpart
here), and the recorded wire bytes as its collective term; ``dominant``
is the largest of the three. The port has no scan, so its counts are per
step and the record has no ``collectives_scan_body``. They are the
collectives the port issues, not those XLA would issue: XLA combines and
reorders collectives, so the two are not held equal. A step that reads
a meta tensor's values on the host cannot run on the shape record; its
record keeps ``"collectives": null`` with the operation under
``collectives_error``, and its ``dominant`` term is picked from compute
and memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distribution import sharding as SH
from repro_torch.launch.hlo_analysis import roofline_from
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.frontends import FRONTEND_DIMS
from repro_torch.tree import tree_leaves

# sliding window used when a full-attention arch must run long_500k
LONG_CONTEXT_WINDOW = 8192

# The reference's measured choice: seq-sharding fresh KV (cache-layout
# alignment) wins for these archs (kh=8, hd=128) and regresses for
# kh=4 / hd=192 archs. Recorded beside each record's placement.
KV_SEQ_SHARD_GOOD = {"pixtral-12b", "minitron-4b"}

VARIANTS = ("baseline", "bf16cast", "serve_resident", "serve_resident_bf16",
            "moe_a2a")

META = torch.device("meta")


def arch_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k needs sub-quadratic attention: switch full-attention archs
    to their sliding-window variant."""
    if (
        shape.name == "long_500k"
        and "A" in cfg.pattern
        and cfg.attention_window is None
    ):
        return cfg.with_window(LONG_CONTEXT_WINDOW)
    return cfg


def _tokens_per_device(shape: ShapeConfig, n_dev: int) -> float:
    toks = shape.global_batch * (shape.seq_len if shape.kind == "train" else (
        shape.seq_len if shape.kind == "prefill" else 1))
    return toks / n_dev


def model_flops_per_device(cfg: ModelConfig, shape: ShapeConfig, n_dev: int) -> float:
    n_active = cfg.active_param_count()
    toks = _tokens_per_device(shape, n_dev)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * toks


def analytic_hlo_flops_per_device(
    cfg: ModelConfig, shape: ShapeConfig, n_dev: int, *, remat: bool = True
) -> float:
    """Closed-form per-device matmul FLOPs, the reference's model:
    parameter matmuls (2 x active per token, the input embedding a
    gather), attention score/value matmuls (causal-halved), the LM head,
    backward (2x) and remat recompute (1x) for training."""
    toks = _tokens_per_device(shape, n_dev)
    active = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    fwd = 2.0 * active * toks
    ctx = min(shape.seq_len, cfg.attention_window or shape.seq_len)
    n_attn = cfg.num_attn_layers
    if n_attn and cfg.num_heads:
        per_tok = 4.0 * ctx * cfg.num_heads * cfg.head_dim
        if shape.kind != "decode":
            per_tok *= 0.5  # causal half
        fwd += per_tok * n_attn * toks
    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat else 0.0)
        return fwd * mult
    return fwd


def _period(cfg: ModelConfig) -> int:
    from repro_torch.models.model import find_period, signature

    return find_period(signature(cfg))


def _kv_seq_shard(cfg: ModelConfig) -> bool:
    return cfg.name.split("-sw")[0] in KV_SEQ_SHARD_GOOD or any(
        cfg.name.startswith(a) for a in KV_SEQ_SHARD_GOOD)


def _block_bytes(tree, shardings) -> int:
    """Bytes of this rank's blocks of every leaf of ``tree``."""
    total = 0
    for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        total += sh.block(leaf).numel() * leaf.dtype.itemsize
    return total


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """``(shape, dtype)`` of every model input of this shape kind (the
    reference's ``data.pipeline.input_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_tokens if cfg.frontend != "none" else 0
    front = {"frontend": ((b, f, FRONTEND_DIMS[cfg.frontend]), torch.float32)} if f else {}
    if shape.kind == "train":
        return {"tokens": ((b, s - f), torch.int32),
                "labels": ((b, s - f), torch.int32), **front}
    if shape.kind == "prefill":
        return {"tokens": ((b, s - f), torch.int32), **front}
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32), "cache_index": ((), torch.int32)}
    raise KeyError(shape.kind)


def resident_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                   variant: str = "baseline") -> Dict[str, int]:
    """Per-rank bytes of what a step of ``cfg`` at ``shape`` holds on
    ``mesh`` under ``variant``: ``params_bytes``, ``moments_bytes`` (AdamW's
    step and two moments, train), ``cache_bytes`` (prefill and decode),
    ``batch_bytes``, their sum ``argument_bytes``, and
    ``compute_copy_bytes`` (``bf16cast``'s bf16 copy, train). Built on the
    meta device: nothing is allocated."""
    from repro_torch.models.model import compute_copy
    from repro_torch.optim import adamw

    train = shape.kind == "train"
    params, psh = _param_tree(cfg, shape, mesh, variant, torch.Generator(), META)
    out = dict(params_bytes=_block_bytes(params, psh), moments_bytes=0,
               cache_bytes=0, compute_copy_bytes=0)
    if train:
        state = adamw(1e-4, max_grad_norm=1.0).init(params)
        out["moments_bytes"] = _block_bytes(
            state, SH.param_shardings(state, cfg, mesh))
        if variant == "bf16cast":  # the leaves the copy casts
            copy = compute_copy(params, torch.bfloat16)
            out["compute_copy_bytes"] = sum(
                _block_bytes(c, sh) for c, p, sh in zip(
                    tree_leaves(copy), tree_leaves(params), tree_leaves(psh))
                if c is not p)
    else:
        out["cache_bytes"] = _block_bytes(*_cache_tree(cfg, shape, mesh, META))
    baxes = SH.batch_axes(mesh, shape.global_batch)
    batch = 0
    for dims, dt in input_specs(cfg, shape).values():
        batch += int(torch.Size(_input_block(mesh, baxes, dims)).numel()) * dt.itemsize
    out["batch_bytes"] = batch
    out["argument_bytes"] = (out["params_bytes"] + out["moments_bytes"]
                             + out["cache_bytes"] + batch)
    return out


def _param_tree(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, variant: str,
                gen: torch.Generator, device):
    """A step's whole parameter tree on ``device`` and its shardings under
    ``variant``: f32, or bf16 weights under ``serve_resident_bf16``; the
    serve placement (no FSDP axis) under ``serve_resident*``, off a train
    shape."""
    from repro_torch.models.model import init_params

    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    train = shape.kind == "train"
    serve = variant.startswith("serve_resident") and not train
    dtype = torch.bfloat16 if variant == "serve_resident_bf16" and not train \
        else torch.float32
    params = init_params(gen, cfg, dtype=dtype, device=device)
    return params, SH.param_shardings(params, cfg, mesh,
                                      mode="serve" if serve else "train")


def _cache_tree(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, device):
    """A prefill or decode step's whole caches on ``device`` and their
    shardings."""
    from repro_torch.models.model import init_caches

    caches = init_caches(cfg, shape.global_batch, shape.seq_len, device=device)
    return caches, SH.cache_shardings(caches, cfg, mesh, shape.global_batch)


def _input_block(mesh: Mesh, baxes, dims) -> tuple:
    """A rank's block of a model input of shape ``dims``: its rows of the
    batch."""
    spec = (SH._entry(baxes),) + (None,) * (len(dims) - 1) if dims else ()
    return SH.Sharding(mesh, spec).block_shape(dims)


def _batch(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, baxes,
           gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """This rank's rows of every model input of ``shape``: uninitialised
    on a shape record, else drawn whole from ``gen`` (tokens and labels
    in the vocabulary, features normal) and cut to the rank's rows."""
    rows = SH.shard_rows(mesh, baxes, shape.global_batch)
    out = {}
    for name, (dims, dt) in input_specs(cfg, shape).items():
        if name == "cache_index":
            continue
        if mesh.device.type == "meta":
            out[name] = torch.empty(_input_block(mesh, baxes, dims), dtype=dt,
                                    device=mesh.device)
        elif name == "frontend":
            out[name] = torch.randn(dims, generator=gen).to(dt)[rows]
        else:
            out[name] = torch.randint(0, cfg.vocab_size, dims, generator=gen,
                                      dtype=dt)[rows]
    return {k: v.to(mesh.device) for k, v in out.items()}


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     variant: str = "baseline", seed: int = 0):
    """The collectives this rank issues in one step of ``cfg`` at
    ``shape`` on ``mesh`` under ``variant``, as the reference's
    ``build_lowered`` builds the step: a train shape runs
    ``make_train_step`` with AdamW (clip 1.0) on this rank's blocks of
    the parameters and moments (``bf16cast``: with the bf16 compute copy);
    a prefill or a decode shape runs the sharded prefill or decode step
    on this rank's blocks of the parameters (``serve_resident*``: the
    serve placement, bf16 weights for ``serve_resident_bf16``) and the
    caches; ``moe_a2a`` switches the MoE blocks to the all-to-all
    dispatch. The batch is this rank's rows.

    On a shape record (``make_production_mesh``, or any mesh on the meta
    device with no groups) everything is a meta tensor: nothing is
    computed or allocated, and each collective records what it would
    issue. On a mesh of ranks (every rank calls it) the step runs on
    weights and tokens drawn from ``seed``. Returns the
    :class:`~repro_torch.distribution.records.CollectiveStats`."""
    from repro_torch.distribution.collectives import record_collectives
    from repro_torch.distribution.context import activation_sharding
    from repro_torch.models.model import (
        make_decode_step, make_prefill_step, make_train_step)
    from repro_torch.optim import adamw

    dev = mesh.device
    made = dev if dev.type == "meta" else torch.device("cpu")  # drawn on the host
    train = shape.kind == "train"
    gen = torch.Generator().manual_seed(seed)
    params, psh = _param_tree(cfg, shape, mesh, variant, gen, made)
    params = _to(SH.blocks(params, psh), dev)
    baxes = SH.batch_axes(mesh, shape.global_batch)
    batch = _batch(cfg, shape, mesh, baxes, gen)
    ctx = activation_sharding(mesh, baxes, kv_seq_shard=_kv_seq_shard(cfg),
                              moe_a2a=variant == "moe_a2a")
    if train:
        opt = adamw(1e-4, max_grad_norm=1.0)
        opt_state = opt.init(params)
        step = make_train_step(
            cfg, opt, param_shardings_tree=psh,
            compute_copy_dtype=torch.bfloat16 if variant == "bf16cast" else None)
        with ctx, record_collectives() as stats:
            step(params, opt_state, batch)
        return stats
    caches, csh = _cache_tree(cfg, shape, mesh, made)
    caches = _to(SH.blocks(caches, csh), dev)
    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, param_shardings_tree=psh,
                                    cache_shardings_tree=csh)
        with ctx, record_collectives() as stats:
            prefill(params, batch["tokens"], caches,
                    frontend_feats=batch.get("frontend"))
        return stats
    decode = make_decode_step(cfg, param_shardings_tree=psh,
                              cache_shardings_tree=csh)
    index = torch.full((), shape.seq_len // 2, dtype=torch.int32, device=dev)
    with ctx, record_collectives() as stats:
        decode(params, batch["tokens"], caches, index)
    return stats


def _to(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.to(dev), tree)


def run_one(arch: str, shape_name: str, *, multi_pod=False,
            out_dir="experiments/torch_dryrun", verbose=True,
            variant: str = "baseline"):
    """One combination's record, written as JSON under ``out_dir`` and
    returned."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = get_shape(shape_name)
    cfg = arch_for_shape(get_config(arch), shape)
    t0 = time.time()
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": cfg.name,
        "perf_variant": variant,
        "n_devices": mesh.size,
    }
    try:
        mem = resident_bytes(cfg, shape, mesh, variant)
        mf = model_flops_per_device(cfg, shape, mesh.size)
        af = analytic_hlo_flops_per_device(cfg, shape, mesh.size)
        cost = {"flops": af, "bytes accessed": float(mem["argument_bytes"])}
        t1 = time.time()
        coll = coll_rec = None
        try:
            coll = step_collectives(cfg, shape, mesh, variant)
            coll_rec = dict(result_bytes=coll.result_bytes,
                            wire_bytes=coll.wire_bytes, counts=coll.counts)
        except (NotImplementedError, RuntimeError) as e:
            # a host read of a meta tensor's values: no count
            rec["collectives_error"] = f"{type(e).__name__}: {str(e)[:500]}"
        roof = roofline_from(cost, coll, mf)
        rec.update(
            ok=True,
            build_s=round(t1 - t0, 2),
            step_s=round(time.time() - t1, 2),
            kv_seq_shard=_kv_seq_shard(cfg),
            period=_period(cfg),
            memory=mem,
            collectives=coll_rec,
            roofline=roof.as_dict(),
        )
        if verbose:
            print(
                f"[ok] {arch} x {shape_name} x {rec['mesh']}: "
                f"args {mem['argument_bytes'] / 2**30:.2f} GiB/dev "
                f"(params {mem['params_bytes'] / 2**30:.2f}, moments "
                f"{mem['moments_bytes'] / 2**30:.2f}, caches "
                f"{mem['cache_bytes'] / 2**30:.2f}), dominant={roof.dominant} "
                f"(c={roof.compute_s:.3e}s m={roof.memory_s:.3e}s "
                f"k={roof.collective_s:.3e}s) "
                f"useful={roof.useful_ratio:.2f}",
                flush=True,
            )
    except Exception as e:  # noqa: BLE001 - record failures, don't die
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {rec['mesh']}: {e}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    fn = f"{arch}__{shape_name}__{rec['mesh'].replace('x', '_')}{suffix}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s.name) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        combos = [(args.arch, args.shape)]

    n_ok = 0
    for a, s in combos:
        mesh_tag = "2_16_16" if args.multi_pod else "16_16"
        suffix = "" if args.variant == "baseline" else f"__{args.variant}"
        fn = os.path.join(args.out, f"{a}__{s}__{mesh_tag}{suffix}.json")
        if args.skip_existing and os.path.exists(fn):
            with open(fn) as f:
                if json.load(f).get("ok"):
                    n_ok += 1
                    print(f"[skip] {a} x {s} x {mesh_tag} (cached ok)", flush=True)
                    continue
        rec = run_one(a, s, multi_pod=args.multi_pod, out_dir=args.out,
                      variant=args.variant)
        n_ok += bool(rec.get("ok"))
    print(f"dry-run: {n_ok}/{len(combos)} ok", flush=True)
    return 0 if n_ok == len(combos) else 1


if __name__ == "__main__":
    sys.exit(main())
