"""Runner of a training cell: the program's pipelined split-training step.

One run, in order:

1. set-up: the configuration as the program's ``ModelConfig``, the
   weights and the token stream made on the device from ``--seed``
   (``perfbench/weights.py``), the launcher's step
   (``repro_torch.launch.train_mhsl_rl.make_pipeline_train_step`` with
   the plan, the pipeline and the AdamW of the configuration file) and
   AdamW's state; then the check's first steps through that same step
   and feed, which also warm up every shape of the window. From them the
   program's readings: each step's loss and clip norm, each leaf's norm
   of the first clipped gradient (AdamW's first moment after one step
   over ``1 - b1``) and of the change of the parameters over the steps
   (against the seed's weights, made again leaf by leaf);
2. the window: steps back to back on fresh tokens, the loss read after
   each, until ``seconds`` have passed; ``train_tokens_per_s`` is all
   tokens of its whole steps over its wall time;
3. with ``trace``: a profiled window of ``trace_steps`` more steps, then
   the cell's per-layer readers (``perfbench/metrics``);
4. the program's state is freed and the plain reference
   (``perfbench/reference/<family>.py``) takes the same first steps from
   the same weights and batches in f32; ``perfbench/compare.py`` judges.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from perfbench import compare, spec, weights
from perfbench.devtrace import WINDOW, Trace


def forward_calls(layers: Sequence[bool], boundaries, microbatches: int,
                  schedule: str) -> int:
    """Forward calls of the layers that ``layers`` marks in one in-process
    1F1B step: a layer of a stage runs its forward in the forward slot
    and again in the backward slot's recomputation, except on the last
    stage, whose forward runs only inside the loss's backward slot."""
    if schedule != "1f1b":
        raise ValueError(f"no call count for schedule {schedule!r}")
    total, lo = 0, 0
    for k, hi in enumerate(boundaries):
        per = 1 if k == len(boundaries) - 1 else 2
        total += per * sum(1 for r in range(lo, hi) if layers[r])
        lo = hi
    return microbatches * total


def expected_stage_launches(mcfg, boundaries, microbatches: int, schedule: str,
                            device: torch.device) -> int:
    """``stage_mlp_block`` launches of one in-process 1F1B step: the
    forward calls of the dense MLP layers. 0 off the card, where the
    kernel's plain version runs."""
    from repro_torch.models import model as M

    if device.type != "cuda":
        return 0
    dense = [has_mlp and not is_moe for _, is_moe, has_mlp in M.signature(mcfg)]
    return forward_calls(dense, boundaries, microbatches, schedule)


def attention_calls(mcfg, boundaries, microbatches: int, schedule: str) -> Tuple[int, int]:
    """Calls of the attention core in one in-process 1F1B step, forward
    and backward: the attention layers' forward calls, and one backward
    of each attention layer a microbatch. The count is of the work,
    whatever implements it."""
    from repro_torch.models import model as M

    attn = [kind == "A" for kind, _, _ in M.signature(mcfg)]
    return forward_calls(attn, boundaries, microbatches, schedule), microbatches * sum(attn)


class Run:
    """What the per-layer readers read: the cell, the program's objects
    after the window, the window's counts and the trace."""

    def __init__(self, **kw):
        self.trace: Optional[Trace] = None
        self.trace_launches: Dict[str, int] = {}
        self.__dict__.update(kw)

    def cuda_ms(self, fn: Callable[[], Any], reps: int = 10,
                warmup: int = 2) -> Optional[float]:
        """Median over ``reps`` calls of ``fn``'s device time (CUDA
        events), after ``warmup`` calls; None off the card."""
        if self.device.type != "cuda":
            return None
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            weights.sub_seed(self.seed, tag))


def _flat(tree) -> Dict[str, torch.Tensor]:
    from repro_torch.tree import tree_leaves_with_path

    return {"/".join(p): x for p, x in tree_leaves_with_path(tree)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """The program's training objects of one run, built from the seed:
    the configuration as its ``ModelConfig``, the weights in its tree,
    the launcher's step with the plan, pipeline and AdamW of the
    configuration file, AdamW's state and the token stream."""

    def __init__(self, cell: spec.Cell, seed: int, dev: torch.device):
        from repro_torch.core.pipeline import PipelineConfig
        from repro_torch.launch import train_mhsl_rl as RUN
        from repro_torch.models import model as M
        from repro_torch.optim.optimizers import adamw
        from repro_torch.tree import tree_leaves_with_path, tree_unflatten

        conf, t = cell.config, cell.traffic
        self.cell, self.seed, self.dev, self.conf = cell, seed, dev, conf
        self.mcfg = spec.family("ports", conf["family"]).model_config(conf)
        plan, o = conf["plan"], conf["optimizer"]
        self.boundaries = tuple(plan["boundaries"])
        self.rows, self.seq, self.micro = t["rows"], t["seq"], t["microbatches"]
        like = M.init_params(torch.Generator(), self.mcfg, device="meta")  # shapes only
        self.layout = layout_of(like)
        flat0 = weights.make_params(seed, self.layout, conf["init"], dev)
        self.params = tree_unflatten(like, [flat0[k] for k, _ in self.layout])
        del flat0
        self.pipe = PipelineConfig(schedule=plan["schedule"], stage_impl=plan["stage_impl"],
                                   compute_dtype=conf["dtypes"]["compute"])
        self.opt = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"], max_grad_norm=o["max_grad_norm"])
        self.step_fn = RUN.make_pipeline_train_step(self.mcfg, self.boundaries, self.micro,
                                                    self.pipe, self.opt)
        self.opt_state = self.opt.init(self.params)
        self.feed = weights.token_batches(seed, self.mcfg.vocab_size, self.rows, self.seq, dev)

    def step(self) -> float:
        """One step on the next batch; its loss (read: waits for the step)."""
        toks, labs = next(self.feed)
        return self.step_on(toks, labs)[0]

    def step_on(self, toks, labs):
        self.params, self.opt_state, loss, norm = self.step_fn(
            self.params, self.opt_state, toks, labs)
        return float(loss), norm

    def sample(self) -> Dict[str, torch.Tensor]:
        """Each leaf's positions that the gradient's distance reads."""
        return {k: weights.sample_index(self.seed, i, math.prod(shape))
                for i, (k, shape) in enumerate(self.layout)}

    def check_steps(self, n: int):
        """The first ``n`` steps, through the window's call and feed: the
        program's readings and the batches they took."""
        readings = spec.family("reference", self.conf["family"]).Readings()
        batches = []
        b1 = self.conf["optimizer"]["b1"]
        for i in range(n):
            toks, labs = next(self.feed)
            batches.append((toks, labs))
            loss, norm = self.step_on(toks, labs)
            readings.loss.append(loss)
            readings.norm.append(float(norm))
            if i == 0:  # the clipped gradient AdamW took: m_1 = (1 - b1) g
                mu = _flat(self.opt_state.mu)
                readings.grad = {k: float(torch.linalg.vector_norm(m)) / (1 - b1)
                                 for k, m in mu.items()}
                readings.grad_sample = {
                    k: (mu[k].reshape(-1)[idx.to(self.dev)] / (1 - b1)).float().cpu()
                    for k, idx in self.sample().items()}
                del mu
        with torch.no_grad():
            now = _flat(self.params)
            for i, (k, shape) in enumerate(self.layout):
                p0 = weights.make_leaf(self.seed, i, k, shape, self.conf["init"], self.dev)
                readings.change[k] = float(torch.linalg.vector_norm(now[k] - p0))
                del p0
        return readings, batches


def layout_of(like):
    from repro_torch.tree import tree_leaves_with_path

    return [("/".join(p), tuple(x.shape)) for p, x in tree_leaves_with_path(like)]


def reference(cell: spec.Cell, seed: int, layout, batches, microbatches: int,
              precision: str, dev: torch.device, optimizer=None):
    """The plain reference's readings of ``len(batches)`` steps from the
    seed's weights, its products in ``precision`` (a key of the
    reference's ``MATMULS``), under the configuration's optimizer or
    ``optimizer``."""
    conf = cell.config
    ref = spec.family("reference", conf["family"])
    ref.strict_f32()
    p0 = weights.make_params(seed, layout, conf["init"], dev)
    sample = {k: weights.sample_index(seed, i, math.prod(shape))
              for i, (k, shape) in enumerate(layout)}
    return ref.train_steps(conf, p0, batches, microbatches, optimizer or conf["optimizer"],
                           ref.MATMULS[precision], sample,
                           int(cell.check.get("reference_rows", 0)))


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log=print) -> Dict[str, Any]:
    from repro_torch.launch import train_mhsl_rl as RUN

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # -- set-up: the program, and the check's first steps, which warm up
    # every shape of the window
    t = time.perf_counter()
    prog = Program(cell, seed, dev)
    _sync(dev)
    log(f"set-up: process to program {t - t_start:.3f} s, program built in "
        f"{time.perf_counter() - t:.3f} s")
    ours, batches = prog.check_steps(int(cell.check["steps"]))
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.3f} s; check steps' losses {ours.loss}, norms {ours.norm}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window
    launches0 = RUN.kernel_launches()
    n_steps, n_bad = 0, 0
    t0 = time.perf_counter()
    while True:
        n_bad += not math.isfinite(prog.step())
        n_steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    launches = {k: (v - launches0[k]) / n_steps for k, v in RUN.kernel_launches().items()}
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peak = max(peak, peak_window)
    tokens_per_s = n_steps * prog.rows * prog.seq / window_s
    log(f"window: {n_steps} steps in {window_s:.3f} s, {tokens_per_s:.1f} tokens/s, "
        f"kernel launches a step {launches}")

    metrics: Dict[str, Dict[str, Any]] = {}
    extra: Dict[str, Any] = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        r = Run(cell=cell, conf=cell.config, traffic=cell.traffic, mcfg=prog.mcfg,
                device=dev, seed=seed, tokens_per_s=tokens_per_s, window_steps=n_steps,
                window_s=window_s, peak_window_bytes=peak_window, chips=cell.chips)
        n_trace = int(cell.traffic["trace_steps"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        before = RUN.kernel_launches()
        _sync(dev)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                for _ in range(n_trace):
                    n_bad += not math.isfinite(prog.step())
                _sync(dev)
        peak = max(peak, torch.cuda.max_memory_allocated(dev) if cuda else 0)
        r.trace_launches = {k: v - before[k] for k, v in RUN.kernel_launches().items()}
        t_red = time.perf_counter()
        r.trace = Trace(prof, n_trace)
        del prof
        log(f"trace: {len(r.trace.device)} device events in {r.trace.window_s:.3f} s "
            f"read in {time.perf_counter() - t_red:.3f} s")
        extra["busy_s"], extra["window_s"] = r.trace.busy_s, r.trace.window_s
        extra["breakdown"] = r.trace.breakdown()
        r.params, r.opt_state, r.opt, r.pipe = prog.params, prog.opt_state, prog.opt, prog.pipe
        for m in cell.per_layer:
            t_m = time.perf_counter()
            value = spec.reader(m["name"])(r)
            log(f"metric {m['name']}: {value!r} ({time.perf_counter() - t_m:.3f} s)")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del r
    else:
        for m in cell.end_to_end:
            value = {"train_tokens_per_s": tokens_per_s, "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the reference, on the program's first batches, after its state is freed
    layout, mcfg = prog.layout, prog.mcfg
    del prog
    free(dev)
    t_ref = time.perf_counter()
    theirs = reference(cell, seed, layout, batches, cell.traffic["microbatches"],
                       cell.config["dtypes"]["reference"], dev)
    log(f"reference: {len(batches)} steps in {time.perf_counter() - t_ref:.3f} s; "
        f"losses {ours.loss} against {theirs.loss}")
    numbers = compare.gaps(ours, theirs)
    plan = cell.config["plan"]
    expected = expected_stage_launches(mcfg, tuple(plan["boundaries"]),
                                       cell.traffic["microbatches"], plan["schedule"], dev)
    numbers["stage_launch_gap"] = abs(launches["stage_mlp_block"] - expected)
    limits = {k: float(v["limit"]) for k, v in cell.check["limits"].items()}
    correct, checks = compare.judge(numbers, limits)
    attempted = n_steps + (int(cell.traffic["trace_steps"]) if trace else 0)
    return {"correct": bool(correct and n_bad == 0), "attempted": attempted,
            "failed": n_bad, "metrics": metrics,
            "memory_peak_bytes": int(peak), "checks": checks, **extra}
