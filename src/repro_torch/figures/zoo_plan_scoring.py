"""Architecture-aware split-plan scoring across the model zoo on the port
(the counterpart of ``benchmarks/zoo_plan_scoring.py``, with two parts of
``benchmarks/pipeline.py``: ``_time_plan_scoring`` and
``_transport_model_ratio``).

For four zoo configs - pure attention (qwen2.5-3b), attention + MoE
(qwen3-moe-30b-a3b), pure SSM (mamba2-370m), hybrid SSM/attention + MoE
(jamba-v0.1-52b) - at seq 2048, the full ``(L-1 choose S-1)`` cut
enumeration is scored in one batched scorer call under a nonzero
``state_cycles_per_bit`` (attention KV, SSM scan state and MoE expert
banks priced into the Eq. 8-9 compute terms). Per config it records
plans/s and, on the card, the CUDA kernels of one scorer call (the port's
counterpart of the reference's one compiled trace: a count that does not
depend on the number of plans), and the best plan with state pricing off
and on. Beside them: the batched scorer against the ``plan_cost`` loop,
and the 1F1B transport model's overlap/sync ratio on a heterogeneous
link ladder. Run on the card::

    PYTHONPATH=src python -m repro_torch.figures.zoo_plan_scoring
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.channel import NetworkConfig
from repro_torch.core.profiles import KIND_NAMES, profile_table, transformer_profile
from repro_torch.core.splitting import (
    SplitPlan, make_plan_scorer, plan_cost, stack_boundaries,
)
from repro_torch.core.transport import plan_transport_model, simulate_1f1b
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.figures.common import device_name, emit_csv_row, save_json

ZOO = [
    "qwen2.5-3b",         # pure attention
    "qwen3-moe-30b-a3b",  # attention + MoE expert banks
    "mamba2-370m",        # pure SSM
    "jamba-v0.1-52b",     # hybrid SSM/attention + MoE
]

# resident-state maintenance cycles per bit: visible against the Eq. 8
# FLOP term at paper scale without drowning it
STATE_CYCLES_PER_BIT = 0.01
SEQ = 2048

# idle host time around a profiled window, so that no kernel of it runs
# near an edge of the profiler's capture window
TRACE_PAD_S = 0.05


def plan_inputs(s: int, net: NetworkConfig, seed: int = 0):
    """The reference's scoring setup: positions from
    ``default_rng(seed)``, stages on devices ``0..S-2`` then the server,
    trainer power 0.5 W on every hop, one 0.2 W decoy (device S)."""
    u = net.num_devices
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, net.area_m, (u + 1, 2))
    devices = np.concatenate([np.arange(s - 1), [u]]).astype(np.int32)
    p_tx = np.full((s - 1,), 0.5)
    decoy = np.zeros((s - 1, u + 1))
    decoy[:, s] = 0.2
    return pos, devices, p_tx, decoy


def device_ops_per_call(fn, calls: int = 5):
    """CUDA kernels, and memory copies and sets, per call of ``fn``: a
    ``torch.profiler`` trace of ``calls`` calls padded with idle host time
    on each side. Returns ``(kernels, copies)``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    cuda = torch.autograd.DeviceType.CUDA
    kern = copies = 0
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kern += e.count
    return kern / calls, copies / calls


def time_call_s(fn, dev: torch.device, reps: int = 20) -> float:
    """Median seconds per call after warm-up: CUDA events on the card
    (host launch cost included), the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def score_zoo(device: DeviceLike = None, seed: int = 0, stages: int = 4,
              names=ZOO, seq: int = SEQ):
    dev = resolve_device(device)
    net0 = NetworkConfig(max_split=stages)
    net1 = replace(net0, state_cycles_per_bit=STATE_CYCLES_PER_BIT)
    pos, devices, p_tx, decoy = plan_inputs(stages, net0, seed)
    configs = []
    for name in names:
        cfg = get_config(name)
        prof = transformer_profile(cfg, batch=1, seq=seq)
        tab = profile_table(prof)
        bounds = torch.as_tensor(stack_boundaries(cfg.num_layers, stages),
                                 device=dev)  # full enumeration
        scorer = make_plan_scorer(prof, dev)

        def call(net):
            return scorer(bounds, devices, pos, p_tx, decoy, net)

        score_s = time_call_s(lambda: call(net1), dev)
        t_on, _ = call(net1)
        t_off, _ = call(net0)
        best_on = bounds[int(torch.argmin(t_on))].tolist()
        best_off = bounds[int(torch.argmin(t_off))].tolist()
        kernels = copies = None
        if dev.type == "cuda":
            kernels, copies = device_ops_per_call(lambda: call(net1))
        kinds = np.asarray(tab.kind)
        configs.append({
            "config": name, "layers": cfg.num_layers, "stages": stages,
            "plans": int(bounds.shape[0]), "score_s": score_s,
            "plans_per_sec": bounds.shape[0] / score_s,
            "kernels_per_call": kernels, "copies_per_call": copies,
            "best_boundaries_homogeneous": best_off,
            "best_boundaries_state_priced": best_on,
            "cut_moved": best_off != best_on,
            "state_bits_by_kind": {
                KIND_NAMES[kv]: float(np.asarray(tab.state_bits)[kinds == kv].sum())
                for kv in sorted(set(int(k) for k in kinds))},
        })
    return {"state_cycles_per_bit": STATE_CYCLES_PER_BIT, "stages": stages,
            "seq": seq, "configs": configs}


def time_plan_scoring(device: DeviceLike = None, seed: int = 0,
                      smoke: bool = False):
    """The batched scorer against the ``plan_cost`` loop on an L-layer
    prefix enumeration of the Qwen2.5-3B profile (reference
    ``benchmarks/pipeline.py`` ``_time_plan_scoring``)."""
    dev = resolve_device(device)
    l_layers, s = (10, 3) if smoke else (24, 4)
    net = NetworkConfig()
    prof = transformer_profile(get_config("qwen2.5-3b"), batch=1, seq=SEQ)
    bounds = stack_boundaries(l_layers, s)
    pos, devices, p_tx, decoy = plan_inputs(s, net, seed)

    def loop():
        return np.asarray([
            plan_cost(prof, SplitPlan(tuple(int(x) for x in b), tuple(devices)),
                      pos, p_tx, decoy, net) for b in bounds])

    ref = loop()  # warm
    t0 = time.perf_counter()
    ref = loop()
    loop_s = time.perf_counter() - t0

    scorer = make_plan_scorer(prof, dev)
    bounds_dev = torch.as_tensor(bounds, device=dev)
    vec_s = time_call_s(lambda: scorer(bounds_dev, devices, pos, p_tx, decoy,
                                       net), dev)
    t, e = scorer(bounds_dev, devices, pos, p_tx, decoy, net)
    got = torch.stack([t, e], 1).cpu().double().numpy()
    return {
        "layers": l_layers, "stages": s, "plans": int(bounds.shape[0]),
        "plan_cost_loop_s": loop_s, "score_plans_s": vec_s,
        "speedup": loop_s / vec_s,
        "max_rel_err_vs_loop": float(np.abs(got - ref).max() / np.abs(ref).max()),
    }


def transport_model_ratio(stages: int, bounds, m: int, layers: int,
                          seed: int = 0) -> dict:
    """Overlap/sync ratio of the 1F1B transport model on a heterogeneous
    link ladder (every other hop at half bandwidth, 2 ms latency) over a
    reduced Qwen2.5-3B profile (reference ``benchmarks/pipeline.py``
    ``_transport_model_ratio``). Host numpy."""
    hop_bw = tuple(1e6 if k % 2 == 0 else 5e5 for k in range(stages - 1))
    net = NetworkConfig(num_devices=max(8, stages), max_split=stages,
                        hop_bandwidth=hop_bw, hop_latency=2e-3)
    cfg = replace(get_config("qwen2.5-3b").reduced(), num_layers=layers)
    prof = transformer_profile(cfg, batch=1, seq=512)
    u = net.num_devices
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, net.area_m, (u + 1, 2))
    devices = tuple(int(d) for d in list(range(stages - 1)) + [u])
    p_tx = np.full((stages - 1,), 0.5)
    decoy = np.zeros((stages - 1, u + 1))
    model = plan_transport_model(prof, SplitPlan(tuple(bounds), devices),
                                 pos, p_tx, decoy, net)
    sync = simulate_1f1b(model, m, transport="sync")
    ovl = simulate_1f1b(model, m, transport="overlap")
    return {
        "stages": stages, "boundaries": list(bounds), "m": m,
        "hop_bandwidth_hz": list(hop_bw), "hop_latency_s": net.hop_latency,
        "sync_total_s": sync["total_s"], "overlap_total_s": ovl["total_s"],
        "model_speedup": sync["total_s"] / ovl["total_s"],
        "bubble_fraction": ovl["bubble_fraction"],
    }


# the pipeline benchmark's splits: (stages, microbatches, boundaries)
TRANSPORT_CASES = [(4, 8, (2, 4, 6, 8)), (4, 8, (5, 6, 7, 8)),
                   (8, 8, (1, 2, 3, 4, 5, 6, 7, 8)),
                   (8, 8, (2, 3, 4, 5, 6, 7, 8, 9))]
TRANSPORT_SMOKE = [(2, 4, (2, 4)), (2, 4, (3, 4))]


def main(device: DeviceLike = None, seed: int = 0, smoke: bool = False):
    dev = resolve_device(device)
    zoo = score_zoo(dev, seed, stages=3 if smoke else 4)
    for row in zoo["configs"]:
        emit_csv_row(
            f"zoo_plan_scoring/{row['config']}", 1e6 * row["score_s"],
            f"plans={row['plans']} plans_per_sec={row['plans_per_sec']:.0f} "
            f"kernels_per_call={row['kernels_per_call']} "
            f"cut_moved={row['cut_moved']}")
    scoring = time_plan_scoring(dev, seed, smoke)
    emit_csv_row("zoo_plan_scoring/plan_cost_loop_vs_scorer",
                 1e6 * scoring["score_plans_s"],
                 f"plans={scoring['plans']} speedup={scoring['speedup']:.1f}x "
                 f"max_rel_err={scoring['max_rel_err_vs_loop']:.2e}")
    transport = [transport_model_ratio(s, b, m, layers=b[-1], seed=seed)
                 for s, m, b in (TRANSPORT_SMOKE if smoke else TRANSPORT_CASES)]
    for row in transport:
        emit_csv_row(f"zoo_plan_scoring/transport_s{row['stages']}", 0.0,
                     f"boundaries={row['boundaries']} "
                     f"overlap_speedup={row['model_speedup']:.3f}")
    payload = {"device": device_name(dev), "zoo_plan_scoring": zoo,
               "plan_scoring": scoring, "transport_model": transport}
    save_json("zoo_plan_scoring", payload)
    return payload


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="S = 3 and a 10-layer scorer-vs-loop comparison")
    a = ap.parse_args()
    main(a.device, a.seed, a.smoke)
