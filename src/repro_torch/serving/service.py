"""Host-side serving: request queue, slot scheduler, service loop.

Port of ``repro.serving.service``. The host does only bookkeeping; every
token-level decision lives in the engine step on the device. Per tick the
host (a) moves requests whose arrival time has passed into the FIFO
queue and drops queued requests past their deadline, (b) packs at most
``min(A, pending, free slots)`` of them into the fixed-shape arrival
buffers, (c) calls the engine step, and (d) reads the small report back
and drains completions (pulling ``gen_buf`` rows only for slots that
finished). Idle ticks (nothing pending, nothing active) skip the step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.config import ServeConfig


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (plen,) int32
    gen_target: int
    arrival_time: float = 0.0     # seconds from trace start
    # absolute trace-time completion deadline; inf = none. A request
    # still QUEUED past its deadline is dropped (reported under
    # ``expired``) instead of admitted.
    deadline: float = float("inf")

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    arrival_time: float
    admit_time: float
    done_time: float

    @property
    def latency(self) -> float:
        return self.done_time - self.arrival_time


class RequestQueue:
    """FIFO of arrived-but-unadmitted requests."""

    def __init__(self, trace: List[Request]):
        self._future = deque(sorted(trace, key=lambda r: r.arrival_time))
        self._ready: deque = deque()

    def advance(self, now: float) -> None:
        while self._future and self._future[0].arrival_time <= now:
            self._ready.append(self._future.popleft())

    def pop(self, k: int) -> List[Request]:
        k = max(min(int(k), len(self._ready)), 0)  # k <= 0 pops nothing
        return [self._ready.popleft() for _ in range(k)]

    def peek(self, k: int) -> List[Request]:
        """First ``k`` ready requests WITHOUT removing them (the scheduler
        validates before it pops, so a rejection never loses requests)."""
        k = max(min(int(k), len(self._ready)), 0)
        return [self._ready[i] for i in range(k)]

    def drop_expired(self, now: float) -> List[Request]:
        """Remove (and return) ready requests past their deadline."""
        expired = [r for r in self._ready if r.deadline <= now]
        if expired:
            dead = {id(r) for r in expired}
            self._ready = deque(r for r in self._ready if id(r) not in dead)
        return expired

    @property
    def pending(self) -> int:
        return len(self._ready)

    @property
    def exhausted(self) -> bool:
        return not self._future and not self._ready

    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival_time if self._future else None


class SlotScheduler:
    """Packs ready requests into the engine's fixed-shape arrival buffers."""

    def __init__(self, arrival_slots: int, prompt_pad: int):
        self.a = arrival_slots
        self.p = prompt_pad

    def pack(self, queue: RequestQueue, free_slots: int):
        """-> (admitted requests, prompt (A, P), plen, gen, rid, n_arr).

        Rejection is TOTAL: candidates are validated by peek before any is
        popped, so an oversized prompt raises with the queue intact."""
        reqs = queue.peek(min(self.a, free_slots))
        for r in reqs:
            if r.plen > self.p:
                raise ValueError(
                    f"request {r.rid} prompt length {r.plen} exceeds "
                    f"prompt_pad {self.p}")
        reqs = queue.pop(len(reqs))
        ap = np.zeros((self.a, self.p), np.int32)
        al = np.ones((self.a,), np.int32)
        ag = np.ones((self.a,), np.int32)
        ar = np.full((self.a,), -1, np.int32)
        for i, r in enumerate(reqs):
            ap[i, :r.plen] = r.prompt
            al[i] = r.plen
            ag[i] = r.gen_target
            ar[i] = r.rid
        return reqs, ap, al, ag, ar, len(reqs)


def make_runner(cfg: ServeConfig, model_cfg, device: DeviceLike = None):
    """The runner a :class:`ServeConfig` asks for: one device, or the
    split plan ``cfg.boundaries`` stage by stage."""
    from repro_torch.serving.runners import PipelineRunner, SingleDeviceRunner

    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.boundaries is None:
        return SingleDeviceRunner(model_cfg, compute_dtype=dtype, device=device)
    from repro_torch.core.pipeline import PipelineConfig

    pipe = PipelineConfig(compute_dtype=cfg.compute_dtype,
                          wire_dtype=cfg.wire_dtype)
    return PipelineRunner(model_cfg, cfg.boundaries, pipe=pipe, device=device)


def init_model_params(cfg: ServeConfig, model_cfg, device: DeviceLike = None):
    """Random weights from a generator on ``device`` seeded by
    ``cfg.seed`` (f32, the reference's ``init_params`` layout)."""
    from repro_torch.models import model as M

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return M.init_params(gen, model_cfg, device=dev)


class ServingService:
    """The continuous-batching service loop over one engine.

    ``params``: the model's weights, else drawn by
    :func:`init_model_params`. ``device`` is ``cuda`` unless the caller
    asks for the CPU."""

    def __init__(self, cfg: ServeConfig, params=None, *,
                 device: DeviceLike = None):
        from repro_torch.serving.engine import init_engine_state, make_engine_step

        self.cfg = cfg
        self.model_cfg = cfg.model_config()
        self.device = resolve_device(device)
        self.runner = make_runner(cfg, self.model_cfg, self.device)
        if params is None:
            params = init_model_params(cfg, self.model_cfg, self.device)
        self.params = params
        self.base_key = cfg.seed
        self.step = make_engine_step(
            self.runner, num_slots=cfg.num_slots,
            arrival_slots=cfg.arrival_slots, prompt_pad=cfg.prompt_pad,
            max_new=cfg.max_new, decode_chunk=cfg.decode_chunk,
            temperature=cfg.temperature, base_key=self.base_key)
        self.state = init_engine_state(
            self.runner, cfg.num_slots, cfg.prompt_pad, cfg.max_new)
        self.replanner = None  # attach via attach_replanner()

    def attach_replanner(self, replanner) -> None:
        self.replanner = replanner

    def run(self, trace: List[Request], *, realtime: bool = False,
            max_ticks: int = 100_000, faults=None) -> Dict:
        """Serve ``trace`` to completion; returns results and metrics.

        ``realtime=False`` (benchmark mode) treats arrival times as a
        virtual clock that only moves forward when the engine would
        otherwise idle: arrivals still gate admission ORDER, but the
        engine never sleeps. ``realtime=True`` sleeps until the next
        arrival. ``faults`` (a fault schedule) is not ported yet and
        raises."""
        if faults is not None:
            raise NotImplementedError(
                "fault injection in the serving loop comes with the faults "
                "slice (FaultSchedule, degrade_scenario)")
        trace = list(trace)
        if self.cfg.deadline_s > 0:
            trace = [dataclasses.replace(
                r, deadline=min(r.deadline,
                                r.arrival_time + self.cfg.deadline_s))
                for r in trace]
        queue = RequestQueue(trace)
        sched = SlotScheduler(self.cfg.arrival_slots, self.cfg.prompt_pad)
        admit_t: Dict[int, float] = {}
        arrive_t = {r.rid: r.arrival_time for r in trace}
        completions: List[Completion] = []
        seen_done = set()
        expired: List[Request] = []
        t0 = time.perf_counter()
        free = self.cfg.num_slots
        active_rids: set = set()
        replans = []
        tick = 0
        while tick < max_ticks:
            now = time.perf_counter() - t0
            queue.advance(now)
            expired.extend(queue.drop_expired(now))
            if queue.pending == 0 and not active_rids:
                if queue.exhausted:
                    break
                # idle: jump the virtual clock to the next arrival
                nxt = queue.next_arrival()
                if realtime:
                    time.sleep(max(nxt - now, 0.0))
                else:
                    t0 -= max(nxt - now, 0.0)
                queue.advance(time.perf_counter() - t0)
                expired.extend(queue.drop_expired(time.perf_counter() - t0))
                if queue.pending == 0 and not active_rids:
                    tick += 1
                    continue
            reqs, ap, al, ag, ar, n_arr = sched.pack(queue, free)
            now = time.perf_counter() - t0
            for r in reqs:
                admit_t[r.rid] = now
            self.state, report = self.step(self.params, self.state, ap, al,
                                           ag, ar, n_arr, free_slots=free)
            rep = torch.stack([report["active"].to(torch.long),
                               report["req_id"], report["n_gen"]]).cpu().numpy()
            act, rids, ngen = rep[0].astype(bool), rep[1], rep[2]
            now = time.perf_counter() - t0
            active_rids = {int(r) for r, a in zip(rids, act) if a and r >= 0}
            done_slots = [s for s in range(len(rids))
                          if rids[s] >= 0 and not act[s]
                          and int(rids[s]) not in seen_done]
            if done_slots:
                buf = self.state.gen_buf.cpu().numpy()  # only on completions
                for s in done_slots:
                    rid = int(rids[s])
                    seen_done.add(rid)
                    completions.append(Completion(
                        rid=rid, tokens=buf[s, :ngen[s]].astype(np.int32),
                        arrival_time=arrive_t[rid],
                        admit_time=admit_t[rid], done_time=now))
            free = int((~act).sum())
            if (self.replanner is not None and self.cfg.replan_every
                    and tick % self.cfg.replan_every == 0):
                occupancy = float(act.sum()) / max(len(act), 1)
                replans.append(self.replanner.replan(load=occupancy))
            tick += 1
        wall = time.perf_counter() - t0
        return self._metrics(completions, wall, tick, replans, expired=expired)

    def _metrics(self, completions: List[Completion], wall: float,
                 ticks: int, replans, *, expired=()) -> Dict:
        lats = sorted(c.latency for c in completions)
        total_tokens = int(sum(len(c.tokens) for c in completions))
        busy = float(self.state.busy_steps)
        steps = float(self.state.decode_steps)
        # empty-trace runs report 0.0, not NaN
        pct = (lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]
               if lats else 0.0)
        return {
            "completions": {c.rid: c.tokens for c in completions},
            "latencies": {c.rid: c.latency for c in completions},
            "num_requests": len(completions),
            "wall_seconds": wall,
            "ticks": ticks,
            "requests_per_sec": len(completions) / wall if wall else 0.0,
            "tokens_per_sec": total_tokens / wall if wall else 0.0,
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
            # fraction of slot-steps doing useful decode (wall independent)
            "slot_occupancy": busy / (steps * self.cfg.num_slots)
            if steps else 0.0,
            "replans": replans,
            "expired": sorted(r.rid for r in expired),
            # fault accounting: zero until the faults slice is ported
            "fault_events": 0,
            "retries": 0,
            "evictions": 0,
            "recovery_ticks": 0,
        }


def poisson_trace(*, n_requests: int, rate_per_sec: float, vocab_size: int,
                  plen_range=(4, 32), gen_range=(4, 24), seed: int = 0
                  ) -> List[Request]:
    """Mixed-length Poisson arrival trace (exponential inter-arrivals),
    from numpy's ``default_rng(seed)``: the reference's trace, draw for
    draw."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_sec))
        pl = int(rng.integers(plen_range[0], plen_range[1] + 1))
        gt = int(rng.integers(gen_range[0], gen_range[1] + 1))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, size=pl).astype(np.int32),
            gen_target=gt, arrival_time=t))
    return out
