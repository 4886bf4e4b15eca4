"""Host-side serving: request queue, slot scheduler, service loop.

Port of ``repro.serving.service``. The host does only bookkeeping; every
token-level decision lives in the engine step on the device. Per tick the
host (a) moves requests whose arrival time has passed into the FIFO
queue and drops queued requests past their deadline, (b) packs at most
``min(A, pending, free slots)`` of them into the fixed-shape arrival
buffers, (c) calls the engine step, and (d) reads the small report back
and drains completions (pulling ``gen_buf`` rows only for slots that
finished). Idle ticks (nothing pending, nothing active) skip the step.

On a stage mesh (a split plan served one stage per rank) the host's
decisions read the wall clock, which each process reads for itself: two
ranks could admit different requests on one tick and the token ring
would stall or diverge. So the rank at stage 0 makes every decision
(arrivals, expiries, the fault clock, stalls) and sends each engine call
to the other ranks as one small schedule (:data:`STEP`: the packed
arrival buffers and the free-slot count; :data:`EVICT`: free every slot
after an outage; :data:`STOP`), and they follow it. The engine state is
then the same on every rank, as the reference replicates it.
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
    # ``expired``) instead of admitted; under faults an evicted request
    # re-enters the queue and can expire there too.
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

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put evicted in-flight requests back at the HEAD of the queue (in
        the given order), so recovery re-admits them before newer
        arrivals."""
        self._ready.extendleft(reversed(reqs))

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


def make_runner(cfg: ServeConfig, model_cfg, device: DeviceLike = None,
                mesh=None, pipe=None):
    """The runner a :class:`ServeConfig` asks for: one device, or the
    split plan ``cfg.boundaries`` stage by stage (one stage per rank of a
    stage ``mesh``). ``pipe``: the plan's ``PipelineConfig`` (by default
    the config's compute and wire dtypes, the stages on the reference
    route; ``stage_impl="pallas"`` takes the stage kernel)."""
    from repro_torch.serving.runners import PipelineRunner, SingleDeviceRunner

    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.boundaries is None:
        return SingleDeviceRunner(model_cfg, compute_dtype=dtype, device=device)
    from repro_torch.core.pipeline import PipelineConfig

    if pipe is None:
        pipe = PipelineConfig(compute_dtype=cfg.compute_dtype,
                              wire_dtype=cfg.wire_dtype)
    return PipelineRunner(model_cfg, cfg.boundaries, pipe=pipe, device=device,
                          mesh=mesh)


def stage_mesh_for(cfg: ServeConfig, device: DeviceLike = None):
    """The stage mesh a split plan is served on, as the reference builds
    ``make_stage_mesh(len(boundaries))``: when ``cfg.boundaries`` has more
    than one stage and the default process group has at least that many
    ranks (a collective call: every rank makes it); else ``None``, every
    stage in this process."""
    import torch.distributed as dist

    if not cfg.boundaries or len(cfg.boundaries) < 2:
        return None
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() >= len(cfg.boundaries)):
        return None
    from repro_torch.launch.mesh import make_stage_mesh

    return make_stage_mesh(len(cfg.boundaries), device=device)


# the kinds of the stage-0 rank's schedule messages
STEP, EVICT, STOP = 0, 1, 2


def init_model_params(cfg: ServeConfig, model_cfg, device: DeviceLike = None):
    """Random weights from a generator on ``device`` seeded by
    ``cfg.seed`` (f32, the reference's ``init_params`` layout)."""
    from repro_torch.models import model as M

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return M.init_params(gen, model_cfg, device=dev)


class ServingService:
    """The continuous-batching service loop over one engine.

    ``params``: the model's weights (the whole tree), else drawn by
    :func:`init_model_params`. ``device`` is ``cuda`` unless the caller
    asks for the CPU.

    ``mesh``: a stage mesh for a split plan (``cfg.boundaries``), stage
    ``t`` on rank ``t``; each rank keeps its
    :func:`~repro_torch.core.pipeline.stage_params` share. Without one,
    a split plan is served on :func:`stage_mesh_for`'s mesh when the
    default process group has a rank per stage, else in this process;
    ``mesh=False`` serves every stage in this process whatever the group.
    ``pipe``: the split plan's ``PipelineConfig`` (see :func:`make_runner`). On
    a mesh every rank calls :meth:`run` with the same trace; the stage-0
    rank decides each tick and returns the metrics, the others follow it
    and return their completions (``{"completions", "num_requests"}``),
    equal to the stage-0 rank's."""

    def __init__(self, cfg: ServeConfig, params=None, *,
                 device: DeviceLike = None, mesh=None, pipe=None):
        from repro_torch.serving.engine import init_engine_state, make_engine_step

        self.cfg = cfg
        self.model_cfg = cfg.model_config()
        if mesh is None:
            mesh = stage_mesh_for(cfg, device)
        mesh = mesh or None  # False: this process
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.runner = make_runner(cfg, self.model_cfg, self.device, mesh, pipe)
        if params is None:
            params = init_model_params(cfg, self.model_cfg, self.device)
        if mesh is not None:
            from repro_torch.core.pipeline import stage_params

            params = stage_params(params, self.model_cfg, cfg.boundaries,
                                  mesh.axis_index(self.runner.stage_axis))
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
        # the devices the serving pipeline occupies, as FaultSchedule rows:
        # one per stage for split serving (stage t, on a mesh rank t),
        # device 0 alone
        self.stage_devices = (tuple(range(len(cfg.boundaries)))
                              if cfg.boundaries else (0,))

    @property
    def leads(self) -> bool:
        """Whether this rank decides the ticks (always, without a mesh)."""
        return self.mesh is None or self.mesh.axis_index(self.runner.stage_axis) == 0

    def _schedule(self, kind: int, arrays=(), n_arr: int = 0, free: int = 0):
        """The stage-0 rank's message of one tick, sent to the other ranks
        (one broadcast of ``3 + A (P + 3)`` int64s); on a follower, the
        message received. Returns ``(kind, arrays, n_arr, free)``."""
        from repro_torch.distribution import collectives as C

        a, p = self.cfg.arrival_slots, self.cfg.prompt_pad
        msg = torch.zeros((3 + a * (p + 3),), dtype=torch.long)
        if self.leads:
            msg[:3] = torch.tensor([kind, n_arr, free])
            if arrays:
                msg[3:] = torch.from_numpy(np.concatenate(
                    [np.asarray(x, np.int64).reshape(-1) for x in arrays]))
        msg = C.broadcast(msg.to(self.device), self.mesh, self.runner.stage_axis,
                          0).cpu().numpy()
        kind, n_arr, free = (int(v) for v in msg[:3])
        body = msg[3:]
        arrays = (body[:a * p].reshape(a, p), body[a * p:a * p + a],
                  body[a * p + a:a * p + 2 * a], body[a * p + 2 * a:])
        return kind, arrays, n_arr, free

    def _engine(self, ap, al, ag, ar, n_arr, free):
        """One engine call (sent to the other ranks first, on a mesh)."""
        if self.mesh is not None:
            self._schedule(STEP, (ap, al, ag, ar), n_arr, free)
        self.state, report = self.step(self.params, self.state, ap, al, ag, ar,
                                       n_arr, free_slots=free)
        return report

    def _evict_all(self) -> None:
        from repro_torch.serving.engine import evict_slots

        if self.mesh is not None and self.leads:
            self._schedule(EVICT)
        self.state = evict_slots(self.state, self.state.active)

    def _finished(self, report, seen_done):
        """``(active, rids, n_gen, done)`` from an engine report: ``done``
        the ``(rid, tokens)`` of the slots that finished since the last
        report (``seen_done`` is updated); ``gen_buf`` is read only when
        one did."""
        rep = torch.stack([report["active"].to(torch.long),
                           report["req_id"], report["n_gen"]]).cpu().numpy()
        act, rids, ngen = rep[0].astype(bool), rep[1], rep[2]
        slots = [s for s in range(len(rids))
                 if rids[s] >= 0 and not act[s] and int(rids[s]) not in seen_done]
        done = []
        if slots:
            buf = self.state.gen_buf.cpu().numpy()  # only on completions
            for s in slots:
                seen_done.add(int(rids[s]))
                done.append((int(rids[s]), buf[s, :ngen[s]].astype(np.int32)))
        return act, rids, ngen, done

    def _follow(self) -> Dict:
        """A follower rank's :meth:`run`: the stage-0 rank's engine calls,
        in its order."""
        seen_done, completions = set(), {}
        while True:
            kind, arrays, n_arr, free = self._schedule(STOP)
            if kind == STOP:
                return {"completions": completions,
                        "num_requests": len(completions)}
            if kind == EVICT:
                self._evict_all()
                continue
            self.state, report = self.step(self.params, self.state, *arrays,
                                           n_arr, free_slots=free)
            completions.update(self._finished(report, seen_done)[3])

    def attach_replanner(self, replanner) -> None:
        self.replanner = replanner

    def run(self, trace: List[Request], *, realtime: bool = False,
            max_ticks: int = 100_000, faults=None) -> Dict:
        """Serve ``trace`` to completion; returns results and metrics.

        ``realtime=False`` (benchmark mode) treats arrival times as a
        virtual clock that only moves forward when the engine would
        otherwise idle: arrivals still gate admission ORDER, but the
        engine never sleeps. ``realtime=True`` sleeps until the next
        arrival.

        ``faults`` is an optional :class:`repro_torch.core.faults.
        FaultSchedule` covering the service's ``stage_devices``. A tick
        whose fault-clock time (``cfg.fault_tick_s > 0``: ``tick *
        fault_tick_s``; else the virtual arrival clock) lands inside an
        assigned device's outage window is a failed tick: the engine is
        not called, the service retries with bounded exponential backoff
        (``cfg.max_retries`` / ``cfg.retry_backoff_s``), and if the device
        is still down it evicts every in-flight slot (``evict_slots``),
        requeues those requests at the head of the queue, re-plans around
        the dead devices (``replan(exclude_devices=...)``) and jumps the
        clock to the outage's end. Sampling is keyed by request id, so
        every request completes with the tokens of a fault-free run.

        On a stage mesh a follower rank returns its completions only (see
        the class docstring)."""
        if not self.leads:
            return self._follow()
        try:
            return self._lead(trace, realtime, max_ticks, faults)
        finally:
            if self.mesh is not None:  # the followers return, also on an error
                self._schedule(STOP)

    def _lead(self, trace, realtime, max_ticks, faults) -> Dict:
        """:meth:`run` on the rank that decides the ticks."""
        from repro_torch.core.faults import FaultClock

        trace = list(trace)
        if self.cfg.deadline_s > 0:
            trace = [dataclasses.replace(
                r, deadline=min(r.deadline,
                                r.arrival_time + self.cfg.deadline_s))
                for r in trace]
        queue = RequestQueue(trace)
        sched = SlotScheduler(self.cfg.arrival_slots, self.cfg.prompt_pad)
        clock = FaultClock(self.cfg.fault_tick_s)
        if faults is not None:
            # host-side numpy mirrors of faults.device_up / next_recovery
            # (the same half-open window arithmetic in f32), read once
            f_start = faults.outage_start.cpu().numpy()
            f_end = faults.outage_end.cpu().numpy()
            f_stage = np.asarray(self.stage_devices, np.int64)

            def _f_up(t):
                t = np.float32(t)
                return ~(((t >= f_start) & (t < f_end)).any(axis=-1))

            def _f_recovery(t):
                t = np.float32(t)
                cov = (t >= f_start[f_stage]) & (t < f_end[f_stage])
                if not cov.any():
                    return float(t)
                return float(max(t, np.where(cov, f_end[f_stage], -np.inf).max()))
        admit_t: Dict[int, float] = {}
        arrive_t = {r.rid: r.arrival_time for r in trace}
        completions: List[Completion] = []
        seen_done = set()
        inflight: Dict[int, Request] = {}
        expired: List[Request] = []
        t0 = time.perf_counter()
        free = self.cfg.num_slots
        active_rids: set = set()
        replans = []
        fault_events = retries = evictions = recovery_ticks = 0
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
            if faults is not None:
                t_f = clock.time_of(tick, time.perf_counter() - t0)
                up = _f_up(t_f)
                down = [d for d in self.stage_devices if not up[d]]
                if down:
                    fault_events += 1
                    # bounded exponential backoff before giving up
                    t_probe, backoff = t_f, self.cfg.retry_backoff_s
                    recovered = False
                    for _ in range(max(self.cfg.max_retries, 0)):
                        retries += 1
                        t_probe += backoff
                        backoff *= 2.0
                        probe_up = _f_up(t_probe)
                        if all(probe_up[d] for d in self.stage_devices):
                            recovered = True
                            break
                    if not recovered:
                        # give up on this outage: free every in-flight slot
                        # (the pipeline spans all stage devices), requeue
                        # its requests at the head, re-plan around the dead
                        # devices
                        victims = sorted(
                            (inflight[r] for r in active_rids if r in inflight),
                            key=lambda r: (r.arrival_time, r.rid))
                        if victims:
                            evictions += len(victims)
                            queue.requeue_front(victims)
                            self._evict_all()
                            active_rids = set()
                            free = self.cfg.num_slots
                        if self.replanner is not None:
                            replans.append(self.replanner.replan(
                                load=0.0, exclude_devices=down))
                        t_probe = _f_recovery(t_probe)
                    # stall to the recovery point: charge it to the clock
                    # and move the fault clock past it
                    stall = max(t_probe - t_f, 0.0)
                    if realtime:
                        time.sleep(stall)
                    else:
                        t0 -= stall
                    skipped = clock.ticks_until(t_f, t_probe)
                    recovery_ticks += skipped
                    tick += skipped
                    continue
            reqs, ap, al, ag, ar, n_arr = sched.pack(queue, free)
            now = time.perf_counter() - t0
            for r in reqs:
                admit_t[r.rid] = now
                inflight[r.rid] = r
            report = self._engine(ap, al, ag, ar, n_arr, free)
            act, rids, ngen, done = self._finished(report, seen_done)
            now = time.perf_counter() - t0
            active_rids = {int(r) for r, a in zip(rids, act) if a and r >= 0}
            for rid, tokens in done:
                inflight.pop(rid, None)
                completions.append(Completion(
                    rid=rid, tokens=tokens, arrival_time=arrive_t[rid],
                    admit_time=admit_t[rid], done_time=now))
            free = int((~act).sum())
            if (self.replanner is not None and self.cfg.replan_every
                    and tick % self.cfg.replan_every == 0):
                occupancy = float(act.sum()) / max(len(act), 1)
                replans.append(self.replanner.replan(load=occupancy))
            tick += 1
        wall = time.perf_counter() - t0
        return self._metrics(completions, wall, tick, replans,
                             expired=expired, fault_events=fault_events,
                             retries=retries, evictions=evictions,
                             recovery_ticks=recovery_ticks)

    def _metrics(self, completions: List[Completion], wall: float,
                 ticks: int, replans, *, expired=(), fault_events: int = 0,
                 retries: int = 0, evictions: int = 0,
                 recovery_ticks: int = 0) -> Dict:
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
            # failure accounting (all zero on fault-free runs)
            "fault_events": fault_events,
            "retries": retries,
            "evictions": evictions,
            "recovery_ticks": recovery_ticks,
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
