"""Trace-driven discrete-event simulation of the composable cluster,
held against ``repro/cluster/simulator.py``.

The paper measures one composed system at a time; the simulator runs the
*cluster*: Poisson job arrivals drawn from a template mix over the
``configs/`` registry, scheduled by ``cluster.scheduler`` onto a shared
``DevicePool``, with injected device failures and repairs driving the
elastic recompose path.  Everything is priced analytically (no
device state), so a 512-chip, dozens-of-jobs trace simulates in well
under a second and is fully deterministic for a given seed.

Time accounting per event pop:

  1. accrue progress for every running job since the last event —
     steps completed and per-axis wire bytes (candidate ``wire_bytes``
     x devices), attributed to the link class its composition actually
     rides (this is Fig 12 per fabric, cluster-wide);
  2. apply the event (arrival / completion / failure / repair);
  3. let the scheduler start whatever now fits, pushing completion
     events at ``now + restore_overhead + remaining_steps x step_s``;
  4. integrate occupancy into telemetry (utilization + AUU).

Recomposition overhead models the checkpoint round-trip: parameter
bytes over the composition's storage tier — priced at the tranche's
*contended* per-lessee bandwidth (``Scheduler.restore_s``) — plus the
compose latency: the operational cost of the paper's attach/detach knob.

Gang jobs (``JobTemplate.n_pods > 1``) replay deterministically like
everything else: gang start/stop events carry the member domains and
DCN hop span, the gang's pod-axis collective traffic is attributed to
the DCN link class through the same incremental per-link rate
accumulators, and policy evictions/shrinks (``TraceConfig.policy``)
re-price victims' completion events exactly like failure preemptions.

Invariants:

  * **Determinism** — ``report()`` is bit-identical for a given
    ``TraceConfig`` (wall-clock telemetry deliberately lives outside
    it); the rng is consumed in a fixed order (batch trace, then
    failures, then services), so adding gang/policy fields does not
    shift pre-existing traces.
  * **Stall re-derivation** — whenever the scheduler marks a running
    job's input stall dirty, the simulator re-schedules its completion:
    progress already made is accrued at the *old* effective step time,
    remaining steps at the new one (``_resync_stalls``).
  * **Event epochs** — every completion/rate event carries the job's
    epoch; preemption, shrink, and recompose bump it, so stale events
    are dropped instead of double-completing.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.faults import FaultInjector, FaultPlan
from repro_torch.cluster.recomposer import Recomposer, RecomposeConfig
from repro_torch.cluster.scheduler import (DONE, QUEUED, REJECTED, RUNNING,
                                           Job, Scheduler, ServeJob)
from repro_torch.cluster.telemetry import ServingStats, Telemetry
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import costmodel
from repro_torch.core.topology import LinkClass, Topology, make_pool
from repro_torch.data.pipeline import IOWorkload
from repro_torch.data.storage import (StoragePool, StorageTranche,
                                      make_storage_pool)


@dataclasses.dataclass(frozen=True)
class JobTemplate:
    """One row of the trace mix."""
    arch: str
    shape_name: str
    n_chips: int
    steps: int
    weight: float = 1.0
    # explicit I/O shape (None -> lm_io_workload(arch, shape) at submit);
    # input-heavy mixes use this to stress the storage tranches
    io: Optional[IOWorkload] = None
    # gang scheduling / policy knobs: n_pods > 1 makes every job drawn
    # from this template a multi-pod gang; tenant feeds fair-share
    # accounting; priority feeds the queue order + priority_preempt
    n_pods: int = 1
    tenant: str = ""
    priority: int = 0
    # anti-thrash eviction budget forwarded to Job.max_evictions
    max_evictions: int = 3
    # live-recomposition opt-in forwarded to Job.elastic: the Recomposer
    # may widen, shrink-to-admit, or tranche-migrate these jobs mid-run
    elastic: bool = False


# A mixed train/serve diet over small-to-mid archs: feasible on modest
# chip budgets, heterogeneous enough to exercise backfill.
DEFAULT_TEMPLATES: Tuple[JobTemplate, ...] = (
    JobTemplate("qwen2-0.5b", "train_4k", 16, 20, weight=3),
    JobTemplate("mamba2-780m", "train_4k", 32, 12, weight=2),
    JobTemplate("llama3.2-3b", "train_4k", 64, 8, weight=2),
    JobTemplate("llama3.2-3b", "prefill_32k", 16, 40, weight=2),
    JobTemplate("llama3.2-3b", "decode_32k", 64, 300, weight=2),   # mem-bound
    JobTemplate("stablelm-12b", "prefill_32k", 32, 20, weight=1),
    # collective-bound MoE train: spans locality cliques, stresses the
    # composed fabric and shows up as accelerator under-utilization
    JobTemplate("moonshot-v1-16b-a3b", "train_4k", 128, 6, weight=1),
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """One logical inference service in the serving-trace mode.

    ``n_replicas`` ``ServeJob`` tenants are submitted at ``start_t`` and
    lease ``chips_per_replica`` each through the ordinary admission path;
    ``n_requests`` request arrivals (``poisson`` paced at
    ``arrival_rate_hz`` or one ``burst``) are routed to the least-loaded
    running replica.  Requests draw one of ``n_prefixes`` shared prompt
    prefixes, so per-replica prefix caches warm up over the trace — the
    cluster-level analogue of the engine's prefix-hash reuse.
    """
    name: str = "chat"
    arch: str = "llama3.2-3b"
    shape_name: str = "decode_32k"
    n_replicas: int = 2
    chips_per_replica: int = 16
    n_requests: int = 200
    arrival_rate_hz: float = 2.0
    arrival: str = "poisson"           # poisson | burst
    prompt_len: int = 2048
    max_new: int = 128
    n_prefixes: int = 8
    prefix_len: int = 1024             # shared tokens within prompt_len
    prefill_chunk: int = 512
    start_t: float = 0.0
    priority: int = 10                 # serve replicas outrank batch jobs
    ttft_slo_s: float = 5.0
    tpot_slo_s: float = 0.5
    # resilience (all off by default — legacy traces are bit-identical):
    # a request not finished within request_timeout_s of (re)issue is
    # pulled back and re-routed up to max_request_retries times with
    # exponential backoff; past the budget it fails terminally.
    request_timeout_s: float = 0.0     # 0 = no timeout
    max_request_retries: int = 2
    retry_backoff_s: float = 0.5
    # replica health checks: every health_check_s the service probes its
    # replicas and fails over the requests of any replica sitting on
    # unhealthy devices — ahead of the cluster-level fault detection
    health_check_s: float = 0.0        # 0 = no health checks
    # SLO-driven autoscaling (off by default — legacy traces are
    # bit-identical): every autoscale_interval_s the service compares
    # queued requests per admitting replica and windowed SLO attainment
    # against targets and grows/shrinks the replica set through the
    # ordinary scheduler path — scale-up leases chips like any other
    # composition (priced: lease + DCN + tranche), scale-down drains the
    # least-loaded replica and releases its lease once idle.
    autoscale: bool = False
    autoscale_interval_s: float = 2.0
    min_replicas: int = 0              # 0 -> n_replicas
    max_replicas: int = 0              # 0 -> 4 * n_replicas
    scale_up_queue: float = 4.0        # queued reqs per admitting replica
    scale_down_queue: float = 0.5
    slo_target: float = 0.99           # window attainment below -> grow


class _Replica:
    """Runtime state of one running ServeJob replica."""

    __slots__ = ("job", "active", "queue", "prefixes", "hit_tokens",
                 "miss_tokens", "served", "out_tokens")

    def __init__(self, job: ServeJob):
        self.job = job
        self.active: set = set()
        self.queue: deque = deque()
        self.prefixes: Dict[int, float] = {}    # prefix -> cached-from time
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.served = 0
        self.out_tokens = 0

    def load(self) -> int:
        return len(self.active) + len(self.queue)


class _Service:
    """Runtime state of one ServiceConfig across its replicas."""

    def __init__(self, cfg: ServiceConfig):
        self.cfg = cfg
        self.stats = ServingStats()
        self.replicas: List[ServeJob] = []
        self.backlog: deque = deque()
        self.requests: Dict[int, Dict[str, object]] = {}
        self.remaining = cfg.n_requests
        # autoscale state (inert unless cfg.autoscale)
        self.next_replica = cfg.n_replicas   # next scale-up's replica id
        self.scale_ups = 0
        self.scale_downs = 0
        self.scaling_down: set = set()       # names draining to retire
        self.windows: List[Dict[str, object]] = []   # per-tick samples
        self.win_ok = 0                      # SLO-met since last tick
        self.win_n = 0                       # completed since last tick


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_jobs: int = 20
    arrival_rate_hz: float = 0.05          # Poisson arrivals, jobs/second
    seed: int = 0
    n_local: int = 256
    n_switch: int = 256
    pods: int = 2
    templates: Tuple[JobTemplate, ...] = DEFAULT_TEMPLATES
    # device-failure injection points.  Two row shapes are accepted:
    #   (t_down, n)        — legacy: n devices fail at t_down and are
    #                        repaired repair_after_s later (bit-for-bit
    #                        the original behavior);
    #   (t_down, t_up, n)  — explicit repair time; t_up = None or inf
    #                        means the devices stay dead forever.
    failures: Tuple[Tuple[float, ...], ...] = ((120.0, 12),)
    repair_after_s: float = 300.0
    backfill: bool = True
    compose_latency_s: float = 2.08e-6 * 64   # switch reprogram, Table IV
    # optional measured-cost layer (core.costmodel.CalibratedCost): jobs
    # are admitted and priced from measurements instead of pure analytics
    calibration: Optional[object] = None
    # serving-trace mode: long-lived ServeJob tenants + request arrivals
    # alongside the batch-job trace (empty tuple = batch-only, unchanged)
    services: Tuple[ServiceConfig, ...] = ()
    # storage inventory: explicit tranche set, or None for the default
    # make_storage_pool() (4 local + 2 switch-attached NVMe tranches)
    storage_tranches: Optional[Tuple[StorageTranche, ...]] = None
    # scheduling policy (see cluster.scheduler.POLICIES) and per-tenant
    # fair-share weights as (tenant, weight) pairs (frozen-hashable)
    policy: str = "easy"
    tenant_weights: Tuple[Tuple[str, float], ...] = ()
    # deterministic arrivals appended after the Poisson trace: explicit
    # (arrival_time_s, template) pairs consume no rng, so skewed-tenant
    # and gang scenarios can be scripted exactly
    arrivals: Tuple[Tuple[float, JobTemplate], ...] = ()
    # fault-injection plane (cluster.faults): None = off; FaultPlan() is
    # behaviorally identical to None (no events, no rng draws), so the
    # legacy determinism contract is unchanged either way
    faults: Optional[FaultPlan] = None
    # fabric wiring model (core.fabrics.Topology): None = the flat
    # single-switch fabric, bit-identical to every pre-topology trace
    topology: Optional[Topology] = None
    # live recomposition plane (cluster.recomposer): None = off — no
    # ticks, no rng draws, no report section, so every legacy trace
    # stays bit-identical.  With a RecomposeConfig, elastic jobs are
    # attach-widened / shrunk-to-admit / tranche-migrated on ticks.
    recompose: Optional[RecomposeConfig] = None


def restore_overhead_s(job: Job,
                       scheduler: Optional[Scheduler] = None) -> float:
    """Checkpoint round-trip cost of (re)forming ``job``'s composition.

    With a ``scheduler``, the restore read is priced at the contended
    per-lessee bandwidth of the tranche the job actually holds
    (``Scheduler.restore_s``); without one it falls back to the job's
    uncontended tier estimate (the backfill guard's placement-unknown
    view)."""
    if scheduler is not None:
        return scheduler.restore_s(job)
    return job.est_restore_s()


class ClusterSimulator:
    """Discrete-event loop over a shared pool; deterministic per seed.

    ``tracker`` is an optional ``repro_torch.tracking.Run``; when omitted
    the process-wide current run (``tracking.current_run()``) is used, so
    a simulation executed under ``tracking.init(...)`` transparently
    mirrors its telemetry
    event stream (evicts, shrinks, gang spans, storage stalls) and
    occupancy summary into the run's ``events.jsonl``.  The mirror runs
    after the event loop drains and never touches ``report()``, so the
    bit-determinism contract is unchanged.
    """

    def __init__(self, cfg: TraceConfig, tracker: object = None):
        self.cfg = cfg
        self.tracker = tracker
        self.pool = make_pool(n_local=cfg.n_local, n_switch=cfg.n_switch,
                              pods=cfg.pods, topology=cfg.topology)
        self.telemetry = Telemetry(len(self.pool.devices))
        storage = (StoragePool(list(cfg.storage_tranches), self.pool.links)
                   if cfg.storage_tranches is not None
                   else make_storage_pool(links=self.pool.links))
        self.scheduler = Scheduler(self.pool, self.telemetry,
                                   backfill=cfg.backfill,
                                   calibration=cfg.calibration,
                                   storage=storage, policy=cfg.policy,
                                   tenant_weights=dict(cfg.tenant_weights))
        # policy preemptions checkpoint at exact progress: let the
        # scheduler pull lazy step accrual up to the eviction time
        self.scheduler.sync_progress = self._sync_steps
        # pre-create per-tranche stats so occupancy spans the whole trace
        for tr in storage.tranches.values():
            self.telemetry.tranche_stats(tr.name, tr.attach.value)
        self.rng = random.Random(cfg.seed)
        self.jobs: Dict[str, Job] = {}
        self.services: Dict[str, _Service] = {}
        self.replicas: Dict[str, _Replica] = {}     # running ServeJobs only
        # fault plane: injector when a plan is configured; ``draining``
        # replicas stop admitting requests (graceful planned detach)
        self.faults: Optional[FaultInjector] = (
            FaultInjector(self, cfg.faults) if cfg.faults is not None
            else None)
        # live recomposition plane: only constructed when configured, so
        # legacy traces carry zero recomposer state (and no report key)
        self.recomposer: Optional[Recomposer] = None
        if cfg.recompose is not None:
            self.recomposer = Recomposer(self.scheduler, cfg.recompose)
            self.telemetry.recompose_enabled = True
        self.draining: set = set()
        self._done_reps: Dict[str, Dict[str, object]] = {}
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._now = 0.0
        # incremental per-link traffic accounting: instead of scanning
        # every running job's wire_bytes dict at every event, each job's
        # bytes/sec contribution is folded into ``_link_rate`` when it
        # starts stepping and removed when it stops/recomposes; accrual
        # is then O(#link classes) per event
        self._link_rate: Dict[LinkClass, float] = {}
        self._job_rate: Dict[str, Dict[LinkClass, float]] = {}
        # per-tranche storage accounting on the same incremental pattern:
        # tranche -> [read B/s, write B/s, stall s/s] while jobs step
        self._store_rate: Dict[str, List[float]] = {}
        self._job_store_rate: Dict[str, Tuple[str, float, float, float]] = {}
        self._accrue_t = 0.0
        self.wall_s = 0.0           # wall-clock of the last run() call
        self.events_per_s = 0.0

    # ------------------------------------------------------------- events --
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def _gen_trace(self) -> None:
        t = 0.0
        weights = [tpl.weight for tpl in self.cfg.templates]
        def add_job(t_arr: float, tpl: JobTemplate, who: str) -> None:
            i = len(self.jobs)
            job = Job(name=f"job-{i:03d}-{who}-{tpl.shape_name}",
                      arch=tpl.arch, shape_name=tpl.shape_name,
                      n_chips=tpl.n_chips, steps=tpl.steps, io=tpl.io,
                      n_pods=tpl.n_pods, tenant=tpl.tenant,
                      priority=tpl.priority,
                      max_evictions=tpl.max_evictions,
                      elastic=tpl.elastic)
            self.jobs[job.name] = job
            self._push(t_arr, "arrival", job.name)

        for _ in range(self.cfg.n_jobs):
            t += self.rng.expovariate(self.cfg.arrival_rate_hz)
            tpl = self.rng.choices(self.cfg.templates, weights=weights)[0]
            add_job(t, tpl, tpl.arch)
        # scripted arrivals (gang / skewed-tenant scenarios): appended
        # after the Poisson trace and rng-free, so batch-only configs
        # consume the rng identically with or without them
        for t_arr, tpl in self.cfg.arrivals:
            add_job(t_arr, tpl, tpl.tenant or tpl.arch)
        for row in self.cfg.failures:
            if len(row) == 2:
                # legacy (t_down, n): payload stays a bare int so the
                # fail handler's repair push is bit-identical
                t_down, n = row
                self._push(t_down, "fail", n)
            else:
                t_down, t_up, n = row
                self._push(t_down, "fail", ("at", t_up, int(n)))
        # serving trace: replicas arrive as jobs, requests as events.
        # Generated after the batch trace so batch-only configs consume
        # the rng identically to pre-serving versions (stable seeds).
        for svc_cfg in self.cfg.services:
            svc = _Service(svc_cfg)
            self.services[svc_cfg.name] = svc
            for i in range(svc_cfg.n_replicas):
                job = self._make_replica_job(svc, i)
                self._push(svc_cfg.start_t, "arrival", job.name)
            t = svc_cfg.start_t
            for rid in range(svc_cfg.n_requests):
                if svc_cfg.arrival == "poisson":
                    t += self.rng.expovariate(svc_cfg.arrival_rate_hz)
                svc.requests[rid] = {
                    "submit_t": t,
                    "prefix": self.rng.randrange(svc_cfg.n_prefixes),
                    "attempt": 0,
                }
                self._push(t, "req", (svc_cfg.name, rid))
        # replica health-check ticks (rng-free; 0 = off, legacy-identical)
        for svc_cfg in self.cfg.services:
            if svc_cfg.health_check_s > 0:
                self._push(svc_cfg.start_t + svc_cfg.health_check_s,
                           "health", svc_cfg.name)
        # autoscaler ticks (rng-free; off by default, legacy-identical)
        for svc_cfg in self.cfg.services:
            if svc_cfg.autoscale and svc_cfg.autoscale_interval_s > 0:
                self._push(svc_cfg.start_t + svc_cfg.autoscale_interval_s,
                           "autoscale", svc_cfg.name)
        # live-recomposition ticks (rng-free; None = off, legacy-identical)
        if (self.recomposer is not None
                and self.cfg.recompose.interval_s > 0):
            self._push(self.cfg.recompose.interval_s, "recompose_tick")
        # fault plane last: its (optional) MTBF schedule consumes the rng
        # only after every legacy draw, so pre-fault traces replay
        # identically with faults=None or an empty FaultPlan
        if self.faults is not None:
            self.faults.push_schedule()

    # ------------------------------------------------------------ accrual --
    def _job_link_rate(self, job: Job) -> Dict[LinkClass, float]:
        """bytes/sec this job puts on each link class while stepping.
        A payload crossing a k-hop path occupies k link segments, so
        multi-tier axes accrue ``hops x`` the wire bytes (1x on the
        flat fabric — the legacy accounting)."""
        rates: Dict[LinkClass, float] = {}
        if job.system is None or job.plan is None:
            return rates
        per_step = job.system.n_devices / max(job.step_s, 1e-30)
        for axis, nbytes in job.plan.wire_bytes.items():
            if nbytes <= 0 or axis not in job.system.fabric.axis_links:
                continue
            link = job.system.fabric.axis_links[axis]
            hops = job.system.fabric.hops(axis)
            rates[link] = rates.get(link, 0.0) + nbytes * hops * per_step
        return rates

    def _rate_on(self, job: Job) -> None:
        self._rate_off(job.name)
        rates = self._job_link_rate(job)
        if rates:
            self._job_rate[job.name] = rates
            for link, r in rates.items():
                self._link_rate[link] = self._link_rate.get(link, 0.0) + r
        if (job.io is not None and job.system is not None
                and job.system.tranche is not None):
            step = max(job.step_s, 1e-30)
            row = (job.system.tranche,
                   job.io.mean_step_read_bytes() / step,
                   job.io.mean_step_write_bytes() / step,
                   job.input_stall_s / step)
            self._job_store_rate[job.name] = row
            acc = self._store_rate.setdefault(row[0], [0.0, 0.0, 0.0])
            for i in range(3):
                acc[i] += row[1 + i]

    def _rate_off(self, name: str) -> None:
        for link, r in self._job_rate.pop(name, {}).items():
            self._link_rate[link] -= r
        row = self._job_store_rate.pop(name, None)
        if row is not None:
            acc = self._store_rate[row[0]]
            for i in range(3):
                acc[i] -= row[1 + i]

    def _accrue(self, now: float) -> None:
        """Integrate link traffic and per-tranche storage I/O up to
        ``now`` (O(#links + #tranches), not O(jobs))."""
        dt = now - self._accrue_t
        if dt > 0:
            for link, rate in self._link_rate.items():
                if rate > 0:
                    self.telemetry.add_link_traffic(link, rate * dt)
            for tranche, (rr, wr, sr) in self._store_rate.items():
                if rr > 0 or wr > 0 or sr > 0:
                    self.telemetry.tranche_stats(tranche).add_io(
                        rr * dt, wr * dt, sr * dt)
        self._accrue_t = max(self._accrue_t, now)

    def _sync_steps(self, job: Job, now: float,
                    step_s: Optional[float] = None) -> None:
        """Bring one job's ``steps_done`` up to ``now`` (lazy: called only
        when an event actually needs the figure — checkpoint on failure,
        preemption, shrink re-planning).  ``step_s`` overrides the job's
        current rate (used when a stall change already overwrote it)."""
        t0 = max(job.progress_t, job.start_t)
        if now <= t0:
            return
        d_steps = min((now - t0) / max(step_s or job.step_s, 1e-30),
                      job.remaining_steps())
        job.steps_done += d_steps
        job.progress_t = now

    def _observe(self, now: float) -> None:
        self.telemetry.observe(
            now, n_leased=len(self.pool.leases),
            busy_equiv=self.scheduler.busy_equiv(),
            n_healthy=len(self.pool.healthy()))
        storage = self.scheduler.storage
        for name in storage.tranches:
            self.telemetry.tranche_stats(name).observe(
                now, storage.n_lessees(name))

    def _schedule_completion(self, job: Job, now: float,
                             overhead: float = 0.0) -> None:
        if overhead > 0:
            self.telemetry.add_recomposition(overhead)
        start = now + overhead + self.cfg.compose_latency_s
        job.progress_t = start          # stepping resumes after the restore
        # link traffic begins when stepping does, not at lease time: the
        # rate event folds the job's bytes/sec into the accumulators then
        self._push(start, "rate", (job.name, job.epoch))
        self._push(start + job.est_duration_s(), "complete",
                   (job.name, job.epoch))

    def _reschedule_victim(self, job: Job, now: float) -> None:
        """A running job lost devices (failure recompose/preempt or
        policy shrink/evict): its old traffic rates come off and, if it
        kept running in a smaller shape, its events re-price after the
        checkpoint restore; an evicted replica's load re-routes."""
        self._rate_off(job.name)
        if isinstance(job, ServeJob):
            if job.state == RUNNING:          # shrunk in place: serve on
                if job.name in self.replicas:
                    self.draining.discard(job.name)   # healthy again
                    self._push(now + restore_overhead_s(job, self.scheduler),
                               "rate", (job.name, job.epoch))
                else:
                    # a health-check failover retired the old incarnation;
                    # the recomposed replica re-registers and re-admits
                    self._replica_started(job, now)
            else:                              # preempted: re-route load
                self._reassign_replica_requests(job, now)
        elif job.state == RUNNING:            # shrunk in place
            self._schedule_completion(
                job, now, restore_overhead_s(job, self.scheduler))

    def _start_newly_scheduled(self, now: float) -> None:
        started = self.scheduler.poll(now)
        names = {j.name for j in started}
        victims = self.scheduler.drain_policy_victims()
        for job in victims:
            if job.name in names:
                # evicted and restarted within one poll: only the stale
                # rates come off; the started loop below reschedules it
                self._rate_off(job.name)
                continue
            self._reschedule_victim(job, now)
        for job in started:
            if isinstance(job, ServeJob):
                self._replica_started(job, now)
                continue
            # a preempted job resuming from a checkpoint pays the restore
            # (read back at the contended bandwidth of its new tranche)
            overhead = restore_overhead_s(job, self.scheduler)
            self._schedule_completion(job, now, overhead)
        self._resync_stalls(now, exclude=names | {j.name for j in victims})

    def _resync_stalls(self, now: float, exclude=frozenset()) -> None:
        """Tranche contention changed: re-schedule the completion of every
        running job whose input stall moved.  Progress already made is
        accrued at the *old* effective step time; the remaining steps are
        re-priced at the new one.  Jobs in ``exclude`` just had their
        events (re)scheduled by the caller and are skipped."""
        for job, old_stall in self.scheduler.drain_stall_dirty():
            if job.name in exclude or job.state != RUNNING:
                continue
            if isinstance(job, ServeJob):
                # no completion event to move — refresh the rate row so
                # traffic/stall accrual follows the new contention (the
                # per-request pricing reads job.step_s live)
                self._rate_off(job.name)
                self._push(now, "rate", (job.name, job.epoch))
                continue
            self._sync_steps(job, now,
                             step_s=job.plan.step_s + old_stall)
            self._rate_off(job.name)
            job.epoch += 1           # invalidates the stale completion
            self._schedule_completion(job, now)

    # ------------------------------------------------- live recomposition --
    def _recompose_tick(self, now: float) -> bool:
        """Periodic (rng-free) recomposition pass: sync lazy progress so
        the Recomposer prices exact remaining work, let it act, then
        route the re-shaped jobs through the ordinary re-pricing paths
        (``policy_victims`` -> restore-priced completion events,
        ``stall_dirty`` -> contention resync).  Re-pushes itself only
        while other events remain, so the heap always drains.  Returns
        whether anything was re-shaped — a no-op tick must not advance
        the simulation clock (``run`` skips its bookkeeping), or an
        idle tail of ticks would inflate makespan past the last real
        completion."""
        for job in self.scheduler.running:
            self._sync_steps(job, now)
        changed = self.recomposer.tick(now)
        if changed:
            self._start_newly_scheduled(now)
        if self._heap:
            self._push(now + self.cfg.recompose.interval_s,
                       "recompose_tick")
        return bool(changed)

    # ------------------------------------------------------------- serving --
    def _make_replica_job(self, svc: _Service, i: int) -> ServeJob:
        """Build and register replica ``i``'s ServeJob (trace-time
        replicas and autoscale scale-ups share the sizing formula)."""
        scfg = svc.cfg
        steps_est = -(-scfg.n_requests * (
            scfg.max_new
            + scfg.prompt_len // max(scfg.prefill_chunk, 1))
            // max(scfg.n_replicas
                   * SHAPES[scfg.shape_name].global_batch, 1))
        job = ServeJob(
            name=f"{scfg.name}/r{i}", arch=scfg.arch,
            shape_name=scfg.shape_name,
            n_chips=scfg.chips_per_replica, steps=steps_est,
            priority=scfg.priority, service=scfg.name,
            tenant=scfg.name,
            replica=i, ttft_slo_s=scfg.ttft_slo_s,
            tpot_slo_s=scfg.tpot_slo_s,
            prefill_chunk=scfg.prefill_chunk)
        svc.replicas.append(job)
        self.jobs[job.name] = job
        return job

    def _replica_started(self, job: ServeJob, now: float) -> None:
        """A serve replica came up: open its runtime state, start its
        collective traffic, and drain the service backlog onto it.  No
        completion event — replicas run until their request trace drains."""
        job.progress_t = now
        self.draining.discard(job.name)     # a fresh incarnation admits
        old = self.replicas.get(job.name)
        if old is not None:
            # evicted and restarted within one poll: bank the retiring
            # incarnation's counters before replacing it
            self._stash_counters(old)
        self.replicas[job.name] = _Replica(job)
        self._push(now + self.cfg.compose_latency_s, "rate",
                   (job.name, job.epoch))
        svc = self.services[job.service]
        for _ in range(len(svc.backlog)):       # overflow re-queues on reps
            self._route_request(svc, svc.backlog.popleft(), now)

    def _route_request(self, svc: _Service, rid: int, now: float) -> None:
        """Least-loaded routing over the service's running replicas.
        Draining replicas (planned detach announced) stop admitting —
        unless every live replica is draining, in which case degraded
        service beats stranding the request."""
        live = [self.replicas[j.name] for j in svc.replicas
                if j.state == RUNNING and j.name in self.replicas]
        admitting = [r for r in live if r.job.name not in self.draining]
        live = admitting or live
        if not live:
            svc.backlog.append(rid)
            return
        rep = min(live, key=lambda r: (r.load(), r.job.replica))
        if len(rep.active) < rep.job.capacity:
            self._begin_request(rep, svc, rid, now)
        else:
            rep.queue.append(rid)
            svc.requests[rid]["replica"] = rep.job.name

    def _begin_request(self, rep: _Replica, svc: _Service, rid: int,
                       now: float) -> None:
        """Price one request on the replica: chunked prefill (cheaper on
        a prefix-cache hit) then ``max_new`` decode steps at the
        replica's calibrated step time."""
        req = svc.requests[rid]
        scfg = svc.cfg
        step_s = rep.job.step_s
        # a prefix is reusable only once some request's prefill of it has
        # FINISHED (mirrors the engine registering pages after prefill) —
        # concurrent burst arrivals on a cold prefix all miss
        ready = rep.prefixes.get(req["prefix"])
        hit = ready is not None and ready <= now
        cached = scfg.prefix_len if hit else 0
        rep.hit_tokens += cached
        rep.miss_tokens += scfg.prompt_len - cached
        n_chunks = -(-(scfg.prompt_len - cached)
                     // max(rep.job.prefill_chunk, 1))
        t_first = now + n_chunks * step_s
        if ready is None or t_first < ready:
            rep.prefixes[req["prefix"]] = t_first
        t_done = t_first + scfg.max_new * step_s
        req.update(replica=rep.job.name, start_t=now, cached=cached,
                   t_first=t_first, t_done=t_done, tpot=step_s,
                   slo=(rep.job.ttft_slo_s, rep.job.tpot_slo_s))
        rep.active.add(rid)
        self._push(t_done, "req_done",
                   (scfg.name, rid, req["attempt"]))

    def _finish_request(self, svc: _Service, rid: int, now: float) -> None:
        req = svc.requests[rid]
        req["done"] = True              # timeouts stop tracking it
        scfg = svc.cfg
        rep = self.replicas.get(req.get("replica"))
        if rep is not None:
            rep.active.discard(rid)
            rep.served += 1
            rep.out_tokens += scfg.max_new
            # KV traffic: uncached prompt + generated tokens append cache
            # pages over the replica's model-axis fabric
            links = rep.job.system.fabric.axis_links
            link = links.get("model") or next(iter(links.values()))
            nbytes = ((scfg.prompt_len - req["cached"]) + scfg.max_new) \
                * costmodel.kv_bytes_per_token(get_config(scfg.arch))
            self.telemetry.add_link_traffic(link, nbytes)
            while (rep.queue and len(rep.active) < rep.job.capacity
                   and rep.job.name not in self.draining):
                self._begin_request(rep, svc, rep.queue.popleft(), now)
        ttft = req["t_first"] - req["submit_t"]
        ttft_slo, tpot_slo = req["slo"]       # the serving replica's SLOs
        slo_ok = ttft <= ttft_slo and req["tpot"] <= tpot_slo
        svc.win_n += 1                        # autoscaler's rolling window
        svc.win_ok += slo_ok
        svc.stats.add_request(
            t_done=now, wait_s=req["start_t"] - req["submit_t"],
            ttft_s=ttft, tpot_s=req["tpot"],
            prompt_tokens=scfg.prompt_len, cached_tokens=req["cached"],
            output_tokens=scfg.max_new, slo_ok=slo_ok)
        svc.remaining -= 1
        if svc.remaining == 0:
            self._finish_service(svc, now)

    def _finish_service(self, svc: _Service, now: float) -> None:
        """Request trace drained: replicas complete and give their pools
        back — the re-aggregation moment composability exists for."""
        for job in svc.replicas:
            if job.state == RUNNING:
                self._rate_off(job.name)
                rep = self.replicas.pop(job.name, None)
                if rep is not None:
                    self._stash_counters(rep)
                self.scheduler.on_complete(job, now)
            elif job.state == QUEUED:
                # preempted and never restarted before the trace drained
                self.scheduler.complete_queued(
                    job, now, "service drained while queued")
        self._start_newly_scheduled(now)

    def _reassign_replica_requests(self, job: ServeJob, now: float) -> None:
        """A replica was preempted: its in-flight and queued requests go
        back to the service for re-routing (a fresh attempt invalidates
        their scheduled completions)."""
        self.draining.discard(job.name)
        rep = self.replicas.pop(job.name, None)
        if rep is None:
            return
        self._stash_counters(rep)
        svc = self.services[job.service]
        svc.scaling_down.discard(job.name)   # preemption cancels the drain
        for rid in sorted(rep.active) + list(rep.queue):
            req = svc.requests[rid]
            req["attempt"] += 1
            req.pop("replica", None)
            self._route_request(svc, rid, now)

    # --------------------------------------------------- serve resilience --
    def _arm_timeout(self, svc: _Service, rid: int, now: float) -> None:
        """Start (or restart, on a retry) the per-request deadline."""
        t_out = svc.cfg.request_timeout_s
        if t_out <= 0:
            return
        deadline = now + t_out
        svc.requests[rid]["deadline"] = deadline
        self._push(deadline, "req_timeout", (svc.cfg.name, rid, deadline))

    def _expire_request(self, svc: _Service, rid: int, deadline: float,
                        now: float) -> None:
        """Per-request timeout fired: pull the request back from wherever
        it sits (replica batch, replica queue, service backlog) and retry
        it with exponential backoff; past the retry budget it fails."""
        req = svc.requests[rid]
        if (req.get("done") or req.get("failed")
                or req.get("deadline") != deadline):
            return                      # finished, failed, or re-armed
        svc.stats.requests_timed_out += 1
        req["attempt"] += 1             # invalidates a scheduled req_done
        rep = self.replicas.get(req.get("replica"))
        if rep is not None:
            if rid in rep.active:
                rep.active.discard(rid)
                while (rep.queue and len(rep.active) < rep.job.capacity
                       and rep.job.name not in self.draining):
                    self._begin_request(rep, svc, rep.queue.popleft(), now)
            elif rid in rep.queue:
                rep.queue.remove(rid)
        req.pop("replica", None)
        if rid in svc.backlog:
            svc.backlog.remove(rid)
        retries = req.get("retries", 0)
        if retries < svc.cfg.max_request_retries:
            req["retries"] = retries + 1
            svc.stats.request_retries += 1
            backoff = svc.cfg.retry_backoff_s * (2.0 ** retries)
            self._push(now + backoff, "req_retry", (svc.cfg.name, rid))
        else:
            req["failed"] = True
            svc.stats.requests_failed += 1
            svc.remaining -= 1
            if svc.remaining == 0:
                self._finish_service(svc, now)

    def _health_check(self, svc: _Service, now: float) -> None:
        """Periodic replica probe: a running replica sitting on unhealthy
        devices has its load failed over to its siblings immediately —
        ahead of the cluster-level fault detection latency."""
        if svc.remaining <= 0:
            return                      # trace drained: stop probing
        healthy = {d.uid: d.healthy for d in self.pool.devices}
        for job in svc.replicas:
            if (job.state != RUNNING or job.system is None
                    or job.name not in self.replicas
                    or job.name in self.draining):
                continue
            if all(healthy.get(u, False) for u in job.system.device_uids):
                continue
            self.telemetry.log(now, "detect", job.name,
                               "health-check failover")
            self._reassign_replica_requests(job, now)
            # the cluster-level detect hasn't fired yet, so the job still
            # reads RUNNING — quarantine it from routing until it restarts
            self.draining.add(job.name)
        self._push(now + svc.cfg.health_check_s, "health", svc.cfg.name)

    # --------------------------------------------------------- autoscaling --
    def _autoscale_tick(self, svc: _Service, now: float) -> None:
        """Periodic (rng-free) scale decision: retire replicas whose
        planned drain finished, sample the window, then compare queued
        requests per admitting replica and windowed SLO attainment
        against the config targets.  Scale-up submits a new ServeJob
        through the ordinary admission path (the lease is priced like
        any other composition); scale-down marks the least-loaded
        replica draining — it stops admitting, finishes its in-flight
        work, and gives its chips back at a later tick."""
        if svc.remaining <= 0:
            return                      # trace drained: stop ticking
        if not any(j.state in (QUEUED, RUNNING) for j in svc.replicas):
            return      # every replica rejected/retired: the service is
                        # stranded and ticking forever would never drain
        cfg = svc.cfg
        self._retire_drained(svc, now)
        live = [j for j in svc.replicas
                if j.state == RUNNING and j.name in self.replicas]
        admitting = [j for j in live if j.name not in self.draining]
        queued = (sum(len(self.replicas[j.name].queue) for j in admitting)
                  + len(svc.backlog))
        per_rep = queued / max(len(admitting), 1)
        att = svc.win_ok / svc.win_n if svc.win_n else 1.0
        # replicas already requested count against the cap, so a slow
        # lease (queued scale-up) does not trigger a second one
        alive = [j for j in svc.replicas
                 if j.state in (QUEUED, RUNNING)
                 and j.name not in svc.scaling_down]
        svc.windows.append({
            "t": now, "attainment": att, "completed": svc.win_n,
            "queued_per_replica": per_rep, "replicas": len(alive)})
        svc.win_ok = svc.win_n = 0
        lo = cfg.min_replicas or cfg.n_replicas
        hi = cfg.max_replicas or 4 * cfg.n_replicas
        pressured = per_rep > cfg.scale_up_queue or att < cfg.slo_target
        # a rejected replica means the shape is analytically infeasible
        # on this pool — growth is permanently off, not retried forever
        can_grow = not any(j.state == REJECTED for j in svc.replicas)
        if pressured and can_grow and len(alive) < hi:
            self._scale_up(svc, now)
        elif (not pressured and per_rep < cfg.scale_down_queue
                and len(admitting) > lo and len(alive) > lo):
            self._scale_down(svc, admitting, now)
        self._push(now + cfg.autoscale_interval_s, "autoscale", cfg.name)

    def _retire_drained(self, svc: _Service, now: float) -> None:
        """Release the lease of any planned-drain replica that emptied:
        the scale-down's second half — chips return to the pool through
        ``on_complete`` exactly like a finished job."""
        for name in sorted(svc.scaling_down):
            job = self.jobs[name]
            rep = self.replicas.get(name)
            if job.state != RUNNING or rep is None:
                # preempted/failed mid-drain: the restart path already
                # re-routed its load; drop the drain plan
                svc.scaling_down.discard(name)
                self.draining.discard(name)
                continue
            if rep.load() > 0:
                continue                # still finishing in-flight work
            self._rate_off(name)
            self.replicas.pop(name)
            self._stash_counters(rep)
            self.draining.discard(name)
            svc.scaling_down.discard(name)
            self.telemetry.log(now, "autoscale", name,
                               "scale-down: drained, lease released")
            self.scheduler.on_complete(job, now)
            self._start_newly_scheduled(now)

    def _scale_up(self, svc: _Service, now: float) -> None:
        job = self._make_replica_job(svc, svc.next_replica)
        svc.next_replica += 1
        svc.scale_ups += 1
        self.telemetry.log(now, "autoscale", job.name,
                           f"scale-up: +1 replica for {svc.cfg.name}")
        self.scheduler.submit(job, now)
        self._start_newly_scheduled(now)

    def _scale_down(self, svc: _Service, admitting: List[ServeJob],
                    now: float) -> None:
        job = min(admitting,
                  key=lambda j: (self.replicas[j.name].load(), -j.replica))
        svc.scale_downs += 1
        svc.scaling_down.add(job.name)
        self.draining.add(job.name)     # stops admitting immediately
        self.telemetry.log(now, "autoscale", job.name,
                           "scale-down: draining")

    # ---------------------------------------------------------------- run --
    def run(self) -> Dict[str, object]:
        wall0 = time.perf_counter()
        self._gen_trace()
        self._observe(0.0)
        while self._heap:
            now, _, kind, payload = heapq.heappop(self._heap)
            if kind == "recompose_tick":
                if not self._heap and self.scheduler.all_done():
                    # trailing no-op tick scheduled before the trace
                    # drained: skip it before it can extend makespan
                    continue
                self._accrue(now)
                if self._recompose_tick(now):
                    self._now = now
                    self.scheduler.manager.check_exclusive()
                    self._observe(now)
                continue
            if self.recomposer is not None and kind in ("rate", "complete"):
                job = self.jobs[payload[0]]
                if job.state != RUNNING or job.epoch != payload[1]:
                    # epoch-stale no-op: with live recomposition every
                    # attach/detach strands one of these, and letting it
                    # advance the clock would bill the recomposed trace
                    # for time nothing ran (legacy traces keep the old
                    # accounting for bit-identity)
                    continue
            self._now = now
            self._accrue(now)
            if kind == "arrival":
                job = self.jobs[payload]
                self.scheduler.submit(job, now)
                self._start_newly_scheduled(now)
            elif kind == "rate":
                name, epoch = payload
                job = self.jobs[name]
                if job.state == RUNNING and job.epoch == epoch:
                    self._rate_on(job)
            elif kind == "complete":
                name, epoch = payload
                job = self.jobs[name]
                if job.state == RUNNING and job.epoch == epoch:
                    self._rate_off(name)
                    self.scheduler.on_complete(job, now)
                    self._start_newly_scheduled(now)
            elif kind == "req":
                svc_name, rid = payload
                svc = self.services[svc_name]
                svc.stats.requests_submitted += 1
                svc.stats.mark(now)
                self._route_request(svc, rid, now)
                self._arm_timeout(svc, rid, now)
            elif kind == "req_timeout":
                svc_name, rid, deadline = payload
                self._expire_request(self.services[svc_name], rid,
                                     deadline, now)
            elif kind == "req_retry":
                svc = self.services[payload[0]]
                req = svc.requests[payload[1]]
                if not (req.get("done") or req.get("failed")):
                    self._route_request(svc, payload[1], now)
                    self._arm_timeout(svc, payload[1], now)
            elif kind == "health":
                self._health_check(self.services[payload], now)
            elif kind == "autoscale":
                self._autoscale_tick(self.services[payload], now)
            elif kind == "req_done":
                svc_name, rid, attempt = payload
                svc = self.services[svc_name]
                if svc.requests[rid]["attempt"] == attempt:
                    self._finish_request(svc, rid, now)
            elif kind == "fail":
                # failure handling needs exact steps_done (checkpoint
                # boundaries, shrink re-planning): sync every running job
                # before the scheduler mutates them — failures are rare,
                # so this scan is off the per-event hot path
                for job in self.scheduler.running:
                    self._sync_steps(job, now)
                healthy = [d.uid for d in self.pool.healthy()]
                if isinstance(payload, tuple):
                    # explicit-repair row ("at", t_up, n): t_up None/inf
                    # means the devices stay dead forever
                    _, t_up, n_req = payload
                else:
                    t_up, n_req = now + self.cfg.repair_after_s, \
                        int(payload)
                n = min(n_req, len(healthy))
                down = self.rng.sample(healthy, n)
                changed = self.scheduler.on_failure(down, now)
                for job in changed:
                    self._reschedule_victim(job, now)
                # changed jobs were just rescheduled (restore overhead
                # included); only their co-tenants need a stall resync
                self._resync_stalls(now, exclude={j.name for j in changed})
                if t_up is not None and t_up != float("inf"):
                    self._push(t_up, "repair", down)
                self._start_newly_scheduled(now)
            elif kind == "repair":
                self.pool.repair(list(payload))
                self.telemetry.log(now, "repair", "",
                                   f"{len(payload)} device(s) back")
                self._start_newly_scheduled(now)
            elif kind == "fault":
                self.faults.on_fault(payload, now)
            elif kind == "detect":
                self.faults.on_detect(payload, now)
            elif kind == "fault_clear":
                self.faults.on_clear(payload, now)
            elif kind == "drain":
                self.faults.on_drain(payload, now)
            elif kind == "poll":
                # a retry-backoff gate opened: let the queue re-poll
                self._start_newly_scheduled(now)
            self.scheduler.manager.check_exclusive()
            self._observe(now)
        # jobs can legitimately remain queued when the heap drains (e.g.
        # permanent capacity loss); report() surfaces them as "stranded"
        self.wall_s = time.perf_counter() - wall0
        self.events_per_s = (len(self.telemetry.events) / self.wall_s
                             if self.wall_s > 0 else 0.0)
        rep = self.report()
        self._mirror_to_tracker(rep)
        return rep

    def _mirror_to_tracker(self, rep: Dict[str, object]) -> None:
        """Mirror the finished trace into the active tracking run (no-op
        without one): the control-plane event stream as ``event``
        records keyed by simulated time, plus one ``system`` sample of
        the harness counters (AUU, per-link byte rates, pool util)."""
        from repro_torch import tracking
        run = self.tracker or tracking.current_run()
        if run is None:
            return
        for ev in self.telemetry.events:
            if ev.kind in ("submit", "start", "complete"):
                continue        # high-volume steady-state; keep the stream
                                # focused on recomposition-plane events
            run.log_event(f"sim.{ev.kind}",
                          {"job": ev.job, "detail": ev.detail}, sim_t=ev.t)
        counters = {"sim.auu": rep["auu"],
                    "sim.pool_utilization": rep["pool_utilization"]}
        for link, gbps in rep["link_traffic_gbps"].items():
            counters[f"sim.link_gbps.{link}"] = gbps
        for name, st in rep["storage"].items():
            counters[f"sim.storage_stall_s.{name}"] = st["input_stall_s"]
        run.log_system(counters)
        run.log({
            "makespan_s": rep["makespan_s"],
            "auu": rep["auu"],
            "pool_utilization": rep["pool_utilization"],
            "jobs_evicted": rep["jobs"]["evicted"],
            "jobs_shrunk": rep["jobs"]["shrunk"],
            "gangs_started": rep["gangs"]["started"],
            "recompositions": rep["recomposition"]["count"],
            "sim_wall_s": self.wall_s,
        })

    # ------------------------------------------------------------- report --
    def report(self) -> Dict[str, object]:
        rep = self.telemetry.report()
        sched = self.scheduler
        rep["jobs"]["stranded"] = len(sched.queue) + len(sched.running)
        rep["makespan_s"] = self._now
        rep["calibrated"] = bool(self.scheduler.calibration)
        # NOTE: wall_s / events_per_s are deliberately NOT in this dict —
        # report() must be bit-deterministic per seed; callers attach the
        # wall-time telemetry (``self.wall_s``) themselves.
        rep["recompositions_per_job"] = {
            j.name: j.recompositions for j in sched.done
            if j.recompositions}
        rep["policy"] = self.scheduler.policy.name
        rep["config"] = {
            "n_jobs": self.cfg.n_jobs,
            "pool_devices": len(self.pool.devices),
            "arrival_rate_hz": self.cfg.arrival_rate_hz,
            "failures": list(self.cfg.failures),
            "seed": self.cfg.seed,
            "policy": self.cfg.policy,
            "n_scripted_arrivals": len(self.cfg.arrivals),
            "n_scripted_faults": (0 if self.cfg.faults is None
                                  else len(self.cfg.faults.faults)),
        }
        if self.services:
            rep["serving"] = {
                name: self._service_report(svc)
                for name, svc in self.services.items()}
        return rep

    def _service_report(self, svc: _Service) -> Dict[str, object]:
        out = svc.stats.report()
        out["requests"]["stranded"] = svc.remaining
        out["replicas"] = {}
        for job in svc.replicas:
            row: Dict[str, object] = {"state": job.state,
                                      "recompositions": job.recompositions}
            if job.plan is not None and job.plan.feasible:
                row["rated_tokens_per_s"] = job.tokens_per_s
            row.update(self._replica_counters(job.name))
            out["replicas"][job.name] = row
        if svc.cfg.autoscale:
            reps = [w["replicas"] for w in svc.windows]
            out["autoscale"] = {
                "scale_ups": svc.scale_ups,
                "scale_downs": svc.scale_downs,
                "peak_replicas": max(reps, default=svc.cfg.n_replicas),
                "final_replicas": len(
                    [j for j in svc.replicas if j.state == RUNNING]),
                "windows": svc.windows,
            }
        return out

    def _stash_counters(self, rep: _Replica) -> None:
        """Fold a retiring incarnation's counters into the durable tally
        (a preempted replica restarts with a cold cache, but its served
        work still counts)."""
        d = self._done_reps.setdefault(
            rep.job.name, {"served": 0, "output_tokens": 0,
                           "hit_tokens": 0, "miss_tokens": 0})
        d["served"] += rep.served
        d["output_tokens"] += rep.out_tokens
        d["hit_tokens"] += rep.hit_tokens
        d["miss_tokens"] += rep.miss_tokens

    def _replica_counters(self, name: str) -> Dict[str, object]:
        """Served/hit counters for a replica across all incarnations."""
        tally = dict(self._done_reps.get(
            name, {"served": 0, "output_tokens": 0,
                   "hit_tokens": 0, "miss_tokens": 0}))
        rep = self.replicas.get(name)
        if rep is not None:
            tally["served"] += rep.served
            tally["output_tokens"] += rep.out_tokens
            tally["hit_tokens"] += rep.hit_tokens
            tally["miss_tokens"] += rep.miss_tokens
        tot = tally["hit_tokens"] + tally["miss_tokens"]
        return {"served": tally["served"],
                "output_tokens": tally["output_tokens"],
                "cache_hit_rate": tally["hit_tokens"] / tot if tot else 0.0}


def run_trace(cfg: Optional[TraceConfig] = None) -> Dict[str, object]:
    """One-call entry point: simulate ``cfg`` (default ``TraceConfig()``)
    and return its report."""
    return ClusterSimulator(cfg or TraceConfig()).run()
