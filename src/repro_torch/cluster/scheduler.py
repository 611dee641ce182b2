"""Multi-tenant scheduler over the shared composable pool, held against
``repro/cluster/scheduler.py``.

Jobs (train / prefill / decode, drawn from the ``configs/`` registry)
queue for slices of the device pool.  For each job the scheduler:

  1. **admits** it only if the analytic model (``core.recommend``) finds a
     feasible (dp, tp) factorization of the requested chip budget —
     batch divisibility, MoE expert divisibility, and the per-device HBM
     estimate are all checked, so a 35B train job asking for 2 chips is
     rejected at submit time instead of OOMing at compose time;
  2. **places** it with domain-aware leasing (``cluster.lease``): the tp
     axis stays inside a locality clique when possible, and the per-axis
     link classes of the composition follow from where the free devices
     actually are (localGPUs / hybridGPUs / falconGPUs emerge from pool
     state);
  3. **starts** it via ``core.compose`` — which claims an exclusive lease
     on the devices, so two jobs can never hold the same chip;
  4. on device failure, **preempts-to-shrink** using ``train.elastic``
     semantics: same-shape recompose from spares when they exist, halve
     the data axis when they don't, re-queue the job when even a 1-wide
     mesh no longer fits.

Queue policy is **pluggable** (``Policy``): ``easy`` is priority FIFO
with EASY backfill — the head job reserves the earliest time enough
devices free up (running jobs expose analytic end-time estimates), and
a later job may jump ahead only if it fits the free pool *and* its
estimated finish does not push past the reservation.  ``fair_share``
orders the queue by per-tenant weighted deficit (device-seconds
consumed divided by tenant weight — the least-served tenant goes
first), and ``priority_preempt`` extends ``easy`` with policy-driven
preemption: a higher-priority head may shrink or evict lower-priority
running jobs (including whole gangs) through the ``train/elastic``
checkpoint-resume path.

Jobs with ``n_pods > 1`` are **gangs**: an all-or-nothing multi-pod
composition over the DCN axis (``lease.plan_gang``), admitted with the
pod axis priced on the DCN links (``recommend._estimate(pods=...)``
reusing ``Candidate.wire_bytes``/``CalibratedCost``).

Invariants:

  * **Atomic composition** — a job either holds its full device claim
    (all gang members) plus a storage tranche, or nothing: a conflict
    anywhere rolls the whole claim back (``CompositionError``), the job
    stays queued, and the conflict is counted.
  * **Stall re-derivation** — whenever tranche contention changes
    (start / complete / preempt / shrink), every running job's
    ``input_stall_s`` is re-derived (``update_stalls``) and changed
    jobs are queued on ``stall_dirty`` for the simulator to re-price.
  * **Gangs are all-or-nothing at runtime too** — losing any member
    device preempts the whole gang (no cross-pod shrink).
  * **Checkpoint-boundary resume** — preemption and policy shrink floor
    ``steps_done`` to the last integer step; the restore cost is priced
    against the *contended* tranche bandwidth (``restore_s``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.cluster.lease import (GangPlan, LeaseManager,
                                       derive_axis_paths, domain_counts,
                                       hosting_domains, path_maps, plan_gang,
                                       plan_placement, plan_tranche)
from repro_torch.cluster.telemetry import Telemetry
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import recommend
from repro_torch.core.compose import (ComposedSystem, CompositionError,
                                      compose, recompose, release)
from repro_torch.core.topology import Device, DevicePool, LinkClass
from repro_torch.data.pipeline import (IOWorkload, StorageModel,
                                       lm_io_workload, workload_stall)
from repro_torch.data.storage import StoragePool, make_storage_pool
from repro_torch.train import elastic

QUEUED, RUNNING, DONE, REJECTED = "queued", "running", "done", "rejected"
# terminal state for jobs whose fault-retry budget is exhausted (the
# fault-injection plane's capped retry-with-backoff; see cluster.faults)
FAILED = "failed"


@dataclasses.dataclass
class Job:
    """One tenant workload: an (arch, shape) cell plus a chip budget."""
    name: str
    arch: str
    shape_name: str                  # train_4k | prefill_32k | decode_32k
    n_chips: int
    steps: int = 10
    priority: int = 0
    # lifecycle (filled by the scheduler)
    state: str = QUEUED
    submit_t: float = 0.0
    queued_t: float = 0.0            # last time the job entered the queue
    start_t: float = 0.0
    progress_t: float = 0.0          # last time steps_done was brought up
    end_t: float = 0.0
    plan: Optional[recommend.Candidate] = None
    system: Optional[ComposedSystem] = None
    run: Optional[elastic.ElasticRun] = None
    steps_done: float = 0.0
    recompositions: int = 0
    epoch: int = 0                   # bumped on every shape change/preempt
    why_rejected: str = ""
    # storage: the job's I/O shape (defaulted from the arch/shape cell at
    # submit) and the contended input stall on its leased tranche (updated
    # by the scheduler as co-tenants come and go)
    io: Optional[IOWorkload] = None
    input_stall_s: float = 0.0
    # gang scheduling: n_pods > 1 requests an all-or-nothing multi-pod
    # composition over the DCN axis; gang_domains records the member
    # locality domains of the current placement
    n_pods: int = 1
    gang_domains: Tuple[int, ...] = ()
    # fairness accounting tenant; "" bills the job to its own name
    tenant: str = ""
    # anti-thrash: policy evictions consumed / allowed.  A job at its
    # budget is pinned runnable — priority_preempt stops considering it
    # a victim (counted as ``evictions_suppressed`` in telemetry) — so a
    # low-priority job repeatedly evicted by arriving gangs still
    # finishes.  Failure preemptions do not consume budget.
    evictions: int = 0
    max_evictions: int = 3
    # fault-recovery budget (cluster.faults): fault-driven preemptions
    # consume retries with exponential backoff; past ``max_retries`` the
    # job fails permanently (state FAILED).  Legacy failure preemptions
    # (TraceConfig.failures) do not consume this budget.
    retries: int = 0
    max_retries: int = 3
    not_before_t: float = 0.0        # backoff gate: poll() skips until then
    fault_t: float = -1.0            # injection time of the pending fault
    #                                  (-1 = none); cleared at restart when
    #                                  the recovery-time sample is taken
    # live recomposition (cluster.recomposer) opt-in: only elastic jobs
    # may be attach-widened, shrunk-to-admit, or tranche-migrated
    # mid-run; the default keeps every legacy job frozen at admission
    elastic: bool = False

    @property
    def kind(self) -> str:
        return SHAPES[self.shape_name].kind

    @property
    def tenant_key(self) -> str:
        return self.tenant or self.name

    @property
    def dp_tp(self) -> Tuple[int, int]:
        assert self.plan is not None
        return self.plan.shape[-2], self.plan.shape[-1]

    @property
    def step_s(self) -> float:
        """Effective step time: the CalibratedCost-priced plan step plus
        the contended input stall of the job's storage tranche."""
        assert self.plan is not None
        return self.plan.step_s + self.input_stall_s

    @property
    def tranche(self) -> Optional[str]:
        return self.system.tranche if self.system is not None else None

    def remaining_steps(self) -> float:
        return max(0.0, self.steps - self.steps_done)

    def est_duration_s(self) -> float:
        return self.remaining_steps() * self.step_s

    def est_restore_s(self) -> float:
        """Checkpoint-restore cost a resumed job pays before stepping:
        the fp32 parameters read back over the composition's storage tier
        (NVMe-class estimate while queued, placement unknown)."""
        if self.steps_done <= 0:
            return 0.0
        from repro_torch.core.topology import LOCAL_NVME
        pbytes = get_config(self.arch).param_count() * 4.0
        if self.system is not None:
            return pbytes / self.system.fabric.storage.effective_read_bw(
                self.system.fabric.links)
        return pbytes / LOCAL_NVME.read_bw

    @property
    def est_end_t(self) -> float:
        # anchored at the last progress accrual, not start_t: remaining
        # steps shrink as steps_done grows, so start_t-anchoring would
        # drift the estimate earlier and earlier while the job runs
        return max(self.progress_t, self.start_t) + self.est_duration_s()


@dataclasses.dataclass
class ServeJob(Job):
    """One serving *replica*: a long-lived inference tenant.

    A logical service runs ``n_replicas`` of these, each leasing its own
    pool slice through the ordinary admission path (the shape cell —
    ``decode_32k`` by default — prices the replica analytically, and
    ``calibrate_candidate`` folds measured step times / tuned-kernel
    speedups in, so token throughput is CalibratedCost-priced).  Unlike a
    training job, a replica does not finish after ``steps`` — the
    simulator completes it when its service's request trace drains;
    ``steps`` only feeds the scheduler's EASY-backfill end-time estimate.
    """
    service: str = ""                # logical service this replica serves
    replica: int = 0
    ttft_slo_s: float = 2.0
    tpot_slo_s: float = 0.5
    prefill_chunk: int = 512         # chunked-prefill tokens per step

    @property
    def capacity(self) -> int:
        """Concurrent sequences in the decode batch."""
        return SHAPES[self.shape_name].global_batch

    def throughput(self) -> Dict[str, float]:
        """CalibratedCost-priced serving rates on the replica's actual
        placement (``plan.step_s`` is re-priced at start time)."""
        from repro_torch.core import costmodel
        return costmodel.serving_throughput(
            get_config(self.arch), SHAPES[self.shape_name], self.step_s)

    @property
    def tokens_per_s(self) -> float:
        return self.throughput()["tokens_per_s"]


# ---------------------------------------------------------------------------
# pluggable scheduling policies
# ---------------------------------------------------------------------------
class Policy:
    """Queue-ordering / preemption policy plugged into ``Scheduler``.

    ``order`` returns the queue in service order for this poll (the
    first element is the head the backfill reservation protects); it
    must be a pure, deterministic function of scheduler state.
    ``make_room`` may preempt running work to fit ``job`` and returns
    True iff it freed at least one device (the scheduler then
    re-evaluates the queue); the base policy never preempts.
    """

    name = "policy"

    def order(self, sched: "Scheduler", now: float) -> List[Job]:
        raise NotImplementedError

    def make_room(self, sched: "Scheduler", job: Job, now: float) -> bool:
        return False


class EasyPolicy(Policy):
    """Priority FIFO with EASY backfill — the original (PR 1) behavior,
    bit-for-bit: order by (-priority, submit time); never preempt."""

    name = "easy"

    def order(self, sched: "Scheduler", now: float) -> List[Job]:
        return sorted(sched.queue, key=lambda j: (-j.priority, j.submit_t))


class FairSharePolicy(Policy):
    """Per-tenant weighted deficit ordering.

    Each tenant accrues usage as device-seconds of running leases
    (``Scheduler.tenant_usage``); the queue is ordered by
    ``usage / weight`` ascending — the tenant that has consumed the
    least of its entitlement goes first — with (-priority, submit time)
    breaking ties, so a flooding tenant cannot starve light tenants the
    way plain FIFO does.  Unknown tenants weigh 1.0.
    """

    name = "fair_share"

    def __init__(self, tenant_weights: Optional[Mapping[str, float]] = None):
        self.weights = {k: float(v)
                        for k, v in dict(tenant_weights or {}).items()}

    def deficit(self, sched: "Scheduler", tenant: str) -> float:
        w = max(self.weights.get(tenant, 1.0), 1e-9)
        return sched.tenant_usage.get(tenant, 0.0) / w

    def order(self, sched: "Scheduler", now: float) -> List[Job]:
        sched._accrue_usage(now)
        return sorted(sched.queue,
                      key=lambda j: (self.deficit(sched, j.tenant_key),
                                     -j.priority, j.submit_t))


class PriorityPreemptPolicy(Policy):
    """EASY ordering plus policy preemption: when the head does not fit,
    strictly-lower-priority running jobs are shrunk (halve the data
    axis, when that alone covers the shortfall and the halved mesh is
    feasible) or evicted whole — lowest priority first, then youngest —
    through the ``train/elastic`` checkpoint-resume path.  Gangs are
    evicted atomically (no cross-pod shrink)."""

    name = "priority_preempt"

    def order(self, sched: "Scheduler", now: float) -> List[Job]:
        return sorted(sched.queue, key=lambda j: (-j.priority, j.submit_t))

    def make_room(self, sched: "Scheduler", job: Job, now: float) -> bool:
        """Preempt lower-priority work for ``job`` — but only when the
        candidate evictions can actually make it placeable.  Evicting
        victims for a head that stays blocked anyway (e.g. pinned by an
        equal-priority job) would let backfill restart the victim and
        the next poll iteration evict it again: a livelock at one
        simulated timestamp.

        Victims at their eviction budget (``Job.max_evictions``) are
        pinned runnable: excluded from candidacy (and counted in
        ``telemetry.jobs_evictions_suppressed``), so repeated arrivals
        cannot thrash one low-priority job forever."""
        candidates = [r for r in sched.running if r.priority < job.priority]
        pinned = sum(1 for r in candidates
                     if r.evictions >= r.max_evictions)
        if pinned:
            sched.telemetry.jobs_evictions_suppressed += pinned
        victims = sorted(
            (r for r in candidates if r.evictions < r.max_evictions),
            key=lambda r: (r.priority, -r.start_t, r.name))
        if not victims:
            return False
        if job.n_pods > 1:
            return self._make_room_for_gang(sched, job, victims, now)
        need = job.n_chips - len(sched.pool.available())
        if need <= 0:
            return False
        if need > sum(v.system.n_devices for v in victims
                      if v.system is not None):
            return False         # head cannot fit even if every victim goes
        acted = False
        for victim in victims:
            if need <= 0:
                break
            held = victim.system.n_devices if victim.system else 0
            freed = 0
            if need <= held // 2:
                freed = sched.preempt_to_shrink(victim, now)
            if freed == 0:
                freed = sched.evict(victim, now, for_job=job.name)
            need -= freed
            acted = acted or freed > 0
        return acted

    @staticmethod
    def _make_room_for_gang(sched: "Scheduler", job: Job,
                            victims: List[Job], now: float) -> bool:
        """Free whole member cliques for a gang head.

        A gang blocked by domain *fragmentation* can have enough free
        chips in total (raw shortfall <= 0) while no ``n_pods`` domains
        hold a full member each, so room is made per-domain: target the
        ``n_pods`` large-enough domains needing the fewest evictions and
        evict victims holding devices there until each member fits.
        Shrink is skipped — a recompose may relocate the victim's claim,
        so only eviction reliably frees chips in the chosen domain.
        """
        per_pod = job.n_chips // job.n_pods
        dom_of = {d.uid: d.domain for d in sched.pool.devices}
        healthy = domain_counts([d for d in sched.pool.devices if d.healthy])
        victim_in: Dict[int, int] = {}
        for v in victims:
            for u in (v.system.device_uids if v.system is not None else ()):
                victim_in[dom_of[u]] = victim_in.get(dom_of[u], 0) + 1

        def free_in(dom: int) -> int:
            return sum(1 for d in sched.pool.available()
                       if d.domain == dom)

        # a domain is a viable member host only if evicting every victim
        # there would actually complete a clique — otherwise the gang
        # stays blocked and the evictions just thrash (livelock guard)
        eligible = [dom for dom, cap in healthy.items()
                    if cap >= per_pod
                    and free_in(dom) + victim_in.get(dom, 0) >= per_pod]
        if len(eligible) < job.n_pods:
            return False
        targets = sorted(eligible,
                         key=lambda dom: (max(0, per_pod - free_in(dom)),
                                          dom))[:job.n_pods]
        acted = False
        for dom in targets:
            for victim in victims:
                if free_in(dom) >= per_pod:
                    break
                if victim.state != RUNNING or victim.system is None:
                    continue
                if not any(dom_of[u] == dom
                           for u in victim.system.device_uids):
                    continue
                freed = sched.evict(victim, now, for_job=job.name)
                acted = acted or freed > 0
        return acted


POLICIES = ("easy", "fair_share", "priority_preempt")


def make_policy(name: str,
                tenant_weights: Optional[Mapping[str, float]] = None
                ) -> Policy:
    """Policy factory used by ``Scheduler`` and ``TraceConfig``."""
    if name == "easy":
        return EasyPolicy()
    if name == "fair_share":
        return FairSharePolicy(tenant_weights)
    if name == "priority_preempt":
        return PriorityPreemptPolicy()
    raise ValueError(f"unknown policy {name!r}; known: {POLICIES}")


class Scheduler:
    """Policy-driven multi-tenant scheduler with elastic failure handling."""

    def __init__(self, pool: DevicePool, telemetry: Optional[Telemetry] = None,
                 backfill: bool = True, calibration=None,
                 storage: Optional[StoragePool] = None,
                 policy: "Policy | str" = "easy",
                 tenant_weights: Optional[Mapping[str, float]] = None):
        self.pool = pool
        self.telemetry = telemetry or Telemetry(len(pool.devices))
        self.backfill = backfill
        # measured-cost layer (core.costmodel.CalibratedCost): admission
        # and pricing use calibrated step times when measurements exist.
        # Only the calibration handed in is read: the reference's
        # process-wide fallback (``recommend.get_calibration()``) is not
        # ported, so the scheduler has no hidden input.
        self._calibration = calibration
        # storage tranches are first-class: every started job holds one
        # (admission-to-run requires the lease; see _start)
        self.storage = storage if storage is not None else \
            make_storage_pool(links=pool.links)
        self.manager = LeaseManager(pool, self.storage)
        self.queue: List[Job] = []
        self.running: List[Job] = []
        self.done: List[Job] = []
        self.rejected: List[Job] = []
        self.failed: List[Job] = []      # retry budget exhausted (terminal)
        # jobs whose contended input stall changed while running, keyed by
        # name with the stall value before the FIRST undrained change —
        # the simulator drains this to re-schedule completion events (the
        # old stall prices progress already made).  Keyed (not a list) so
        # it stays bounded by the running set even when nothing drains it;
        # entries are dropped when a job stops running.
        self.stall_dirty: Dict[str, Tuple[Job, float]] = {}
        # pluggable queue policy (see Policy subclasses above)
        self.policy = policy if isinstance(policy, Policy) \
            else make_policy(policy, tenant_weights)
        # fair-share bookkeeping: tenant -> device-seconds of running
        # leases, integrated lazily up to _usage_t
        self.tenant_usage: Dict[str, float] = {}
        self._usage_t = 0.0
        # jobs the policy shrank or evicted this poll, drained by the
        # simulator (mirrors stall_dirty) to fix rates/events
        self.policy_victims: List[Job] = []
        # optional hook the simulator installs so policy preemptions see
        # exact steps_done before checkpointing (lazy progress accrual)
        self.sync_progress: Optional[Callable[[Job, float], None]] = None

    @property
    def calibration(self):
        return self._calibration

    # ------------------------------------------------------------- admit --
    def _candidates_for(self, job: Job, n_chips: Optional[int] = None
                        ) -> List[recommend.Candidate]:
        cfg = get_config(job.arch)
        shape = SHAPES[job.shape_name]
        n = n_chips or job.n_chips
        # under a multi-tier topology, admission derates the collective
        # term for candidates that must span drawers (the flat fabric
        # passes no hint — the legacy admission path, bit-for-bit)
        topo_kw = {}
        if self.pool.topo.name != "single_switch":
            topo_kw = dict(
                topology=self.pool.topo,
                domain_chips=max(domain_counts(self.pool.devices).values(),
                                 default=0))
        if job.n_pods > 1:
            # gang admission: (dp, tp) factorizations of the per-pod
            # budget, with the pod axis's collective traffic priced on
            # the pool's actual DCN links (Candidate.wire_bytes["pod"])
            dcn_bw = self.pool.links[LinkClass.DCN].bandwidth
            return [recommend.calibrate_candidate(
                        recommend._estimate(cfg, shape, dp, tp,
                                            pods=job.n_pods, dcn_bw=dcn_bw,
                                            **topo_kw),
                        cfg, job.arch, job.shape_name, shape,
                        self.calibration)
                    for dp, tp in recommend.candidates(n // job.n_pods)]
        return [recommend.calibrate_candidate(
                    recommend._estimate(cfg, shape, dp, tp, **topo_kw),
                    cfg, job.arch, job.shape_name, shape, self.calibration)
                for dp, tp in recommend.candidates(n)]

    @staticmethod
    def _best(cands: List[recommend.Candidate]
              ) -> Optional[recommend.Candidate]:
        feasible = sorted((c for c in cands if c.feasible),
                          key=lambda c: c.step_s)
        return feasible[0] if feasible else None

    def plan_job(self, job: Job, n_chips: Optional[int] = None
                 ) -> Optional[recommend.Candidate]:
        """Best feasible (dp, tp) candidate at the given chip budget."""
        return self._best(self._candidates_for(job, n_chips))

    def _with_axis_paths(self, system: ComposedSystem, tp: int
                         ) -> ComposedSystem:
        """Re-derive the per-axis link class, hop count and bandwidth
        derate from the system's *actual* claim and fold them into its
        fabric — the spare devices of an elastic recompose may sit on a
        different fabric (or a more distant drawer) than the original
        selection.  A no-op when nothing changed."""
        links, hops, scale = path_maps(
            derive_axis_paths(self.pool, system.device_uids, tp))
        fab = system.fabric
        if (dict(fab.axis_links) != links or dict(fab.axis_hops) != hops
                or dict(fab.axis_bw_scale) != scale):
            system = dataclasses.replace(
                system, fabric=dataclasses.replace(
                    fab, axis_links=links, axis_hops=hops,
                    axis_bw_scale=scale))
        return system

    @staticmethod
    def _repriced(plan: recommend.Candidate, system: ComposedSystem
                  ) -> recommend.Candidate:
        """Re-price the collective term on the fabric the job actually got.

        The admission-time estimate assumes full-speed ICI on every axis;
        once placed, each axis's wire bytes are priced on the real path —
        derated link bandwidth plus one link latency per hop beyond the
        first (``FabricSpec.axis_time``; exactly ``nbytes / bandwidth``
        on the flat 1-hop fabric) — so a switch-, cascade- or
        DCN-spanning placement runs measurably slower, which is the
        paper's local-vs-falcon gap at cluster level.
        """
        coll = 0.0
        for axis, nbytes in plan.wire_bytes.items():
            if nbytes <= 0:
                continue
            if axis in system.fabric.axis_links:
                coll += system.fabric.axis_time(axis, nbytes)
            else:
                link, hops = system.fabric.slowest_path()
                coll += nbytes / link.bandwidth + (hops - 1) * link.latency
        terms = dict(plan.terms)
        terms["collective"] = coll
        step = max(terms.get("compute", 0.0), terms.get("memory", 0.0), coll)
        if "measured" in terms:
            # a measured cell step already includes compute+memory; only a
            # slower-than-assumed fabric can push it higher
            step = max(terms["measured"], coll)
        return dataclasses.replace(plan, step_s=step, terms=terms)

    def submit(self, job: Job, now: float = 0.0) -> bool:
        """Admission control; returns False (and records why) on rejection."""
        self.telemetry.jobs_submitted += 1
        job.submit_t = now
        job.queued_t = now
        if job.io is None:
            job.io = lm_io_workload(get_config(job.arch),
                                    SHAPES[job.shape_name])
        max_tranche = max((t.capacity_bytes
                           for t in self.storage.tranches.values()),
                          default=0.0)
        if job.n_chips > len(self.pool.devices):
            job.state = REJECTED
            job.why_rejected = (f"requests {job.n_chips} chips; pool has "
                                f"{len(self.pool.devices)}")
        elif job.n_pods > 1 and job.n_chips % job.n_pods:
            job.state = REJECTED
            job.why_rejected = (f"{job.n_chips} chips do not divide over "
                                f"{job.n_pods} gang pods")
        elif job.n_pods > 1 and (gang_why := self._gang_impossible(job)):
            # a gang that can never place (more pods than the pool has
            # domains, or a member clique larger than every domain) must
            # reject at submit instead of stranding at the queue head
            job.state = REJECTED
            job.why_rejected = gang_why
        elif self._storage_request(job) > max_tranche:
            # a dataset no tranche can EVER host must reject at submit,
            # not livelock at the head of the queue raising storage
            # conflicts on every poll
            job.state = REJECTED
            job.why_rejected = (
                f"dataset {self._storage_request(job) / 1e12:.2f} TB "
                f"exceeds every tranche (largest "
                f"{max_tranche / 1e12:.2f} TB)")
        else:
            cands = self._candidates_for(job)
            plan = self._best(cands)
            if plan is None:
                job.state = REJECTED
                job.why_rejected = ("no feasible (dp,tp) at "
                                    f"{job.n_chips} chips: "
                                    + "; ".join(c.why for c in cands[:3]))
            else:
                job.plan = plan
        if job.state == REJECTED:
            self.rejected.append(job)
            self.telemetry.jobs_rejected += 1
            self.telemetry.log(now, "reject", job.name, job.why_rejected)
            return False
        self.queue.append(job)
        self.telemetry.log(now, "submit", job.name,
                           f"{job.arch}/{job.shape_name} x{job.n_chips}")
        return True

    def _gang_impossible(self, job: Job) -> str:
        """Why a gang can never place on this pool ("" = it can): the
        static analogue of ``_fits_now``'s per-domain rule."""
        per_pod = job.n_chips // job.n_pods
        hosts = len(hosting_domains(self.pool.devices, per_pod))
        if hosts < job.n_pods:
            n_domains = len(domain_counts(self.pool.devices))
            return (f"gang needs {job.n_pods} domains of {per_pod} chips; "
                    f"only {hosts} of {n_domains} domains are large "
                    "enough")
        return ""

    # ------------------------------------------------------------- start --
    def _storage_request(self, job: Job) -> float:
        return job.io.dataset_bytes() if job.io is not None else 0.0

    def _start(self, job: Job, now: float) -> bool:
        dp, tp = job.dp_tp
        gang: Optional[GangPlan] = None
        try:
            if job.n_pods > 1:
                # all-or-nothing gang: co-select one pod-sized clique per
                # member domain, minimizing the DCN hop span; the whole
                # selection (every member + the tranche) is claimed in
                # one atomic compose() below
                gang = plan_gang(self.pool, job.n_pods, dp, tp)
                uids, paths = gang.uids, gang.axis_paths
                names: Tuple[str, ...] = ("pod", "data", "model")
                sizes: Tuple[int, ...] = (job.n_pods, dp, tp)
            else:
                plan = plan_placement(self.pool, dp, tp)
                uids, paths = plan.uids, plan.axis_paths
                names, sizes = ("data", "model"), (dp, tp)
            axis_links, axis_hops, axis_scale = path_maps(paths)
            # a composition is devices + storage: running requires an NVMe
            # tranche lease alongside the chip claim, placed local-first
            # (plan_tranche) and claimed atomically inside compose()
            domain = {d.uid: d.domain for d in self.pool.devices}[uids[0]]
            tranche = plan_tranche(
                self.storage, capacity_bytes=self._storage_request(job),
                prefer_domain=domain)
            job.system = compose(
                self.pool, job.name, names, sizes,
                axis_links, uids=uids,
                storage_pool=self.storage, tranche=tranche.name,
                storage_capacity=self._storage_request(job),
                axis_hops=axis_hops, axis_bw_scale=axis_scale)
        except CompositionError as e:
            # capacity was checked before calling; reaching here means a
            # genuine claim conflict — count it and leave the job queued
            self.manager.conflicts += 1
            self.telemetry.lease_conflicts += 1
            self.telemetry.log(now, "conflict", job.name, str(e))
            return False
        self.manager.adopt(job.system, now)
        job.plan = self._repriced(job.plan, job.system)
        job.state = RUNNING
        job.start_t = now
        job.progress_t = now
        job.gang_domains = gang.domains if gang is not None else ()
        job.run = elastic.ElasticRun(job.system, ckpt_dir="")
        self.running.append(job)
        st = self.telemetry.tranche_stats(tranche.name, tranche.attach.value)
        st.leases_granted += 1
        self.update_stalls()
        # wait = time spent in the queue since the last (re)queueing; run
        # time before a preemption is not wait
        self.telemetry.job_waited(now - job.queued_t, job.tenant_key)
        if job.fault_t >= 0.0:
            # recovery-time sample: fault injection -> back on devices,
            # including the checkpoint restore the restart is about to
            # pay (detect + decide + restore)
            self.telemetry.recovery_s.append(
                (now - job.fault_t) + self.restore_s(job))
            job.fault_t = -1.0
        detail = (f"mesh={'x'.join(str(s) for s in sizes)} links=" +
                  ",".join(f"{a}:{c.value}"
                           for a, c in job.system.fabric.axis_links.items()))
        detail += (f" tranche={tranche.name}"
                   f"({self.storage.n_lessees(tranche.name)} lessees)")
        if isinstance(job, ServeJob):
            detail += f" serve={job.tokens_per_s:.0f}tok/s"
        self.telemetry.log(now, "start", job.name, detail)
        if gang is not None:
            self.telemetry.gang_started(gang.dcn_hops)
            self.telemetry.log(
                now, "gang", job.name,
                f"start pods={job.n_pods} domains="
                + ",".join(str(d) for d in gang.domains)
                + f" span={gang.dcn_hops}")
        return True

    # ----------------------------------------------------- storage stalls --
    def stall_for(self, job: Job) -> float:
        """Contended per-step input stall of ``job`` on its tranche."""
        if (job.io is None or job.system is None
                or job.system.tranche is None):
            return 0.0
        model = StorageModel.for_tranche(self.storage, job.system.tranche)
        return workload_stall(job.io, model, job.plan.step_s)

    def update_stalls(self) -> List[Job]:
        """Re-derive every running job's input stall under the current
        tranche contention; jobs whose stall changed are queued on
        ``stall_dirty`` (drained by the simulator to re-schedule their
        completion events) and returned."""
        changed: List[Job] = []
        for job in self.running:
            stall = self.stall_for(job)
            if abs(stall - job.input_stall_s) > 1e-12:
                self.stall_dirty.setdefault(job.name,
                                            (job, job.input_stall_s))
                job.input_stall_s = stall
                changed.append(job)
        return changed

    def drain_stall_dirty(self) -> List[Tuple[Job, float]]:
        out = list(self.stall_dirty.values())
        self.stall_dirty.clear()
        return out

    def restore_s(self, job: Job) -> float:
        """Checkpoint-restore time on the job's *actual* storage.

        A resumed job reads its fp32 parameters back through the tranche
        it holds — at the tranche's **contended** per-lessee bandwidth
        (``StoragePool.read_bw``), not the uncontended tier rate
        ``Job.est_restore_s`` assumes: a restore on a shared drawer
        contends with its co-tenants' input streams exactly like the
        steady-state reads do.  Falls back to the job's own uncontended
        estimate while it holds no tranche (still queued).
        """
        if job.steps_done <= 0:
            return 0.0
        if job.system is not None and job.system.tranche is not None:
            pbytes = get_config(job.arch).param_count() * 4.0
            return pbytes / self.storage.read_bw(job.system.tranche)
        return job.est_restore_s()

    def est_restore_for(self, job: Job) -> float:
        """Policy-aware restore estimate for a job being *considered*
        (the backfill guard's view).

        A queued preempted job holds no tranche, but the tranche a
        restart would lease is knowable — ``plan_tranche`` is the same
        deterministic selection ``_start`` will make — and the restore
        read contends with that tranche's existing lessees *plus the
        restarting job itself*.  ``Job.est_restore_s``'s uncontended
        tier rate under-prices exactly when the pool's tranches are
        shared, letting backfill start restores that overrun the head
        job's reservation.  Falls back to the job's own estimate when
        no tranche currently fits (admission will conflict anyway).
        """
        if job.steps_done <= 0:
            return 0.0
        if job.system is not None and job.system.tranche is not None:
            return self.restore_s(job)
        try:
            tranche = plan_tranche(
                self.storage, capacity_bytes=self._storage_request(job))
        except CompositionError:
            return job.est_restore_s()
        pbytes = get_config(job.arch).param_count() * 4.0
        bw = tranche.effective_read_bw(
            self.storage.links, self.storage.n_lessees(tranche.name) + 1)
        return pbytes / bw

    # ---------------------------------------------------------- fairness --
    def _accrue_usage(self, now: float) -> None:
        """Integrate running device-seconds per tenant up to ``now`` —
        the fair-share deficit input.  Lazy and idempotent (dt = 0 on
        repeated calls at one event time)."""
        dt = now - self._usage_t
        if dt > 0:
            for job in self.running:
                if job.system is not None:
                    key = job.tenant_key
                    self.tenant_usage[key] = (
                        self.tenant_usage.get(key, 0.0)
                        + dt * job.system.n_devices)
        self._usage_t = max(self._usage_t, now)

    # ---------------------------------------------------------- schedule --
    @staticmethod
    def _fits_now(job: Job, free: List[Device]) -> bool:
        """Can ``job`` be placed from the ``free`` devices right now?
        Plain jobs fit by count; a gang additionally needs ``n_pods``
        distinct domains with a full member clique free in each (mirrors
        ``plan_gang``'s eligibility rule, without planning)."""
        if job.n_pods <= 1:
            return job.n_chips <= len(free)
        per_pod = job.n_chips // job.n_pods
        return len(hosting_domains(free, per_pod)) >= job.n_pods

    def _reservation_t(self, need: int, now: float) -> float:
        """Earliest time ``need`` devices can be free, from running jobs'
        analytic end-time estimates (EASY reservation for the head job)."""
        free = len(self.pool.available())
        if free >= need:
            return now
        for job in sorted(self.running, key=lambda j: j.est_end_t):
            free += job.system.n_devices if job.system else 0
            if free >= need:
                return max(now, job.est_end_t)
        return float("inf")

    def poll(self, now: float) -> List[Job]:
        """Start every job the policy admits right now; returns them."""
        started: List[Job] = []
        self._accrue_usage(now)
        while True:
            order = self.policy.order(self, now)
            # backoff gate (cluster.faults): a retrying job is invisible to
            # this poll until its not_before_t — it neither starts nor
            # holds the head reservation.  0.0 (the default) always passes,
            # so legacy traces order identically.
            order = [j for j in order if j.not_before_t <= now]
            if not order:
                break
            head = order[0]
            free = self.pool.available()
            picked: Optional[Job] = None
            if self._fits_now(head, free):
                picked = head
            else:
                if self.policy.make_room(self, head, now):
                    continue    # devices were freed: re-evaluate the queue
                if self.backfill:
                    reserve_t = self._reservation_t(head.n_chips, now)
                    for job in order[1:]:
                        # restore priced policy-aware (est_restore_for):
                        # a backfilled restart reads its checkpoint at the
                        # contended bandwidth of the tranche it will
                        # actually lease, not the uncontended tier rate
                        if (self._fits_now(job, free)
                                and now + self.est_restore_for(job)
                                + job.est_duration_s() <= reserve_t):
                            picked = job
                            break
            if picked is None or not self._start(picked, now):
                break
            self.queue.remove(picked)
            started.append(picked)
        return started

    def drain_policy_victims(self) -> List[Job]:
        """Jobs the policy shrank or evicted since the last drain (the
        simulator re-prices their traffic rates and completion events)."""
        out = list(self.policy_victims)
        self.policy_victims.clear()
        return out

    # ---------------------------------------------------------- complete --
    def on_complete(self, job: Job, now: float) -> None:
        assert job.state == RUNNING
        self._accrue_usage(now)
        job.steps_done = job.steps
        job.state = DONE
        job.end_t = now
        if job.n_pods > 1:
            self.telemetry.log(now, "gang", job.name, "stop")
        self.running.remove(job)
        self.done.append(job)
        release(self.pool, job.system)
        self.manager.release(job.name)       # devices + storage tranche
        self.stall_dirty.pop(job.name, None)
        self.update_stalls()                 # co-tenants speed back up
        self.telemetry.jobs_completed += 1
        self.telemetry.log(now, "complete", job.name,
                           f"ran {now - job.start_t:.1f}s")

    def complete_queued(self, job: Job, now: float, why: str = "") -> None:
        """Complete a job straight from the queue (it holds no devices) —
        e.g. a preempted serve replica whose service drained before it
        could restart.  Keeps the bookkeeping identical to on_complete."""
        assert job.state == QUEUED
        self.queue.remove(job)
        job.steps_done = job.steps
        job.state = DONE
        job.end_t = now
        self.done.append(job)
        self.telemetry.jobs_completed += 1
        self.telemetry.log(now, "complete", job.name,
                           why or "completed from queue")

    # ----------------------------------------------------------- failure --
    def on_failure(self, failed_uids: Sequence[int], now: float
                   ) -> List[Job]:
        """Handle device failures; returns every job that was recomposed
        or preempted (the caller must re-estimate completion times)."""
        self._accrue_usage(now)
        self.pool.mark_failed(failed_uids)
        self.telemetry.log(now, "fail", "",
                           f"{len(failed_uids)} device(s) down")
        failed = set(failed_uids)
        changed: List[Job] = []
        for job in list(self.running):
            hit = failed & set(job.system.device_uids)
            if not hit:
                continue
            if job.n_pods > 1:
                # a gang is all-or-nothing at runtime too: losing any
                # member device preempts the whole gang (a cross-pod
                # shrink would break the pod-symmetric mesh)
                self._preempt(job, now)
                changed.append(job)
                continue
            old_shape = job.system.axis_sizes
            try:
                new_sys = elastic.handle_failure(
                    job.run, self.pool, sorted(hit),
                    step=int(job.steps_done), shrink_axis="data")
            except CompositionError:
                self._preempt(job, now)
                changed.append(job)
                continue
            if new_sys.axis_sizes != old_shape:
                dp, tp = new_sys.axis_sizes[-2], new_sys.axis_sizes[-1]
                cfg = get_config(job.arch)
                new_plan = recommend.calibrate_candidate(
                    recommend._estimate(cfg, SHAPES[job.shape_name], dp, tp),
                    cfg, job.arch, job.shape_name,
                    SHAPES[job.shape_name], self.calibration)
                if not new_plan.feasible:
                    # fits the pool by count but not by memory (e.g. the
                    # halved mesh can't hold the optimizer shards): the
                    # job cannot run in this shape — give everything back
                    job.run.system = new_sys
                    self._preempt(job, now)
                    changed.append(job)
                    continue
                job.plan = new_plan
            # the spare devices may sit on a different fabric than the
            # original claim: re-derive the per-axis paths so pricing
            # and traffic attribution follow the actual hardware
            new_sys = self._with_axis_paths(new_sys, new_sys.axis_sizes[-1])
            job.system = new_sys
            job.run.system = new_sys
            job.plan = self._repriced(job.plan, new_sys)
            self.manager.forget(job.name)
            self.manager.adopt(new_sys, now)
            job.recompositions += 1
            job.epoch += 1               # invalidates scheduled completions
            changed.append(job)
            self.telemetry.log(
                now, "recompose", job.name,
                f"{old_shape}->{new_sys.axis_sizes} after {len(hit)} loss")
        self.update_stalls()         # shrunk meshes re-derive their stalls
        return changed

    def _preempt(self, job: Job, now: float,
                 why: str = "pool too small; requeued") -> None:
        """Release everything and requeue the job (failure shrink
        impossible, or a policy eviction — ``why`` says which)."""
        self._accrue_usage(now)
        if job.n_pods > 1:
            self.telemetry.log(now, "gang", job.name, "stop (preempted)")
        elastic.preempt(job.run, self.pool, step=int(job.steps_done))
        self.manager.release(job.name)       # devices + storage tranche
        self.running.remove(job)
        job.system = None
        job.run = None
        job.state = QUEUED
        job.epoch += 1
        job.gang_domains = ()
        job.input_stall_s = 0.0
        self.stall_dirty.pop(job.name, None)
        self.update_stalls()
        # resume from last "checkpointed" step boundary, re-planned at the
        # original budget (a stale shrunken plan would desync poll()'s
        # n_chips gate from the mesh _start() actually composes)
        job.steps_done = float(int(job.steps_done))
        job.plan = self.plan_job(job) or job.plan
        job.queued_t = now
        self.queue.append(job)
        self.telemetry.jobs_preempted += 1
        self.telemetry.log(now, "preempt", job.name, why)

    # ------------------------------------------------- fault recovery -----
    def apply_retry_budget(self, job: Job, now: float, *,
                           base_backoff_s: float = 5.0) -> bool:
        """Charge one fault-driven restart against ``job``'s retry budget.

        Called by the fault plane after a fault preempted ``job`` back to
        the queue.  Within budget the job gets an exponential-backoff
        gate (``not_before_t = now + base * 2^(retries-1)``) and a
        ``retry`` event; past ``max_retries`` it fails permanently.
        Returns True iff the job is still retryable.
        """
        if job.state != QUEUED:
            return True
        job.retries += 1
        if job.retries > job.max_retries:
            self.fail_permanently(
                job, now, f"retry budget exhausted "
                f"({job.max_retries} fault restarts)")
            return False
        backoff = base_backoff_s * (2.0 ** (job.retries - 1))
        job.not_before_t = now + backoff
        self.telemetry.retries_scheduled += 1
        self.telemetry.log(now, "retry", job.name,
                           f"attempt {job.retries}/{job.max_retries} "
                           f"backoff {backoff:.1f}s")
        return True

    def fail_permanently(self, job: Job, now: float, why: str) -> None:
        """Terminal fault failure: the job leaves the queue for good."""
        assert job.state == QUEUED
        self.queue.remove(job)
        job.state = FAILED
        job.end_t = now
        job.why_rejected = why
        job.fault_t = -1.0
        self.failed.append(job)
        self.telemetry.jobs_failed += 1
        self.telemetry.log(now, "fail", job.name, why)

    def regrow_shrunk(self, now: float) -> List[Job]:
        """Grow failure-shrunk jobs back toward their submitted budget.

        Called by the fault plane after a repair returns capacity (the
        ``train.elastic`` regrow path); legacy traces never call this,
        so repaired devices keep their PR-1 sit-idle-until-leased
        behavior bit-for-bit.  Returns the regrown jobs (the simulator
        re-prices their rates and completion events).
        """
        regrown: List[Job] = []
        for job in list(self.running):
            if job.n_pods > 1 or job.system is None:
                continue
            if job.system.n_devices >= job.n_chips:
                continue
            if (len(self.pool.available())
                    < job.n_chips - job.system.n_devices):
                continue
            plan = self.plan_job(job)        # at the original budget
            if plan is None:
                continue
            dp, tp = plan.shape[-2], plan.shape[-1]
            if self.sync_progress is not None:
                self.sync_progress(job, now)
            self._accrue_usage(now)
            old_shape = job.system.axis_sizes
            try:
                new_sys = recompose(self.pool, job.system,
                                    axis_sizes=(dp, tp))
            except CompositionError:
                continue             # recompose restored the old claim
            new_sys = self._with_axis_paths(new_sys, tp)
            job.system = new_sys
            if job.run is not None:
                elastic.regrow(job.run, new_sys, step=int(job.steps_done))
            job.plan = self._repriced(plan, new_sys)
            self.manager.forget(job.name)
            self.manager.adopt(new_sys, now)
            job.steps_done = float(int(job.steps_done))
            job.recompositions += 1
            job.epoch += 1           # invalidates scheduled completions
            self.telemetry.log(now, "recompose", job.name,
                               f"{old_shape}->{new_sys.axis_sizes} "
                               "(regrow after repair)")
            self.policy_victims.append(job)
            regrown.append(job)
        if regrown:
            self.update_stalls()
        return regrown

    # --------------------------------------------- live recomposition -----
    def _recompose_placed(self, system: ComposedSystem, dp: int, tp: int
                          ) -> ComposedSystem:
        """``core.compose.recompose`` with hop-aware selection: the old
        claim is released into the candidate set and the new mesh is
        chosen by ``plan_placement``'s clique-major, hop-sorted rule —
        so a live attach never picks a far drawer over an idle
        same-domain chip the way the default domain-major re-lease can.
        Atomic like ``acquire_gang``: any failure restores the old
        claim exactly and re-raises ``CompositionError``."""
        old = [u for u in system.device_uids
               if self.pool.leases.get(u) == system.name]
        self.pool.release(old)
        try:
            plan = plan_placement(self.pool, dp, tp)
            links, hops, scale = path_maps(plan.axis_paths)
            return compose(self.pool, system.name, system.axis_names,
                           (dp, tp), links, system.fabric.storage,
                           uids=plan.uids, tranche=system.tranche,
                           axis_hops=hops, axis_bw_scale=scale)
        except CompositionError:
            present = {d.uid for d in self.pool.devices}
            self.pool.lease([u for u in old if u in present], system.name)
            raise

    def attach_job(self, job: Job, now: float) -> bool:
        """Live-attach idle devices to one running elastic job below its
        submitted width — ``regrow_shrunk`` generalized beyond fault
        repair (the Recomposer's widen action), with the replacement
        mesh selected hop-aware (``_recompose_placed``).  Returns True
        iff the job was widened; the caller drains ``policy_victims``
        to re-price its traffic rates and completion event."""
        if job.n_pods > 1 or job.system is None:
            return False
        if job.system.n_devices >= job.n_chips:
            return False
        if (len(self.pool.available())
                < job.n_chips - job.system.n_devices):
            return False
        plan = self.plan_job(job)            # at the original budget
        if plan is None:
            return False
        dp, tp = plan.shape[-2], plan.shape[-1]
        if self.sync_progress is not None:
            self.sync_progress(job, now)
        self._accrue_usage(now)
        old_shape = job.system.axis_sizes
        old_n = job.system.n_devices
        try:
            new_sys = self._recompose_placed(job.system, dp, tp)
        except CompositionError:
            return False             # old claim restored; nothing changed
        new_sys = self._with_axis_paths(new_sys, tp)
        job.system = new_sys
        if job.run is not None:
            elastic.regrow(job.run, new_sys, step=int(job.steps_done))
        job.plan = self._repriced(plan, new_sys)
        self.manager.forget(job.name)
        self.manager.adopt(new_sys, now)
        job.steps_done = float(int(job.steps_done))
        job.recompositions += 1
        job.epoch += 1               # invalidates scheduled completions
        self.telemetry.attaches += 1
        self.telemetry.devices_recomposed += new_sys.n_devices - old_n
        self.telemetry.log(now, "attach", job.name,
                           f"{old_shape}->{new_sys.axis_sizes} "
                           f"(+{new_sys.n_devices - old_n} devices)")
        self.policy_victims.append(job)
        self.update_stalls()
        return True

    def detach_job(self, job: Job, now: float) -> int:
        """Live-detach half a running elastic job's data axis so queued
        work can admit sooner (the Recomposer's shrink-to-admit action).
        Same mechanics as ``preempt_to_shrink`` but attributed to the
        recomposition plane; returns the devices freed (0 when the job
        cannot shrink)."""
        if job.n_pods > 1 or job.system is None:
            return 0
        dp, tp = job.dp_tp
        if dp < 2:
            return 0
        cfg = get_config(job.arch)
        new_plan = recommend.calibrate_candidate(
            recommend._estimate(cfg, SHAPES[job.shape_name], dp // 2, tp),
            cfg, job.arch, job.shape_name, SHAPES[job.shape_name],
            self.calibration)
        if not new_plan.feasible:
            return 0
        if self.sync_progress is not None:
            self.sync_progress(job, now)
        self._accrue_usage(now)
        old_n = job.system.n_devices
        old_shape = job.system.axis_sizes
        try:
            new_sys = recompose(self.pool, job.system,
                                axis_sizes=(dp // 2, tp))
        except CompositionError:
            return 0                 # recompose restored the old claim
        new_sys = self._with_axis_paths(new_sys, tp)
        job.system = new_sys
        if job.run is not None:
            job.run.system = new_sys
        job.plan = self._repriced(new_plan, new_sys)
        self.manager.forget(job.name)
        self.manager.adopt(new_sys, now)
        job.steps_done = float(int(job.steps_done))
        job.recompositions += 1
        job.epoch += 1               # invalidates scheduled completions
        freed = old_n - new_sys.n_devices
        self.telemetry.detaches += 1
        self.telemetry.devices_recomposed += freed
        self.telemetry.log(now, "detach", job.name,
                           f"{old_shape}->{new_sys.axis_sizes} "
                           f"(shrink-to-admit, -{freed} devices)")
        self.policy_victims.append(job)
        self.update_stalls()
        return freed

    def migrate_tranche(self, job: Job, now: float, target: str) -> bool:
        """Move a running job's storage lease to ``target`` (the
        Recomposer's tranche-migrate action).  Attach-then-detach so a
        conflict on the target leaves the old lease untouched (atomic);
        the composable switch re-attaches the same drawer over a
        different path, so no data copy is modeled — the cost (and the
        gain) shows up as the re-derived contended stalls on both
        tranches (``update_stalls`` -> ``stall_dirty``)."""
        if job.system is None or job.system.tranche is None:
            return False
        old = job.system.tranche
        if target == old:
            return False
        try:
            self.storage.lease(target, job.name,
                               capacity_bytes=self._storage_request(job))
        except CompositionError:
            return False             # target full/exclusive: no change
        self.storage.release_tranche(job.name, old)
        tr = self.storage.tranches[target]
        self._accrue_usage(now)
        job.system = dataclasses.replace(
            job.system, tranche=target,
            fabric=dataclasses.replace(job.system.fabric,
                                       storage=tr.spec()))
        if job.run is not None:
            job.run.system = job.system
        st = self.telemetry.tranche_stats(target, tr.attach.value)
        st.leases_granted += 1
        self.telemetry.migrations += 1
        self.telemetry.log(now, "migrate", job.name,
                           f"{old}->{target} "
                           f"({self.storage.n_lessees(target)} lessees)")
        self.update_stalls()
        return True

    # ------------------------------------------------- policy preemption --
    def evict(self, job: Job, now: float, for_job: str = "") -> int:
        """Policy-driven full preemption of a running job (the
        ``priority_preempt`` eviction path).  The victim checkpoints at
        the last integer step, releases devices + tranche, and requeues;
        returns the number of devices freed."""
        if self.sync_progress is not None:
            self.sync_progress(job, now)
        freed = job.system.n_devices if job.system is not None else 0
        why = f"preempted for {for_job or 'higher priority'}"
        self._preempt(job, now, why=why)
        job.evictions += 1
        self.telemetry.jobs_evicted += 1
        self.telemetry.log(now, "evict", job.name, why)
        self.policy_victims.append(job)
        return freed

    def preempt_to_shrink(self, job: Job, now: float) -> int:
        """Halve a running victim's data axis in place, freeing half its
        devices for a higher-priority job; returns the devices freed (0
        when the victim cannot shrink: gangs, dp == 1, infeasible halved
        mesh, or a recompose conflict)."""
        if job.n_pods > 1 or job.system is None:
            return 0
        dp, tp = job.dp_tp
        if dp < 2:
            return 0
        cfg = get_config(job.arch)
        new_plan = recommend.calibrate_candidate(
            recommend._estimate(cfg, SHAPES[job.shape_name], dp // 2, tp),
            cfg, job.arch, job.shape_name, SHAPES[job.shape_name],
            self.calibration)
        if not new_plan.feasible:
            return 0
        if self.sync_progress is not None:
            self.sync_progress(job, now)
        self._accrue_usage(now)
        old_n = job.system.n_devices
        old_shape = job.system.axis_sizes
        try:
            new_sys = recompose(self.pool, job.system,
                                axis_sizes=(dp // 2, tp))
        except CompositionError:
            return 0                 # recompose restored the old claim
        new_sys = self._with_axis_paths(new_sys, tp)
        job.system = new_sys
        if job.run is not None:
            job.run.system = new_sys
        job.plan = self._repriced(new_plan, new_sys)
        self.manager.forget(job.name)
        self.manager.adopt(new_sys, now)
        # resume from the checkpoint boundary in the halved shape
        job.steps_done = float(int(job.steps_done))
        job.recompositions += 1
        job.epoch += 1               # invalidates scheduled completions
        self.telemetry.jobs_shrunk += 1
        self.telemetry.log(now, "shrink", job.name,
                           f"{old_shape}->{new_sys.axis_sizes} "
                           "(policy preempt-to-shrink)")
        self.policy_victims.append(job)
        self.update_stalls()
        return old_n - new_sys.n_devices

    # ----------------------------------------------------------- queries --
    def busy_equiv(self) -> float:
        """Device-equivalents doing useful compute right now (for AUU)."""
        total = 0.0
        for job in self.running:
            t = job.plan.terms
            # cap at 1: a measured step faster than the analytic compute
            # bound means the chips are saturated, not >100% busy
            frac = min(1.0, t.get("compute", 0.0) / max(job.step_s, 1e-30))
            total += job.system.n_devices * frac
        return total

    def all_done(self) -> bool:
        return not self.queue and not self.running
