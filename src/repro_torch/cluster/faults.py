"""Deterministic fault-injection plane for the cluster simulator, held
against ``repro/cluster/faults.py``.

The paper's composable-infrastructure pitch is that resources attach and
detach dynamically — which means the fabric can also do it *to* you: a
PCIe switch drops a drawer, a link flaps, an NVMe tranche browns out.
Takano & Suzaki's disaggregated-accelerator letter makes failure handling
of pooled accelerators a first-class concern; this module gives the
simulator the correlated fault modes and the recovery machinery the
legacy ``TraceConfig.failures`` knob (whole-device, scripted, instant
detection) cannot express.

Fault kinds (``FaultSpec.kind``):

  * ``device_down``      — ``n`` random healthy chips fail at ``t``
                           (repaired at ``t_clear``; inf = never);
  * ``device_flaky``     — the same chips flap down/up ``flaps`` times,
                           one cycle every ``period_s``;
  * ``link_degrade``     — one link class keeps ``frac`` of its
                           bandwidth: running jobs are *repriced* through
                           the incremental rate accumulators and keep
                           running at the degraded step time (graceful
                           degradation, no eviction);
  * ``domain_outage``    — every chip behind one locality domain (the
                           composable-infra failure unit: a drawer / one
                           side of the switch) goes down at once;
  * ``pod_loss``         — alias of ``domain_outage`` aimed at gangs: the
                           scheduler preempts any gang with a member in
                           the domain whole (all-or-nothing at runtime);
  * ``tranche_brownout`` — an NVMe tranche keeps ``frac`` of its
                           bandwidth; tenants keep running with their
                           stalls re-derived (``update_stalls``);
  * ``tranche_fail``     — the tranche is lost: holders are preempted to
                           restart on other storage, and ``plan_tranche``
                           stops offering it until ``t_clear``.

Detection-latency model: a fault happens at ``t`` but the control plane
reacts at ``t + detect_s``.  In the window the victims are *hung* — they
make no progress (their ``progress_t`` is pushed past the window so the
lazy accrual adds nothing) and move no bytes — so recovery time is
``detect + decide + restore``, sampled into ``telemetry.recovery_s``
when the victim is back on devices.

Recovery side:

  * **retry budgets** — every fault-driven preemption charges the
    victim's ``Job.retries`` with exponential backoff
    (``Scheduler.apply_retry_budget``); past ``max_retries`` the job
    fails permanently (terminal state FAILED — a new outcome in
    scheduler/telemetry).  Legacy ``TraceConfig.failures`` preemptions
    never consume the budget.
  * **graceful degradation** — ``link_degrade`` / ``tranche_brownout``
    re-price instead of evict.
  * **regrow** — after a repair returns capacity, failure-shrunk jobs
    recompose back toward their submitted budget
    (``Scheduler.regrow_shrunk`` -> ``train.elastic.regrow``).
  * **graceful drain** — a fault with ``notice_s > 0`` announces itself:
    serve replicas on the doomed devices stop admitting new requests and
    finish their in-flight work before the hit.

Schedules are scripted (``FaultPlan.faults``) or MTBF-seeded from the
trace rng (``FaultPlan.mtbf_s``).  All fault draws are consumed AFTER
every existing trace draw (batch arrivals, legacy failures, services),
so legacy traces — and any ``TraceConfig`` with ``faults=None`` — stay
bit-identical.

Invariants:

  * ``FaultPlan()`` (empty) is behaviorally identical to ``faults=None``:
    no events, no rng draws, bit-identical ``report()``.
  * Faults never touch the rng unless they fire (victim sampling happens
    at event time, after the trace is fully generated).
  * A cleared fault restores exactly what it took: link bandwidths and
    tranche specs return to their pre-fault values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.scheduler import QUEUED, RUNNING, ServeJob
from repro_torch.core.topology import LinkClass, LinkSpec

FAULT_KINDS = ("device_down", "device_flaky", "link_degrade",
               "domain_outage", "pod_loss", "tranche_brownout",
               "tranche_fail")

# kinds that take chips down (the scheduler's on_failure path)
_DEVICE_KINDS = ("device_down", "device_flaky", "domain_outage", "pod_loss")

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault.  Unused fields are ignored per kind."""
    kind: str
    t: float                            # injection time (simulated s)
    n: int = 1                          # chips (device_down / device_flaky)
    domain: int = 0                     # target (domain_outage / pod_loss)
    link: str = "switch"                # LinkClass value (link_degrade)
    frac: float = 0.5                   # surviving bandwidth fraction
    tranche: str = ""                   # target (tranche_* kinds)
    t_clear: float = _INF               # when the fault clears (inf = never)
    flaps: int = 3                      # device_flaky down/up cycles
    period_s: float = 60.0              # device_flaky cycle period
    detect_s: float = 1.0               # detection latency
    notice_s: float = 0.0               # planned-detach drain notice

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The trace's fault schedule + recovery knobs.

    ``faults`` is the scripted part; ``mtbf_s > 0`` additionally draws a
    Poisson schedule of ``device_down`` faults (mean time between
    failures ``mtbf_s``, repaired after ``mttr_s``) over ``horizon_s``
    from the trace rng — consumed after all existing draws.
    """
    faults: Tuple[FaultSpec, ...] = ()
    mtbf_s: float = 0.0
    mttr_s: float = 120.0
    horizon_s: float = 0.0
    mtbf_n: int = 1                     # chips per MTBF-drawn fault
    detect_s: float = 1.0               # detection latency for MTBF faults
    # recovery knobs
    retry_backoff_s: float = 5.0        # base of the exponential backoff
    max_retries: Optional[int] = None   # override Job.max_retries when set
    regrow: bool = True                 # regrow shrunk jobs after repair

    def schedule(self, rng) -> Tuple[FaultSpec, ...]:
        """Scripted faults + the MTBF draw (in injection order)."""
        out = list(self.faults)
        if self.mtbf_s > 0 and self.horizon_s > 0:
            t = 0.0
            while True:
                t += rng.expovariate(1.0 / self.mtbf_s)
                if t >= self.horizon_s:
                    break
                out.append(FaultSpec(
                    "device_down", t, n=self.mtbf_n,
                    t_clear=t + self.mttr_s, detect_s=self.detect_s))
        return tuple(sorted(out, key=lambda f: (f.t, f.kind, f.domain)))


class FaultInjector:
    """Applies a ``FaultPlan`` to a running ``ClusterSimulator``.

    The simulator owns the event loop; this object owns the fault
    semantics.  Event payloads are ``(spec, uids, flaps_left)`` tuples —
    ``uids`` is None until victims are sampled at injection time, so the
    rng is only consumed by faults that actually fire.
    """

    def __init__(self, sim, plan: FaultPlan):
        self.sim = sim
        self.plan = plan
        self._orig_links: Dict[LinkClass, LinkSpec] = {}
        self._orig_tranches: Dict[str, object] = {}

    # ----------------------------------------------------------- schedule --
    def push_schedule(self) -> None:
        """Queue every fault (and drain notice) onto the event heap.
        Called from ``_gen_trace`` after all legacy draws."""
        for spec in self.plan.schedule(self.sim.rng):
            if spec.notice_s > 0:
                self.sim._push(max(0.0, spec.t - spec.notice_s),
                               "drain", spec)
            self.sim._push(spec.t, "fault", (spec, None, spec.flaps))

    # ------------------------------------------------------------- inject --
    def on_fault(self, payload, now: float) -> None:
        spec, uids, flaps_left = payload
        tel = self.sim.telemetry
        tel.faults_injected += 1
        if spec.kind in _DEVICE_KINDS:
            uids = list(uids) if uids is not None \
                else self._device_victims(spec)
            tel.log(now, "fault", "",
                    f"{spec.kind}: {len(uids)} device(s) "
                    f"(detect in {spec.detect_s:.1f}s)")
            if uids:
                self._hang_devices(spec, uids, now)
                self.sim._push(now + spec.detect_s, "detect",
                               (spec, tuple(uids)))
                t_clear = self._clear_time(spec, now)
                if t_clear < _INF:
                    self.sim._push(t_clear, "fault_clear",
                                   (spec, tuple(uids), flaps_left))
        elif spec.kind == "link_degrade":
            cls = LinkClass(spec.link)
            self._scale_link(cls, spec.frac)
            tel.log(now, "fault", "",
                    f"link_degrade: {cls.value} at {spec.frac:.0%} bandwidth")
            self._reprice_running(now)
            self.sim._push(now + spec.detect_s, "detect", (spec, None))
            if spec.t_clear < _INF:
                self.sim._push(spec.t_clear, "fault_clear",
                               (spec, None, flaps_left))
        elif spec.kind == "tranche_brownout":
            name = self._tranche_name(spec)
            if name is not None:
                self._scale_tranche(name, spec.frac)
                tel.log(now, "fault", "",
                        f"tranche_brownout: {name} at {spec.frac:.0%} "
                        "bandwidth")
                self._reprice_stalls(now)
                self.sim._push(now + spec.detect_s, "detect", (spec, None))
                if spec.t_clear < _INF:
                    self.sim._push(spec.t_clear, "fault_clear",
                                   (spec, None, flaps_left))
        elif spec.kind == "tranche_fail":
            name = self._tranche_name(spec)
            if name is not None:
                tel.log(now, "fault", "",
                        f"tranche_fail: {name} lost "
                        f"(detect in {spec.detect_s:.1f}s)")
                self._hang_tranche(name, now, spec)
                self.sim._push(now + spec.detect_s, "detect",
                               (spec, (name,)))
                if spec.t_clear < _INF:
                    self.sim._push(spec.t_clear, "fault_clear",
                                   (spec, (name,), flaps_left))

    # ------------------------------------------------------------- detect --
    def on_detect(self, payload, now: float) -> None:
        spec, target = payload
        sim, tel = self.sim, self.sim.telemetry
        tel.faults_detect_s.append(spec.detect_s)
        if spec.kind in _DEVICE_KINDS:
            tel.log(now, "detect", "",
                    f"{spec.kind}: {len(target)} device(s) confirmed down")
            changed = sim.scheduler.on_failure(list(target), now)
            self._recover(changed, spec, now)
        elif spec.kind == "tranche_fail":
            name = target[0]
            tel.log(now, "detect", "", f"tranche_fail: {name} confirmed")
            changed = self._evacuate_tranche(name, now)
            self._recover(changed, spec, now)
        else:
            # degradations need no scheduler action — the detect event
            # just closes the timeline (monitoring noticed the slowdown)
            tel.log(now, "detect", "", f"{spec.kind} observed")

    def _recover(self, changed, spec: FaultSpec, now: float) -> None:
        """Post-detection recovery: re-price survivors, charge retry
        budgets of the preempted, schedule their backoff wakeups."""
        sim = self.sim
        for job in changed:
            sim._reschedule_victim(job, now)
            if job.state == RUNNING:
                # shrunk in place: it is already recovered — sample the
                # fault->recompose time (the restore overhead was just
                # added by _reschedule_victim's completion pricing)
                if job.fault_t >= 0.0:
                    sim.telemetry.recovery_s.append(
                        (now - job.fault_t)
                        + sim.scheduler.restore_s(job))
                    job.fault_t = -1.0
            elif job.state == QUEUED:
                if job.fault_t < 0.0:
                    job.fault_t = spec.t
                if self.plan.max_retries is not None:
                    job.max_retries = self.plan.max_retries
                if sim.scheduler.apply_retry_budget(
                        job, now,
                        base_backoff_s=self.plan.retry_backoff_s):
                    # wake the queue when the backoff gate opens
                    sim._push(job.not_before_t, "poll", None)
        sim._resync_stalls(now, exclude={j.name for j in changed})
        sim._start_newly_scheduled(now)

    # -------------------------------------------------------------- clear --
    def on_clear(self, payload, now: float) -> None:
        spec, target, flaps_left = payload
        sim, tel = self.sim, self.sim.telemetry
        if spec.kind in _DEVICE_KINDS:
            sim.pool.repair(list(target))
            tel.log(now, "repair", "",
                    f"{spec.kind}: {len(target)} device(s) back")
            if self.plan.regrow:
                sim.scheduler.regrow_shrunk(now)
            sim._start_newly_scheduled(now)
            if spec.kind == "device_flaky" and flaps_left > 1:
                sim._push(now + spec.period_s, "fault",
                          (spec, tuple(target), flaps_left - 1))
        elif spec.kind == "link_degrade":
            cls = LinkClass(spec.link)
            orig = self._orig_links.pop(cls, None)
            if orig is not None:
                sim.pool.links[cls] = orig
                sim.scheduler.storage.links[cls] = orig
            tel.log(now, "repair", "",
                    f"link_degrade: {cls.value} restored")
            self._reprice_running(now)
        elif spec.kind == "tranche_brownout":
            name = self._tranche_name(spec)
            # a tranche that *failed* mid-brownout is out of the
            # inventory: leave the saved original for the tranche_fail
            # clear to restore (resurrecting it here would bring it
            # back early, without a lease slot)
            if name in sim.scheduler.storage.tranches:
                orig = self._orig_tranches.pop(name, None)
                if orig is not None:
                    sim.scheduler.storage.tranches[name] = orig
                tel.log(now, "repair", "",
                        f"tranche_brownout: {name} restored")
                self._reprice_stalls(now)
        elif spec.kind == "tranche_fail":
            name = target[0]
            orig = self._orig_tranches.pop(name, None)
            if orig is not None:
                storage = sim.scheduler.storage
                storage.tranches[name] = orig
                storage._leases.setdefault(name, {})
            tel.log(now, "repair", "", f"tranche_fail: {name} back")
            sim._start_newly_scheduled(now)

    # -------------------------------------------------------------- drain --
    def on_drain(self, spec: FaultSpec, now: float) -> None:
        """Planned detach announced: serve replicas on the doomed devices
        stop admitting (the router skips them) and finish in-flight work;
        their queued requests re-route immediately."""
        sim, tel = self.sim, self.sim.telemetry
        doomed = self._doomed_uids(spec)
        if not doomed:
            return
        drained = 0
        for name, rep in list(sim.replicas.items()):
            job = rep.job
            if job.state != RUNNING or job.system is None:
                continue
            if not doomed & set(job.system.device_uids):
                continue
            sim.draining.add(name)
            drained += 1
            svc = sim.services[job.service]
            # queued (not yet begun) requests re-route right away;
            # in-flight ones finish on the still-healthy replica
            for rid in list(rep.queue):
                rep.queue.remove(rid)
                svc.requests[rid].pop("replica", None)
                sim._route_request(svc, rid, now)
        if drained:
            tel.drains += drained
            tel.log(now, "drain", "",
                    f"{spec.kind} in {spec.notice_s:.0f}s: {drained} "
                    "replica(s) draining")

    # ------------------------------------------------------------ helpers --
    def _device_victims(self, spec: FaultSpec) -> List[int]:
        pool = self.sim.pool
        if spec.kind in ("domain_outage", "pod_loss"):
            return [d.uid for d in pool.healthy() if d.domain == spec.domain]
        healthy = [d.uid for d in pool.healthy()]
        n = min(spec.n, len(healthy))
        return self.sim.rng.sample(healthy, n) if n > 0 else []

    def _doomed_uids(self, spec: FaultSpec) -> set:
        pool = self.sim.pool
        if spec.kind in ("domain_outage", "pod_loss"):
            return {d.uid for d in pool.healthy()
                    if d.domain == spec.domain}
        return set()        # random victims are unknowable in advance

    @staticmethod
    def _clear_time(spec: FaultSpec, now: float) -> float:
        if spec.kind == "device_flaky":
            down = (spec.t_clear - spec.t) if spec.t_clear < _INF \
                else spec.period_s / 2.0
            return now + down
        return spec.t_clear

    def _hang_devices(self, spec: FaultSpec, uids: List[int],
                      now: float) -> None:
        """Devices die NOW; the scheduler learns at ``now + detect_s``.
        Victim jobs hang in the window: progress frozen (``progress_t``
        pushed past it), traffic off, stale completions invalidated."""
        sim = self.sim
        for job in sim.scheduler.running:
            sim._sync_steps(job, now)
        sim.pool.mark_failed(uids)
        hit = set(uids)
        for job in sim.scheduler.running:
            if job.system is None or not hit & set(job.system.device_uids):
                continue
            sim._rate_off(job.name)
            job.epoch += 1              # drops any scheduled completion
            job.progress_t = now + spec.detect_s
            if job.fault_t < 0.0:
                job.fault_t = now
            self._hang_serve(job)

    def _hang_tranche(self, name: str, now: float,
                      spec: FaultSpec) -> None:
        """Tranche data is unreachable from ``now``; holders hang until
        the detect event preempts them onto other storage."""
        sim = self.sim
        for job in sim.scheduler.running:
            if job.system is None or job.system.tranche != name:
                continue
            sim._sync_steps(job, now)
            sim._rate_off(job.name)
            job.epoch += 1
            job.progress_t = now + spec.detect_s
            if job.fault_t < 0.0:
                job.fault_t = now
            self._hang_serve(job)

    def _hang_serve(self, job) -> None:
        """A serve replica's devices just died: its in-flight decodes
        halt mid-stream (their scheduled completions are invalidated by
        bumping the attempt counter) and the router quarantines it.
        Only timeouts / health checks / the cluster-level detect can get
        those requests moving again — which is exactly the resilience
        story the serving failover models."""
        sim = self.sim
        if not isinstance(job, ServeJob):
            return
        rep = sim.replicas.get(job.name)
        if rep is None:
            return
        svc = sim.services[job.service]
        for rid in rep.active:
            svc.requests[rid]["attempt"] += 1
        sim.draining.add(job.name)

    def _evacuate_tranche(self, name: str, now: float):
        """Detect: preempt every holder, then withdraw the tranche from
        the inventory so ``plan_tranche`` stops offering it."""
        sim = self.sim
        storage = sim.scheduler.storage
        changed = []
        for job in list(sim.scheduler.running):
            if job.system is not None and job.system.tranche == name:
                sim.scheduler._preempt(job, now, why=f"tranche {name} failed")
                changed.append(job)
        tr = storage.tranches.pop(name, None)
        if tr is not None:
            # setdefault: a brownout may already hold the true original
            # spec — the popped entry would be the browned-out copy
            self._orig_tranches.setdefault(name, tr)
            # leases were released by the preemptions above; withdraw the
            # slot so check_invariants stops iterating it
            storage._leases.pop(name, None)
        return changed

    def _scale_link(self, cls: LinkClass, frac: float) -> None:
        sim = self.sim
        orig = self._orig_links.setdefault(cls, sim.pool.links[cls])
        degraded = dataclasses.replace(
            orig, bandwidth=orig.bandwidth * max(frac, 1e-9))
        sim.pool.links[cls] = degraded
        sim.scheduler.storage.links[cls] = degraded

    def _scale_tranche(self, name: str, frac: float) -> None:
        storage = self.sim.scheduler.storage
        if name not in storage.tranches:
            return          # failed out of the inventory; nothing to brown
        orig = self._orig_tranches.setdefault(name, storage.tranches[name])
        storage.tranches[name] = dataclasses.replace(
            orig, read_bw=orig.read_bw * max(frac, 1e-9),
            write_bw=orig.write_bw * max(frac, 1e-9))

    def _tranche_name(self, spec: FaultSpec) -> Optional[str]:
        storage = self.sim.scheduler.storage
        if spec.tranche:
            return spec.tranche if (spec.tranche in storage.tranches
                                    or spec.tranche in self._orig_tranches) \
                else None
        names = sorted(storage.tranches)
        return names[0] if names else None

    def _reprice_running(self, now: float) -> None:
        """Link bandwidth moved: every running job's fabric snapshot is
        rebuilt on the live link table and its plan re-priced — progress
        already made accrues at the old step time, remaining work at the
        new one (graceful degradation: nobody is evicted)."""
        sim = self.sim
        sched = sim.scheduler
        repriced = []
        for job in list(sched.running):
            if job.system is None or job.plan is None:
                continue
            sim._sync_steps(job, now)
            fabric = dataclasses.replace(job.system.fabric,
                                         links=dict(sim.pool.links))
            job.system = dataclasses.replace(job.system, fabric=fabric)
            if job.run is not None:
                job.run.system = job.system
            job.plan = sched._repriced(job.plan, job.system)
            repriced.append(job)
        sched.update_stalls()           # storage attach rides links too
        sched.stall_dirty.clear()       # folded into the reschedule below
        for job in repriced:
            sim._rate_off(job.name)
            job.epoch += 1
            if isinstance(job, ServeJob):
                sim._push(now, "rate", (job.name, job.epoch))
            else:
                sim._schedule_completion(job, now)

    def _reprice_stalls(self, now: float) -> None:
        """Tranche bandwidth moved: re-derive stalls and let the
        simulator's ordinary stall resync re-price the tenants."""
        self.sim.scheduler.update_stalls()
        self.sim._resync_stalls(now)
