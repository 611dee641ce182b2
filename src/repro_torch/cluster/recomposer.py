"""Live recomposition plane: re-shape running jobs as demand shifts,
held against ``repro/cluster/recomposer.py``.

The paper's core claim is that composable infrastructure lets the pool
"mix and match" resources *dynamically*; until this module, our
composition was frozen at admission — a job kept the exact device set
and tranche it was composed with until it finished, failed, or was
preempted.  The ``Recomposer`` is the pool-side manager (Takano &
Suzaki's disaggregated accelerator manager, Altintas et al.'s dynamic
composability) that closes the gap.  On every scheduler tick it:

  * **attaches** idle devices to running jobs below their submitted
    width — ``Scheduler.regrow_shrunk`` generalized beyond fault
    repair, so repaired capacity rejoins shrunk jobs instead of idling
    — but only while the queue is empty (queued admissions outrank
    widening running work);
  * **detaches** devices from over-provisioned jobs to admit queued
    work sooner (*shrink-to-admit*) — priced with the existing analytic
    model: the halved donors' slowdown and the head job's earlier start
    are projected through ``recommend._estimate`` + the EASY
    reservation, and the pass only fires when the projected makespan
    strictly improves;
  * **migrates** a job's storage lease to a less-loaded tranche when
    contention makes the target's effective per-lessee bandwidth
    strictly better (by ``migrate_bw_factor``) — the composable switch
    re-attaches the same drawer over a different path, so the cost is
    the re-derived contended stalls, not a data copy.

All three actions run through the existing ``train/elastic`` +
``compose()/recompose()`` path: attach re-places hop-aware
(``Scheduler._recompose_placed`` -> ``plan_placement``), every
recompose is atomic (a partial claim rolls back like ``acquire_gang``),
and changed jobs flow back to the simulator through ``policy_victims``
(restore-priced completion events) and ``stall_dirty`` (contention
re-pricing).

Determinism: the tick is rng-free and the passes iterate scheduler
state in insertion order, so a trace with a ``RecomposeConfig`` is
bit-identical per seed — and a trace *without* one never constructs a
``Recomposer`` at all, keeping every legacy report bit-identical.

Only ``Job.elastic`` jobs are touched; ``cooldown_s`` hysteresis keeps
one job from being re-shaped on consecutive ticks (attach/detach
thrash would churn checkpoint restores for nothing).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.lease import path_maps, plan_placement
from repro_torch.cluster.scheduler import Job, Scheduler
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import recommend
from repro_torch.core.compose import CompositionError
from repro_torch.core.topology import DevicePool


@dataclasses.dataclass(frozen=True)
class RecomposeConfig:
    """Knobs of the live recomposition plane (``TraceConfig.recompose``;
    ``None`` there disables the plane entirely — no ticks, no events,
    no report section: legacy traces stay bit-identical)."""
    interval_s: float = 30.0         # scheduler tick period
    attach: bool = True              # widen shrunk elastic jobs
    detach: bool = True              # shrink-to-admit queued work
    migrate: bool = True             # tranche migration under contention
    # hysteresis: a job re-shaped within the last cooldown_s is left
    # alone (prevents attach/detach ping-pong across ticks)
    cooldown_s: float = 60.0
    # shrink-to-admit fires only when the projected makespan improves
    # by more than this margin (seconds)
    min_makespan_gain_s: float = 0.0
    # migrate fires only when the target tranche's effective per-lessee
    # bandwidth beats the current one by at least this factor
    migrate_bw_factor: float = 1.25


class Recomposer:
    """Pool-side recomposition manager driven by simulator ticks."""

    def __init__(self, scheduler: Scheduler, cfg: RecomposeConfig):
        self.scheduler = scheduler
        self.cfg = cfg
        self._last_t: Dict[str, float] = {}      # job -> last action time

    # ------------------------------------------------------------- ticks --
    def tick(self, now: float) -> List[Job]:
        """One recomposition pass; returns the re-shaped jobs (they are
        also queued on ``Scheduler.policy_victims`` / ``stall_dirty``
        for the simulator's ordinary re-pricing paths)."""
        changed: List[Job] = []
        if self.cfg.attach:
            changed += self._attach_pass(now)
        if self.cfg.detach:
            changed += self._detach_pass(now)
        if self.cfg.migrate:
            changed += self._migrate_pass(now)
        return changed

    def _cooled(self, name: str, now: float) -> bool:
        last = self._last_t.get(name)
        return last is None or now - last >= self.cfg.cooldown_s

    # ------------------------------------------------------------ attach --
    def _attach_step_s(self, job: Job) -> Optional[float]:
        """Pure projection of ``job``'s repriced step time after a
        widen-to-budget attach: plan the placement on a read-only pool
        view with the job's own claim freed, then reprice the best
        full-budget candidate on that placement's actual paths — the
        exact math ``attach_job`` will apply, without mutating
        anything.  None when no feasible widened placement exists."""
        sched = self.scheduler
        plan = sched.plan_job(job)
        if plan is None:
            return None
        dp, tp = plan.shape[-2], plan.shape[-1]
        pool = sched.pool
        view = DevicePool(
            devices=pool.devices, links=pool.links,
            leases={u: h for u, h in pool.leases.items()
                    if h != job.system.name},
            topology=pool.topology)
        try:
            placed = plan_placement(view, dp, tp)
        except CompositionError:
            return None
        links, hops, scale = path_maps(placed.axis_paths)
        fab = dataclasses.replace(job.system.fabric, axis_links=links,
                                  axis_hops=hops, axis_bw_scale=scale)
        return sched._repriced(
            plan, dataclasses.replace(job.system, fabric=fab)).step_s

    def _attach_pass(self, now: float) -> List[Job]:
        """Widen running elastic jobs below their submitted width from
        idle capacity — only while no admissible job is queued (a
        widened job would otherwise take the exact devices the queue
        head is reserving), and only when the analytic model projects
        the widened job finishing earlier net of its checkpoint
        restore (a regrown mesh forced onto a slower fabric can lose
        to the narrow one it replaces)."""
        sched = self.scheduler
        if any(j.not_before_t <= now for j in sched.queue):
            return []
        changed: List[Job] = []
        for job in list(sched.running):
            if not job.elastic or job.n_pods > 1 or job.system is None:
                continue
            if job.system.n_devices >= job.n_chips:
                continue
            if not self._cooled(job.name, now):
                continue
            if (len(sched.pool.available())
                    < job.n_chips - job.system.n_devices):
                continue
            new_step = self._attach_step_s(job)
            if new_step is None:
                continue
            rem = job.remaining_steps()
            projected = (sched.restore_s(job)
                         + rem * (new_step + job.input_stall_s))
            if projected >= rem * job.step_s:
                continue             # wider but slower (or not worth the
                                     # restore): keep the narrow mesh
            if sched.attach_job(job, now):
                self._last_t[job.name] = now
                changed.append(job)
        return changed

    # ------------------------------------------------------------ detach --
    def _halved(self, job: Job) -> Optional[recommend.Candidate]:
        """Analytic plan for ``job`` at half its data axis (None when
        the halved mesh is infeasible)."""
        cfg = get_config(job.arch)
        shape = SHAPES[job.shape_name]
        dp, tp = job.dp_tp
        cand = recommend.calibrate_candidate(
            recommend._estimate(cfg, shape, dp // 2, tp),
            cfg, job.arch, job.shape_name, shape,
            self.scheduler.calibration)
        return cand if cand.feasible else None

    def _detach_pass(self, now: float) -> List[Job]:
        """Shrink-to-admit: halve enough over-provisioned elastic donors
        that the queue head fits now — but only when the projected
        makespan (donors slowed, head started early) strictly beats
        leaving everyone alone (head waits for the EASY reservation)."""
        sched = self.scheduler
        queue = [j for j in sched.policy.order(sched, now)
                 if j.not_before_t <= now]
        if not queue:
            return []
        head = queue[0]
        if head.n_pods > 1:
            return []                # gang admission needs whole domains
        need = head.n_chips - len(sched.pool.available())
        if need <= 0:
            return []                # fits already: poll() will start it
        donors: List[Tuple[Job, recommend.Candidate]] = []
        for j in sched.running:
            if not j.elastic or j.n_pods > 1 or j.system is None:
                continue
            if not self._cooled(j.name, now) or j.dp_tp[0] < 2:
                continue
            cand = self._halved(j)
            if cand is not None:
                donors.append((j, cand))
        donors.sort(key=lambda row: (-row[0].system.n_devices,
                                     row[0].name))
        chosen: List[Tuple[Job, recommend.Candidate]] = []
        freed = 0
        for j, cand in donors:
            if freed >= need:
                break
            chosen.append((j, cand))
            freed += j.system.n_devices // 2
        if freed < need:
            return []                # halving everyone still won't fit it
        # analytic pricing: without the detach the head starts at the
        # EASY reservation; with it the head starts now and every donor
        # runs its remaining steps at the halved-mesh step time
        t_free = sched._reservation_t(head.n_chips, now)
        head_restore = sched.est_restore_for(head)
        base_end = (t_free + head_restore + head.est_duration_s()
                    if t_free != float("inf") else float("inf"))
        base = max([base_end] + [j.est_end_t for j in sched.running])
        donor_names = {j.name for j, _ in chosen}
        ends = [now + head_restore + head.est_duration_s()]
        for j, cand in chosen:
            ends.append(now + sched.restore_s(j)
                        + j.remaining_steps()
                        * (cand.step_s + j.input_stall_s))
        ends += [j.est_end_t for j in sched.running
                 if j.name not in donor_names]
        if max(ends) + self.cfg.min_makespan_gain_s >= base:
            return []                # no projected win: leave donors be
        changed: List[Job] = []
        for j, _ in chosen:
            if sched.detach_job(j, now):
                self._last_t[j.name] = now
                changed.append(j)
        return changed

    # ----------------------------------------------------------- migrate --
    def _migrate_pass(self, now: float) -> List[Job]:
        """Move elastic jobs to a strictly-better storage tranche: the
        best candidate's projected per-lessee bandwidth (with the job
        counted in) must beat the current tranche's by
        ``migrate_bw_factor``."""
        sched = self.scheduler
        storage = sched.storage
        changed: List[Job] = []
        for job in list(sched.running):
            if (not job.elastic or job.io is None or job.system is None
                    or job.system.tranche is None):
                continue
            if not self._cooled(job.name, now):
                continue
            cur = job.system.tranche
            cur_bw = storage.read_bw(cur)
            cap = sched._storage_request(job)
            best_name, best_bw = "", 0.0
            for name, tr in sorted(storage.tranches.items()):
                if name == cur or storage.exclusively_held(name):
                    continue
                if storage.capacity_used(name) + cap > tr.capacity_bytes:
                    continue
                bw = tr.effective_read_bw(storage.links,
                                          storage.n_lessees(name) + 1)
                if bw > best_bw:
                    best_name, best_bw = name, bw
            if not best_name or best_bw < self.cfg.migrate_bw_factor * cur_bw:
                continue
            if sched.migrate_tranche(job, now, best_name):
                self._last_t[job.name] = now
                changed.append(job)
        return changed
