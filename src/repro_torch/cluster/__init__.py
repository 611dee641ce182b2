"""Composable-cluster control plane, held against ``repro/cluster``.

The paper composes ONE system at a time by hand.  This package lifts that
to the operating point the composable-infrastructure pitch actually
targets (and that Takano & Suzaki's disaggregation manager automates for
real clouds): many tenants sharing one device pool, each job leased an
exclusive slice, composed on the fabric that matches its placement, and
re-composed elastically when devices fail.

  * ``lease``      — exclusive claim/release with domain-aware placement,
                     multi-pod gang co-selection (``plan_gang``) and
                     all-or-nothing gang claims (``acquire_gang``)
  * ``scheduler``  — multi-tenant job queue with pluggable policies
                     (``easy`` | ``fair_share`` | ``priority_preempt``):
                     admission, backfill, policy preemption, elastic
                     preempt-to-shrink on failure
  * ``simulator``  — trace-driven discrete-event cluster simulation
  * ``faults``     — deterministic fault injection (device / domain /
                     link / tranche faults with detection latency) and
                     the recovery plane: retry budgets, graceful
                     degradation, regrow-after-repair, serve failover
  * ``recomposer`` — live recomposition of elastic jobs (attach, shrink
                     to admit, tranche migration)
  * ``telemetry``  — per-link traffic, utilization/AUU, fairness + gang
                     stats, recompose overhead, availability + recovery

Everything is priced analytically from ``repro_torch.core`` at the
H100's constants (``core.topology``); a scheduler reads only the
calibration it is handed (``Scheduler(calibration=...)``,
``TraceConfig.calibration``).
"""
from repro_torch.cluster.faults import (FAULT_KINDS, FaultInjector,
                                        FaultPlan, FaultSpec)
from repro_torch.cluster.lease import (GangPlan, LeaseManager, PlacementPlan,
                                       plan_gang, plan_placement)
from repro_torch.cluster.scheduler import (POLICIES, EasyPolicy,
                                           FairSharePolicy, Job, Policy,
                                           PriorityPreemptPolicy, Scheduler,
                                           ServeJob, make_policy)
from repro_torch.cluster.simulator import (ClusterSimulator, JobTemplate,
                                           ServiceConfig, TraceConfig,
                                           run_trace)
from repro_torch.cluster.telemetry import (ClusterEvent, ServingStats,
                                           Telemetry)

__all__ = [
    "ClusterEvent", "ClusterSimulator", "EasyPolicy", "FAULT_KINDS",
    "FairSharePolicy", "FaultInjector", "FaultPlan", "FaultSpec",
    "GangPlan", "Job", "JobTemplate", "LeaseManager", "POLICIES",
    "PlacementPlan", "Policy", "PriorityPreemptPolicy", "Scheduler",
    "ServeJob", "ServiceConfig", "ServingStats", "Telemetry", "TraceConfig",
    "make_policy", "plan_gang", "plan_placement", "run_trace",
]
