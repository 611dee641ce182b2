"""Cluster telemetry: the paper's Figs 10-12 lifted to cluster level, held
against ``repro/cluster/telemetry.py``.

Every control-plane action emits a ``ClusterEvent``; between events the
``Telemetry`` object integrates time-weighted occupancy, so the report
can state:

  * **pool utilization** — leased device-seconds / healthy device-seconds
    (Fig 10's GPU-util bar, aggregated over tenants);
  * **AUU** — accelerator under-utilization: the fraction of *leased*
    device-time not spent in useful compute (1 - AU in MLPerf-Storage
    terms; each job's compute fraction comes from its analytic roofline
    terms, so fabric-bound jobs show up as under-utilization exactly as
    the paper's falcon configs do);
  * **per-link-class traffic** — bytes moved over LOCAL / SWITCH / HOST /
    DCN links (Fig 12's sustained-traffic measurement, by fabric);
  * **recomposition overhead** — count and seconds spent re-forming
    systems after failures (Fig 11's switch-overhead, made operational).

Event schema (``ClusterEvent``): ``t`` (simulated seconds), ``kind`` (one
of ``EVENT_KINDS`` below), ``job`` (job name or "" for pool-level
events), and ``detail`` (human-readable payload).
``Telemetry.report()`` returns a JSON-serializable dict with the schema
used by ``benchmarks/cluster_sim`` — the canonical field-by-field
reference is ``docs/telemetry.md``.

Invariants:

  * ``observe(t, ...)`` integrates the *previous* occupancy over
    ``[last_t, t]``; callers must invoke it after every state change
    with the post-change values, and ``t`` never moves backwards.
  * Every control-plane action logs exactly one event with a ``kind``
    from ``EVENT_KINDS`` (asserted in ``log``); policy evictions log
    both the generic ``preempt`` and the attributing ``evict`` event.
  * Per-tenant wait samples (``job_waited``) and gang spans
    (``gang_started``) are append-only counters — ``report()`` is a
    pure function of them, so two identical traces report identically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.topology import LinkClass

EVENT_KINDS = ("submit", "reject", "start", "complete", "fail", "repair",
               "recompose", "preempt", "conflict", "storage", "evict",
               "shrink", "gang", "fault", "detect", "retry", "drain",
               "autoscale", "attach", "detach", "migrate")


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    t: float
    kind: str
    job: str = ""
    detail: str = ""


def _percentile(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (0 <= q <= 100)."""
    if not sorted_xs:
        return 0.0
    k = max(0, min(len(sorted_xs) - 1,
                   math.ceil(q / 100.0 * len(sorted_xs)) - 1))
    return sorted_xs[k]


class ServingStats:
    """Per-request serving telemetry: TTFT / TPOT / queue wait / cache
    hits, aggregated to the report schema shared by the serve engine
    (wall-clock), the cluster simulator's serving-trace mode (simulated
    time), and ``benchmarks/serve_bench``."""

    def __init__(self):
        self.ttft_s: List[float] = []
        self.tpot_s: List[float] = []
        self.wait_s: List[float] = []
        self.requests_submitted = 0
        self.requests_rejected = 0
        self.requests_completed = 0
        self.requests_timed_out = 0     # per-request deadline expiries
        self.requests_failed = 0        # retries exhausted (terminal)
        self.request_retries = 0        # re-route / re-issue attempts
        self.slo_met = 0
        self.prompt_tokens = 0
        self.cached_tokens = 0
        self.output_tokens = 0
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def mark(self, t: float) -> None:
        """Extend the observation span to ``t``."""
        if self._t0 is None:
            self._t0 = t
        self._t1 = t if self._t1 is None else max(self._t1, t)

    def add_request(self, *, t_done: float, wait_s: float, ttft_s: float,
                    tpot_s: float, prompt_tokens: int, cached_tokens: int,
                    output_tokens: int, slo_ok: bool) -> None:
        self.mark(t_done)
        self.requests_completed += 1
        self.wait_s.append(wait_s)
        self.ttft_s.append(ttft_s)
        if tpot_s > 0:
            self.tpot_s.append(tpot_s)
        self.prompt_tokens += prompt_tokens
        self.cached_tokens += cached_tokens
        self.output_tokens += output_tokens
        self.slo_met += bool(slo_ok)

    @property
    def span_s(self) -> float:
        if self._t0 is None or self._t1 is None:
            return 0.0
        return self._t1 - self._t0

    @staticmethod
    def _dist(xs: List[float]) -> Dict[str, float]:
        s = sorted(xs)
        return {"p50": _percentile(s, 50.0), "p99": _percentile(s, 99.0),
                "mean": sum(s) / len(s) if s else 0.0}

    def report(self) -> Dict[str, object]:
        span = max(self.span_s, 1e-12)
        return {
            "requests": {
                "submitted": self.requests_submitted,
                "completed": self.requests_completed,
                "rejected": self.requests_rejected,
                "timed_out": self.requests_timed_out,
                "failed": self.requests_failed,
                "retries": self.request_retries,
            },
            "failed_request_rate": (self.requests_failed
                                    / max(self.requests_submitted, 1)),
            "ttft_s": self._dist(self.ttft_s),
            "tpot_s": self._dist(self.tpot_s),
            "queue_wait_s": self._dist(self.wait_s),
            "slo_attainment": (self.slo_met
                               / max(self.requests_completed, 1)),
            "throughput_tok_s": self.output_tokens / span,
            "requests_per_s": self.requests_completed / span,
            "cache_hit_rate": (self.cached_tokens
                               / max(self.prompt_tokens, 1)),
            "output_tokens": self.output_tokens,
            "span_s": self.span_s,
        }


class StorageStats:
    """Per-tranche storage telemetry: time-weighted lessee occupancy,
    bytes moved, and accumulated input-stall seconds — the MLPerf-Storage
    view (AU degradation comes exactly from these stalls) lifted to the
    tranche the jobs actually lease."""

    def __init__(self, name: str, attach: str = ""):
        self.name = name
        self.attach = attach
        self.read_bytes = 0.0
        self.write_bytes = 0.0
        self.stall_s = 0.0              # input-stall seconds across tenants
        self.leases_granted = 0
        self.peak_lessees = 0
        # time-weighted lessee integral
        self._t: Optional[float] = None
        self._t0: Optional[float] = None
        self._n = 0
        self._lessee_area = 0.0         # lessee-seconds

    def observe(self, t: float, n_lessees: int) -> None:
        if self._t is None:
            self._t = self._t0 = t
        dt = t - self._t
        if dt > 0:
            self._lessee_area += dt * self._n
            self._t = t
        self._n = n_lessees
        self.peak_lessees = max(self.peak_lessees, n_lessees)

    def add_io(self, read_bytes: float = 0.0, write_bytes: float = 0.0,
               stall_s: float = 0.0) -> None:
        self.read_bytes += read_bytes
        self.write_bytes += write_bytes
        self.stall_s += stall_s

    @property
    def span_s(self) -> float:
        if self._t is None or self._t0 is None:
            return 0.0
        return self._t - self._t0

    def mean_lessees(self) -> float:
        span = self.span_s
        return self._lessee_area / span if span > 0 else 0.0

    def report(self) -> Dict[str, object]:
        return {
            "attach": self.attach,
            "leases_granted": self.leases_granted,
            "peak_lessees": self.peak_lessees,
            "mean_lessees": self.mean_lessees(),
            "read_gb": self.read_bytes / 1e9,
            "write_gb": self.write_bytes / 1e9,
            "input_stall_s": self.stall_s,
        }


class Telemetry:
    """Integrates occupancy over simulated time and accumulates counters."""

    def __init__(self, n_devices_total: int):
        self.n_devices_total = n_devices_total
        self.events: List[ClusterEvent] = []
        self.link_traffic_bytes: Dict[str, float] = {
            c.value: 0.0 for c in LinkClass}
        self.waits_s: List[float] = []
        self.recompositions = 0
        self.recompose_overhead_s = 0.0
        self.lease_conflicts = 0
        self.jobs_submitted = 0
        self.jobs_completed = 0
        self.jobs_rejected = 0
        self.jobs_preempted = 0
        self.jobs_evicted = 0           # policy-driven preemptions (subset)
        self.jobs_shrunk = 0            # policy-driven preempt-to-shrink
        self.jobs_evictions_suppressed = 0   # victims pinned at budget
        self.jobs_failed = 0            # retry budget exhausted (terminal)
        # fault-injection plane (cluster.faults): counters + recovery
        # samples.  recovery = fault injection -> victim back on devices
        # (detect + decide + restore), one sample per fault-hit restart.
        self.faults_injected = 0
        self.faults_detect_s: List[float] = []   # detection latencies
        self.recovery_s: List[float] = []        # fault -> restart samples
        self.retries_scheduled = 0      # backoff retries granted
        self.drains = 0                 # graceful drains honoured
        # live recomposition plane (cluster.recomposer): widen / shrink /
        # tranche-migrate actions taken on running jobs, plus the device
        # delta they moved (attached + detached device count).
        self.attaches = 0
        self.detaches = 0
        self.migrations = 0
        self.devices_recomposed = 0
        # set by the simulator when a RecomposeConfig is active; gates the
        # ``recompose`` report section so legacy (recompose=None) reports
        # stay bit-identical (same pattern as the serving autoscale block)
        self.recompose_enabled = False
        self.storage: Dict[str, StorageStats] = {}   # tranche -> stats
        # gang scheduling: one span sample per gang start (DCN hop span)
        self.gang_spans: List[int] = []
        # fairness: queue-wait samples keyed by tenant (insertion order
        # follows first wait per tenant -> deterministic report)
        self.waits_by_tenant: Dict[str, List[float]] = {}
        # time-weighted integrals
        self._t: Optional[float] = None
        self._t0: Optional[float] = None
        self._n_leased = 0
        self._busy_equiv = 0.0          # sum over jobs: n_dev * compute_frac
        self._n_healthy = n_devices_total
        self._leased_area = 0.0         # device-seconds under lease
        self._busy_area = 0.0           # device-seconds of useful compute
        self._healthy_area = 0.0        # device-seconds of healthy capacity

    # -------------------------------------------------------------- events --
    def log(self, t: float, kind: str, job: str = "",
            detail: str = "") -> None:
        assert kind in EVENT_KINDS, kind
        self.events.append(ClusterEvent(t, kind, job, detail))

    # ----------------------------------------------------------- occupancy --
    def observe(self, t: float, *, n_leased: int, busy_equiv: float,
                n_healthy: int) -> None:
        """Advance the clock to ``t`` and record the new occupancy.

        The *previous* occupancy is integrated over [last_t, t]; call this
        after every state change with the post-change values.
        """
        if self._t is None:
            self._t = self._t0 = t
        dt = t - self._t
        if dt > 0:
            self._leased_area += dt * self._n_leased
            self._busy_area += dt * self._busy_equiv
            self._healthy_area += dt * self._n_healthy
            self._t = t
        self._n_leased = n_leased
        self._busy_equiv = busy_equiv
        self._n_healthy = n_healthy

    # ------------------------------------------------------------ counters --
    def add_link_traffic(self, link: LinkClass, nbytes: float) -> None:
        self.link_traffic_bytes[link.value] += nbytes

    def job_waited(self, seconds: float, tenant: str = "") -> None:
        self.waits_s.append(seconds)
        if tenant:
            self.waits_by_tenant.setdefault(tenant, []).append(seconds)

    def gang_started(self, span: int) -> None:
        self.gang_spans.append(span)

    def add_recomposition(self, overhead_s: float) -> None:
        self.recompositions += 1
        self.recompose_overhead_s += overhead_s

    def tranche_stats(self, name: str, attach: str = "") -> StorageStats:
        st = self.storage.get(name)
        if st is None:
            st = self.storage[name] = StorageStats(name, attach)
        return st

    # -------------------------------------------------------------- report --
    @property
    def span_s(self) -> float:
        if self._t is None or self._t0 is None:
            return 0.0
        return self._t - self._t0

    def pool_utilization(self) -> float:
        """Leased device-seconds over healthy device-seconds."""
        if self._healthy_area <= 0:
            return 0.0
        return self._leased_area / self._healthy_area

    def auu(self) -> float:
        """Accelerator under-utilization among leased device-time."""
        if self._leased_area <= 0:
            return 0.0
        return max(0.0, 1.0 - self._busy_area / self._leased_area)

    def availability(self) -> float:
        """Healthy device-seconds over total device-seconds: the fraction
        of pool capacity that survived the fault schedule."""
        span = self.span_s
        if span <= 0 or self.n_devices_total <= 0:
            return 1.0
        return self._healthy_area / (self.n_devices_total * span)

    def goodput_fraction(self) -> float:
        """Useful-compute device-seconds over *healthy* device-seconds —
        how much of the surviving capacity did real work (availability
        strips dead capacity; this strips idle + overhead on top)."""
        if self._healthy_area <= 0:
            return 0.0
        return min(1.0, self._busy_area / self._healthy_area)

    def fault_recovery(self) -> Dict[str, float]:
        s = sorted(self.recovery_s)
        return {
            "samples": len(s),
            "mean_s": sum(s) / len(s) if s else 0.0,
            "p95_s": _percentile(s, 95.0),
            "max_s": s[-1] if s else 0.0,
        }

    @staticmethod
    def _wait_dist(xs: List[float]) -> Dict[str, float]:
        s = sorted(xs)
        return {"p50": _percentile(s, 50.0), "p95": _percentile(s, 95.0),
                "p99": _percentile(s, 99.0),
                "mean": sum(s) / len(s) if s else 0.0}

    def fairness(self) -> Dict[str, object]:
        """Per-tenant queue-wait distributions plus the scalar the policy
        sweep compares: the mean over tenants of each tenant's p95 wait
        (tenant-weighted, so a flooding tenant cannot drown the small
        tenants' experience the way a job-weighted p95 would)."""
        tenants = {t: dict(wait_s=self._wait_dist(w), n_waits=len(w))
                   for t, w in sorted(self.waits_by_tenant.items())}
        p95s = [row["wait_s"]["p95"] for row in tenants.values()]
        return {
            "tenants": tenants,
            "tenant_p95_wait_mean_s": sum(p95s) / len(p95s) if p95s else 0.0,
        }

    def report(self) -> Dict[str, object]:
        waits = sorted(self.waits_s)
        span = max(self.span_s, 1e-12)
        spans = self.gang_spans
        rep: Dict[str, object] = {
            "span_s": self.span_s,
            "pool_utilization": self.pool_utilization(),
            "auu": self.auu(),
            "accelerator_utilization": 1.0 - self.auu(),
            "link_traffic_gb": {
                k: v / 1e9 for k, v in self.link_traffic_bytes.items()},
            "link_traffic_gbps": {
                k: v / 1e9 / span
                for k, v in self.link_traffic_bytes.items()},
            "recomposition": {
                "count": self.recompositions,
                "overhead_s": self.recompose_overhead_s,
                "overhead_frac": self.recompose_overhead_s / span,
            },
            "job_wait_s": {
                "p50": _percentile(waits, 50.0),
                "p99": _percentile(waits, 99.0),
                "mean": sum(waits) / len(waits) if waits else 0.0,
            },
            "jobs": {
                "submitted": self.jobs_submitted,
                "completed": self.jobs_completed,
                "rejected": self.jobs_rejected,
                "preempted": self.jobs_preempted,
                "evicted": self.jobs_evicted,
                "shrunk": self.jobs_shrunk,
                "evictions_suppressed": self.jobs_evictions_suppressed,
                "failed": self.jobs_failed,
            },
            "faults": {
                "injected": self.faults_injected,
                "availability": self.availability(),
                "goodput_fraction": self.goodput_fraction(),
                "detect_s_mean": (sum(self.faults_detect_s)
                                  / len(self.faults_detect_s)
                                  if self.faults_detect_s else 0.0),
                "recovery": self.fault_recovery(),
                "retries_scheduled": self.retries_scheduled,
                "drains": self.drains,
            },
            "gangs": {
                "started": len(spans),
                "max_span": max(spans) if spans else 0,
                "mean_span": sum(spans) / len(spans) if spans else 0.0,
            },
            "fairness": self.fairness(),
            "lease_conflicts": self.lease_conflicts,
            "n_events": len(self.events),
            "storage": {name: st.report()
                        for name, st in sorted(self.storage.items())},
        }
        if self.recompose_enabled:
            rep["recompose"] = {
                "attaches": self.attaches,
                "detaches": self.detaches,
                "migrations": self.migrations,
                "devices_recomposed": self.devices_recomposed,
            }
        return rep
