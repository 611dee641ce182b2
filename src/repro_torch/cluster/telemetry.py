"""Serving telemetry, held against ``repro/cluster/telemetry.py``.

Only ``ServingStats`` and ``_percentile`` are here (what the serving engine
reports through); the rest of the cluster plane's telemetry arrives with the
analytics/cluster slice.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


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
