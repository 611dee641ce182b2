"""Pluggable system-metric samplers for the tracking plane, held against
``repro/tracking/sampler.py``.

A sampler is any object with a ``sample() -> dict[str, float]`` method;
:meth:`.run.Run.log_system` merges every attached
sampler's dict into one ``{"kind": "system"}`` record.  Two built-ins:

  * :class:`ProcSampler` — process RSS and CPU time scraped from
    ``/proc/self`` (no psutil dependency; degrades to an empty sample on
    platforms without procfs).
  * :class:`CounterSampler` — adapts harness-reported counters (simulated
    AUU, per-link byte rates, KV-page occupancy ...) into the sampler
    protocol: the harness pushes values, ``sample()`` snapshots them.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Mapping, Optional


class ProcSampler:
    """Process RSS / CPU via ``/proc`` (Linux) — zero-dependency psutil.

    Emits:
      * ``proc.rss_mb``       — resident set size (MiB), from
        ``/proc/self/status`` ``VmRSS``;
      * ``proc.cpu_s``        — cumulative user+system CPU seconds, from
        ``/proc/self/stat`` utime/stime;
      * ``proc.cpu_pct``      — CPU% over the interval since the previous
        sample (0.0 on the first sample).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.time
        self._hz = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
        self._last_cpu_s: Optional[float] = None
        self._last_t: Optional[float] = None

    def _rss_mb(self) -> Optional[float]:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return float(line.split()[1]) / 1024.0  # kB -> MiB
        except OSError:
            pass
        return None

    def _cpu_s(self) -> Optional[float]:
        try:
            with open("/proc/self/stat") as f:
                raw = f.read()
            # field 2 (comm) may contain spaces; split after the closing ')'
            fields = raw.rsplit(")", 1)[1].split()
            utime, stime = int(fields[11]), int(fields[12])
            return (utime + stime) / float(self._hz)
        except (OSError, IndexError, ValueError):
            return None

    def sample(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        rss = self._rss_mb()
        if rss is not None:
            out["proc.rss_mb"] = round(rss, 3)
        cpu = self._cpu_s()
        if cpu is not None:
            out["proc.cpu_s"] = round(cpu, 4)
            now = self.clock()
            if self._last_cpu_s is not None and self._last_t is not None \
                    and now > self._last_t:
                pct = 100.0 * (cpu - self._last_cpu_s) / (now - self._last_t)
                out["proc.cpu_pct"] = round(max(0.0, pct), 2)
            else:
                out["proc.cpu_pct"] = 0.0
            self._last_cpu_s, self._last_t = cpu, now
        return out


class CounterSampler:
    """Harness-reported counters behind the sampler protocol.

    The owning harness calls :meth:`update` whenever its simulated
    counters move (AUU, per-link byte rates, KV-page occupancy);
    ``sample()`` returns the latest snapshot, prefixed for namespacing.
    """

    def __init__(self, prefix: str = "sim",
                 initial: Optional[Mapping[str, float]] = None):
        self.prefix = prefix
        self._counters: Dict[str, float] = dict(initial or {})

    def update(self, counters: Mapping[str, float]) -> None:
        self._counters.update(counters)

    def sample(self) -> Dict[str, float]:
        return {f"{self.prefix}.{k}": v for k, v in self._counters.items()}
