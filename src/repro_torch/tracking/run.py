"""Run lifecycle: the wandb-style ``init -> log -> finish`` tracking API,
held against ``repro/tracking/run.py``.

A :class:`Run` is one tracked execution of a producer (a training loop,
a serving session).  It owns an **append-only JSONL event stream** at
``<dir>/<run_id>/events.jsonl`` (``dir`` defaults to the port's own
``results/torch/runs``); every line is one self-describing JSON record:

  * ``{"kind": "run", ...}``      — header: schema version, run id,
    project, tags, config snapshot, git SHA, wall-clock start;
  * ``{"kind": "metrics", ...}``  — one logged step: monotonic ``step``,
    wall-clock ``t``, flat ``metrics`` dict;
  * ``{"kind": "system", ...}``   — a system-metric sample (process
    RSS/CPU from the pluggable samplers plus any harness-reported
    counters such as simulated AUU or KV-page occupancy);
  * ``{"kind": "event", ...}``    — a discrete event mirror (the cluster
    simulator's evict/shrink/gang/storage stream), with optional
    simulated-time ``sim_t``;
  * ``{"kind": "summary", ...}``  — the final summary row;
  * ``{"kind": "finish", ...}``   — terminator with exit status.

Invariants:

  * **Monotonic steps** — ``log(..., step=n)`` never moves the step
    counter backwards; records are appended in call order and flushed
    per line, so a crashed run leaves a readable prefix.
  * **Deterministic ids under injection** — ``run_id`` is a pure
    function of (project, clock, seed) when both ``clock`` and ``seed``
    are injected (tests pin this); the default uses wall time and
    ``os.urandom`` entropy.
  * **One current run per process** — ``init()`` installs the run as the
    process-wide current run (``current_run()``), mirroring the
    ``wandb.run`` global; producers resolve it as their default tracker
    so a run's stream collects the trainer's, the engine's and the
    cluster simulator's telemetry produced under it.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional

SCHEMA_VERSION = 1

_CURRENT: Optional["Run"] = None


def git_sha(root: Optional[str] = None) -> str:
    """Short commit SHA of the repo containing ``root`` ("" if no git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root or os.getcwd(), capture_output=True, text=True,
            timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def make_run_id(project: str, t: float, seed: Optional[int] = None) -> str:
    """``<project-slug>-<utc-stamp>-<suffix>``; pure in (project, t, seed)
    when ``seed`` is given (the deterministic-test contract)."""
    slug = project.replace("/", "-").replace(" ", "_")
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(t))
    rng = random.Random(seed if seed is not None
                        else int.from_bytes(os.urandom(8), "big"))
    suffix = "".join(rng.choice("0123456789abcdef") for _ in range(6))
    return f"{slug}-{stamp}-{suffix}"


class Run:
    """One tracked run: JSONL event stream + config snapshot + summary."""

    def __init__(self, project: str,
                 config: Optional[Mapping[str, object]] = None,
                 tags: Iterable[str] = (), *,
                 dir: str = os.path.join("results", "torch", "runs"),
                 run_id: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 seed: Optional[int] = None,
                 samplers: Optional[List[object]] = None,
                 sha: Optional[str] = None):
        self.project = project
        self.config: Dict[str, object] = dict(config or {})
        self.tags = tuple(tags)
        self.clock = clock or time.time
        t0 = self.clock()
        self.id = run_id or make_run_id(project, t0, seed)
        self.dir = os.path.join(dir, self.id)
        self.git_sha = git_sha() if sha is None else sha
        self.samplers = list(samplers) if samplers is not None else []
        self.step = 0
        self.summary: Dict[str, object] = {}
        self.finished = False
        os.makedirs(self.dir, exist_ok=True)
        self._path = os.path.join(self.dir, "events.jsonl")
        self._f = open(self._path, "a")
        self._emit({
            "kind": "run", "schema_version": SCHEMA_VERSION,
            "run_id": self.id, "project": self.project,
            "tags": list(self.tags), "t": t0, "git_sha": self.git_sha,
            "config": self.config,
        })

    # ------------------------------------------------------------- stream --
    @property
    def path(self) -> str:
        return self._path

    def _emit(self, record: Mapping[str, object]) -> None:
        if self.finished:
            return
        self._f.write(json.dumps(record, default=str,
                                 separators=(",", ":")) + "\n")
        self._f.flush()

    def _bump(self, step: Optional[int]) -> int:
        # monotonic: an explicit step may only move the counter forward
        if step is not None and step > self.step:
            self.step = step
        else:
            self.step += 1
        return self.step

    # ---------------------------------------------------------------- api --
    def log(self, metrics: Mapping[str, object],
            step: Optional[int] = None) -> int:
        """Append one step row; returns the (monotonic) step recorded."""
        n = self._bump(step)
        self._emit({"kind": "metrics", "step": n, "t": self.clock(),
                    "metrics": dict(metrics)})
        return n

    def log_event(self, name: str, data: Optional[Mapping[str, object]] = None,
                  sim_t: Optional[float] = None) -> None:
        """Append one discrete event (the simulator telemetry mirror)."""
        rec: Dict[str, object] = {"kind": "event", "event": name,
                                  "step": self.step, "t": self.clock(),
                                  "data": dict(data or {})}
        if sim_t is not None:
            rec["sim_t"] = sim_t
        self._emit(rec)

    def log_system(self, counters: Optional[Mapping[str, float]] = None
                   ) -> Dict[str, float]:
        """Sample every pluggable sampler, merge harness-reported
        ``counters``, and append one system record."""
        sample: Dict[str, float] = {}
        for s in self.samplers:
            sample.update(s.sample())
        sample.update(dict(counters or {}))
        if sample:
            self._emit({"kind": "system", "step": self.step,
                        "t": self.clock(), "metrics": sample})
        return sample

    def log_summary(self, summary: Mapping[str, object]) -> None:
        """Merge into the final summary row (written again at finish)."""
        self.summary.update(summary)
        self._emit({"kind": "summary", "t": self.clock(),
                    "schema_version": SCHEMA_VERSION,
                    "summary": dict(self.summary)})

    def finish(self, status: str = "ok") -> None:
        if self.finished:
            return
        if self.summary:
            self._emit({"kind": "summary", "t": self.clock(),
                        "schema_version": SCHEMA_VERSION,
                        "summary": dict(self.summary)})
        self._emit({"kind": "finish", "t": self.clock(), "status": status,
                    "step": self.step})
        self.finished = True
        self._f.close()
        global _CURRENT
        if _CURRENT is self:
            _CURRENT = None

    # ------------------------------------------------------ context mgmt --
    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish("ok" if exc_type is None else "error")


def init(project: str, config: Optional[Mapping[str, object]] = None,
         tags: Iterable[str] = (), **kwargs) -> Run:
    """Create a :class:`Run` and install it as the process-wide current
    run (``wandb.init`` semantics); ``finish()`` uninstalls it."""
    global _CURRENT
    run = Run(project, config, tags, **kwargs)
    _CURRENT = run
    return run


def current_run() -> Optional[Run]:
    """The process-wide active run, or None (producers' default tracker)."""
    if _CURRENT is not None and _CURRENT.finished:
        return None
    return _CURRENT


def read_events(path: str) -> List[Dict[str, object]]:
    """Parse an ``events.jsonl`` stream (whole-file convenience reader)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
