"""The wandb-style run-tracking plane, held against ``repro/tracking``.

Public surface::

    from repro_torch import tracking

    run = tracking.init("train-llama3.2-3b", config={...}, tags=("train",))
    run.log({"loss": 2.31}, step=10)
    run.log_system({"kv.pages_in_use": 42})
    run.log_summary({"final_loss": 2.1})
    run.finish()

Producers (the trainer's ``StepTracker``, the serving engine, the cluster
simulator) resolve :func:`current_run` as their default tracker, so running
them under a ``tracking.init(...)`` scope mirrors their telemetry into the
run's ``events.jsonl``.

The port's runs go to its own ``results/torch/runs``, never to the
reference's ``results/runs``.  The reference's trajectories and perf gate
(``repro/tracking/{trajectory,gate}.py``) come with the port's benchmark
harness, their first caller (ROADMAP).
"""
from .run import (SCHEMA_VERSION, Run, current_run, git_sha, init,
                  make_run_id, read_events)
from .sampler import CounterSampler, ProcSampler

__all__ = [
    "SCHEMA_VERSION", "Run", "init", "current_run", "git_sha",
    "make_run_id", "read_events", "ProcSampler", "CounterSampler",
]
