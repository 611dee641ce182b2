"""Elastic execution: failure -> recompose -> restore -> continue, held
against ``repro/train/elastic.py``.

This is the composable system's operational payoff (paper §II-C "devices
can be allocated and re-allocated dynamically"): when devices fail, the
pool is re-composed into a smaller (or re-fabric'd) system and training
resumes from the latest atomic checkpoint, so no part of the job is tied
to the dead composition.

``resume`` restores through ``train/checkpoint.restore`` in place: onto
the device the state lives on, or, given the new composition's mesh
(``ComposedSystem.mesh()``) and the state's specs there
(``trainer.state_specs``), each rank's pieces of every leaf -- the
reference's restore onto a ``jax`` mesh.

Straggler mitigation: the data pipeline re-issues a shard when a simulated
host exceeds the straggler deadline (tail-latency duplication, the standard
mitigation at pod scale); the cost model prices stragglers through the
per-axis latency term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

from repro_torch.core.compose import (ComposedSystem,
                                      CompositionError, recompose,
                                      shrink_to_pool)
from repro_torch.core.topology import DevicePool
from repro_torch.train import checkpoint, sharding


@dataclasses.dataclass
class ElasticEvent:
    step: int
    kind: str                      # "failure" | "recompose" | "restore"
    detail: str = ""


@dataclasses.dataclass
class ElasticRun:
    """Bookkeeping for one elastic training run."""
    system: ComposedSystem
    ckpt_dir: str
    events: List[ElasticEvent] = dataclasses.field(default_factory=list)

    def log(self, step: int, kind: str, detail: str = "") -> None:
        self.events.append(ElasticEvent(step, kind, detail))


def handle_failure(run: ElasticRun, pool: DevicePool,
                   failed_uids: Sequence[int], *, step: int,
                   shrink_axis: str = "data") -> ComposedSystem:
    """Mark devices failed, recompose (shrinking ``shrink_axis`` if the
    pool no longer covers the old shape), and return the new system.

    The caller then restores the latest checkpoint (``resume``) and
    carries on stepping on the new system.
    """
    pool.mark_failed(failed_uids)
    run.log(step, "failure", f"uids={list(failed_uids)}")
    try:
        new_sys = recompose(pool, run.system)
        detail = "same-shape recompose (spare devices)"
    except CompositionError:
        new_sys = shrink_to_pool(pool, run.system, shrink_axis)
        detail = (f"shrunk {shrink_axis}: "
                  f"{dict(zip(new_sys.axis_names, new_sys.axis_sizes))}")
    run.log(step, "recompose", detail)
    run.system = new_sys
    return new_sys


def preempt(run: ElasticRun, pool: DevicePool, *, step: int,
            detail: str = "") -> None:
    """Give the composition back to the pool (job preempted / unschedulable).

    When even a 1-wide mesh no longer fits the pool, the job's devices
    must return to the shared inventory so other tenants can claim them;
    the job itself re-queues and later resumes from its checkpoint via
    the normal ``recompose -> restore`` path.
    """
    pool.release(run.system.device_uids)
    run.log(step, "preempt", detail or "released composition to pool")


def regrow(run: ElasticRun, new_system: ComposedSystem, *, step: int,
           detail: str = "") -> ComposedSystem:
    """Adopt a larger recomposed system after a repair returned capacity.

    The inverse of the ``handle_failure`` shrink: the cluster scheduler
    recomposes a failure-shrunk job back toward its submitted budget
    (``Scheduler.regrow_shrunk``) and the run resumes from its last
    checkpoint boundary under the wider composition.
    """
    run.system = new_system
    run.log(step, "recompose",
            detail or (f"regrow after repair: "
                       f"{dict(zip(new_system.axis_names, new_system.axis_sizes))}"))
    return new_system


def resume(run: ElasticRun, like_state: Any, mesh=None, specs=None
           ) -> Tuple[Any, int]:
    """Restore the latest checkpoint of ``run`` into ``like_state`` (a
    ``TrainState``, module or dict of tensors), in place; returns ``(state,
    step)``.  With ``mesh`` and ``specs`` (a state laid out on the new
    mesh, ``init_state(..., mesh=)``, and ``trainer.state_specs`` there)
    each rank takes its pieces, as the reference's restore onto the new
    composition's mesh."""
    state, step = checkpoint.restore(run.ckpt_dir, like_state, mesh=mesh,
                                     specs=specs)
    where = (dict(sharding.mesh_axes(mesh)) if mesh is not None
             else _device_of(state))
    run.log(step, "restore", f"onto {where}")
    return state, step


def _device_of(state: Any) -> str:
    leaf = next(t for t in checkpoint._leaves(state).values()
                if hasattr(t, "device"))
    return str(leaf.device)


# ---------------------------------------------------------------------------
# straggler mitigation (data-path duplication)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StragglerPolicy:
    """Duplicate a shard read when it exceeds ``deadline_factor`` x median.

    At 1000+ nodes the slowest host dominates step time; issuing a backup
    read after the deadline caps the tail at ~2x the median read.  The
    pipeline consults ``should_duplicate`` per shard; see data/pipeline.py.
    """
    deadline_factor: float = 2.0
    max_duplicates: int = 1

    def should_duplicate(self, elapsed: float, median: float,
                         already: int) -> bool:
        return (already < self.max_duplicates
                and elapsed > self.deadline_factor * max(median, 1e-9))

    def expected_tail_time(self, median: float, p999: float) -> float:
        """Tail-read completion bound under duplication."""
        return min(p999, self.deadline_factor * median + median)
