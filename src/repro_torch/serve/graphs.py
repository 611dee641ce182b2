"""One program per serving step: CUDA graphs of the engine's steps.

This stands for the reference's ``jax.jit`` of its serving steps
(``repro/serve/engine.py:157-159, 301-302, 310-313``: the dense prefill and
decode, the fused paged step); the reference has no module of its own for
it.  Where ``jit`` traces a step once per input shape and replays the
compiled program, ``StepGraphs`` captures a step once per *key* (the step's
kind and its padded shape) into a ``torch.cuda.CUDAGraph`` and replays it:
one launch from the host per step instead of one per kernel.

Per key it holds:

  * static inputs: every input of a step is int32 (tokens, positions, block
    tables, valid flags, lengths).  They are laid end to end in one device
    buffer; a step's host arrays are written into one pinned int32 staging
    tensor and sent in **one** non-blocking copy, then read by the graph
    through views of that buffer;
  * the graph and its static outputs (whatever the step returns: next
    tokens, logits, a prefill's caches).  All graphs share one memory pool
    (``torch.cuda.graph_pool_handle()``): replays run one after another on
    one stream, and every graph's outputs stay allocated, so no replay
    writes over another graph's outputs.  A graph's outputs hold until the
    same key replays again;
  * the launch counts that the capture recorded.  The kernel wrappers count
    launches on the host (``kernels/ops.py``), and a replay calls no
    wrapper, so each replay adds the captured delta back
    (``ops.add_launch_counts``); a capture itself launches nothing and
    leaves the counts as they were.

Capture happens in ``prepare`` (the engine's ``warmup()``), or at a key's
first use where no warm-up saw it.  Before each capture the step runs once
eagerly on the capture's side stream: that builds the kernels, raises their
shared-memory limits, fills the RoPE table cache and lets the libraries set
up their workspaces, none of which may happen inside a capture.  A capture
or replay that fails raises: nothing falls back to eager execution.

With ``capture=False`` (``AsyncServeEngine(graphs=False)``, the counterpart
of ``jax.disable_jit()``), and on the CPU, the same static-buffer code runs
and the step function is called instead of a replay.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


def uncounted(fn: Callable, *args) -> Tuple[Any, Dict[str, int]]:
    """``fn(*args)`` and the launch counts it added, taken back out of the
    counters: what a capture records (it launches nothing on the device)
    and a replay adds."""
    before = ops.launch_counts()
    out = fn(*args)
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    ops.add_launch_counts({k: -v for k, v in delta.items()})
    return out, delta


class _Step:
    """One key's static buffers, and its graph where one was captured."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: torch.device):
        self.shapes = {n: np.shape(a) for n, a in arrays.items()}
        sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes.values()]
        total = sum(sizes)
        cuda = device.type == "cuda"
        self.host = torch.empty(total, dtype=torch.int32, pin_memory=cuda)
        self.host_np = self.host.numpy()
        self.dev = torch.empty(total, dtype=torch.int32, device=device)
        self.spans = []
        self.inputs = []
        at = 0
        for shape, n in zip(self.shapes.values(), sizes):
            self.spans.append((at, at + n))
            self.inputs.append(self.dev[at:at + n].view(shape))
            at += n
        # the staging copy in flight, so that the next step's host writes
        # wait for it
        self.copied = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.delta: Dict[str, int] = {}

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        if self.copied is not None:
            self.copied.synchronize()
        for (lo, hi), (name, a) in zip(self.spans, arrays.items()):
            if np.shape(a) != self.shapes[name]:
                raise ValueError(f"step input {name!r} has shape "
                                 f"{np.shape(a)}, its key {self.shapes[name]}")
            self.host_np[lo:hi] = np.asarray(a, dtype=np.int32).reshape(-1)
        self.dev.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


class StepGraphs:
    """One program per step key (see the module docstring).

    ``run(key, fn, arrays)`` stages ``arrays`` (name -> int array, the same
    names and shapes every time for a key) into the key's static buffers and
    replays its graph, or calls ``fn(*inputs)`` where there is none.
    ``capture`` asks for graphs; they exist only on a CUDA device.
    """

    def __init__(self, device: torch.device, *, capture: bool = True):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self._steps: Dict[Hashable, _Step] = {}
        self.used: Counter = Counter()     # key -> steps run (replays + calls)
        self.capture_s = 0.0               # eager first runs + captures
        self.pool_bytes = 0                # memory_allocated delta of captures
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    @property
    def n_graphs(self) -> int:
        return sum(s.graph is not None for s in self._steps.values())

    def graph(self, key: Hashable) -> Optional[torch.cuda.CUDAGraph]:
        """``key``'s captured graph, or None (not prepared, or eager)."""
        step = self._steps.get(key)
        return None if step is None else step.graph

    def prepare(self, key: Hashable, fn: Callable,
                arrays: Dict[str, np.ndarray], *, capture: bool = True
                ) -> None:
        """Make ``key``'s static buffers, run the step once on ``arrays``
        (example inputs whose effects the caller accepts) and capture it
        where graphs are on and ``capture``.  A prepared key is left as it
        is."""
        if key not in self._steps:
            self._first(key, fn, arrays, capture)

    def _first(self, key, fn, arrays, capture):
        """A key's first step: static buffers, the step run eagerly (its
        outputs are returned: it was a real step), then the capture."""
        step = _Step(arrays, self.device)
        step.stage(arrays)
        if not (self.capture and capture):
            self._steps[key] = step
            return fn(*step.inputs)
        t0 = time.perf_counter()
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*step.inputs)
        cur.wait_stream(side)
        alloc = torch.cuda.memory_allocated(self.device)
        graph = torch.cuda.CUDAGraph()

        def captured():
            # capture_begin / capture_end, not ``torch.cuda.graph``: that
            # one synchronizes and empties the allocator's cache at every
            # capture, and a warm-up captures dozens
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool)
                try:
                    return fn(*step.inputs)
                finally:
                    graph.capture_end()

        step.outputs, step.delta = uncounted(captured)
        cur.wait_stream(side)
        step.graph = graph
        self._steps[key] = step           # only once it is captured
        self.pool_bytes += torch.cuda.memory_allocated(self.device) - alloc
        self.capture_s += time.perf_counter() - t0
        return out

    def run(self, key: Hashable, fn: Callable, arrays: Dict[str, np.ndarray],
            *, capture: bool = True) -> Any:
        """One step: its outputs (a replay's are the graph's static outputs,
        valid until ``key`` runs again)."""
        self.used[key] += 1
        step = self._steps.get(key)
        if step is None:
            return self._first(key, fn, arrays, capture)
        step.stage(arrays)
        if step.graph is None:
            return fn(*step.inputs)
        step.graph.replay()
        ops.add_launch_counts(step.delta)
        return step.outputs

    def report(self) -> Dict[str, Any]:
        return {"enabled": self.capture, "graphs": self.n_graphs,
                "keys": len(self._steps), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}
