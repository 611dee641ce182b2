"""SLO-aware request scheduler: admission, chunked prefill, fairness.

The port's own copy of ``repro/serve/scheduler.py`` (framework-free, copied
whole).

Mirrors the cluster scheduler's shapes one level down: where
``cluster.scheduler`` admits *jobs* onto device pools, this admits
*requests* onto an engine's page pool and decode slots.

  * **admission queue** — requests wait until a decode slot and enough
    pages exist; prompts longer than the engine capacity are rejected at
    submit time (the request-level analogue of the cluster scheduler's
    analytic admission check);
  * **SLOs** — every request carries TTFT/TPOT targets.  Under the
    ``slo`` policy the prefill order is earliest-TTFT-deadline-first and
    admission order is (deadline, priority, arrival); ``priority`` and
    ``fcfs`` mirror the cluster queue's priority-FIFO ordering;
  * **chunked prefill** — long prompts are split into fixed
    ``prefill_chunk``-token chunks; each engine iteration runs at most
    ``prefill_batch`` chunks *alongside* the decode batch, so a 32k
    prompt no longer monopolizes a step and decode TPOT stays flat
    (Sarathi-style stall-free batching);
  * **token-budget packing** — ``iteration_plan()`` builds the fused
    iteration the continuous-batching engine runs: every decode row
    first (one token each — decode is never starved), then prefill
    chunks in policy order until ``token_budget`` new tokens are packed,
    clipping the last chunk to whatever budget remains.  A long prompt
    therefore spends many iterations trickling through the budget while
    queued short requests keep hitting their TTFT deadlines.

The scheduler owns ordering and lifecycle state; the engine owns device
steps and the page pool.  Per-request metrics (queue wait, TTFT, TPOT,
cached-token fraction) are recorded here and aggregated by
``cluster.telemetry.ServingStats``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

WAITING, PREFILL, DECODE, DONE, REJECTED, TIMED_OUT = (
    "waiting", "prefill", "decode", "done", "rejected", "timed_out")

POLICIES = ("slo", "priority", "fcfs")


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets (seconds)."""
    ttft_s: float = 1.0               # time to first token
    tpot_s: float = 0.25              # time per output token


@dataclasses.dataclass
class ServeRequest:
    """One inference request moving through the serving stack."""
    rid: int
    prompt: Sequence[int]             # token ids (any int sequence)
    max_new: int = 16
    slo: SLO = SLO()
    priority: int = 0
    # lifecycle (scheduler/engine-owned)
    state: str = WAITING
    out: List[int] = dataclasses.field(default_factory=list)
    n_cached: int = 0                 # prompt tokens served from the pool
    prefilled: int = 0                # prompt tokens computed or cached
    table: Optional[object] = None    # kvcache.BlockTable (paged) | slot id
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0              # first generated token
    t_last: float = 0.0
    why_rejected: str = ""

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state == DONE

    def ttft_deadline(self) -> float:
        return self.t_submit + self.slo.ttft_s

    # ------------------------------------------------------------ metrics --
    def queue_wait_s(self) -> float:
        return max(0.0, self.t_admit - self.t_submit)

    def ttft_s(self) -> float:
        return max(0.0, self.t_first - self.t_submit)

    def tpot_s(self) -> float:
        if len(self.out) <= 1:
            return 0.0
        return max(0.0, (self.t_last - self.t_first)) / (len(self.out) - 1)

    def slo_met(self) -> bool:
        ok = self.ttft_s() <= self.slo.ttft_s
        if len(self.out) > 1:
            ok = ok and self.tpot_s() <= self.slo.tpot_s
        return ok


class RequestScheduler:
    """Admission + per-iteration work selection for the serve engine."""

    def __init__(self, *, max_slots: int = 8, max_prompt: int = 512,
                 prefill_chunk: int = 64, prefill_batch: int = 2,
                 token_budget: Optional[int] = None, policy: str = "slo"):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.max_slots = max_slots
        self.max_prompt = max_prompt
        self.prefill_chunk = prefill_chunk
        self.prefill_batch = prefill_batch
        # fused-iteration packing cap: decode rows (1 token each) plus
        # prefill chunks must fit this many new tokens per iteration
        self.token_budget = (token_budget if token_budget is not None
                             else prefill_batch * prefill_chunk + max_slots)
        self.policy = policy
        self.waiting: Deque[ServeRequest] = deque()
        self.active: List[ServeRequest] = []      # PREFILL or DECODE
        self.finished: List[ServeRequest] = []
        self.rejected: List[ServeRequest] = []
        self.cancelled: List[ServeRequest] = []   # timed out / aborted

    # -------------------------------------------------------------- submit --
    def _reject(self, req: ServeRequest, why: str) -> bool:
        req.state = REJECTED
        req.why_rejected = why
        self.rejected.append(req)
        return False

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Admission check: the whole request (prompt + decode budget)
        must fit the engine capacity ``max_prompt``; never truncate."""
        req.t_submit = now
        if req.prompt_len == 0:
            return self._reject(req, "empty prompt")
        if req.max_new < 1:
            # the engine emits the first token from the prefill's last
            # hidden state, so a 0-token budget cannot be honored
            return self._reject(req, f"max_new {req.max_new} < 1")
        if req.prompt_len + req.max_new > self.max_prompt:
            return self._reject(
                req, f"prompt {req.prompt_len} + max_new {req.max_new} "
                     f"exceeds engine capacity {self.max_prompt}")
        req.state = WAITING
        self.waiting.append(req)
        return True

    # ------------------------------------------------------------ ordering --
    def _key(self, req: ServeRequest):
        if self.policy == "slo":
            return (req.ttft_deadline(), -req.priority, req.t_submit)
        if self.policy == "priority":
            return (-req.priority, req.t_submit, req.rid)
        return (req.t_submit, req.rid)

    # ----------------------------------------------------------- admission --
    def admit(self, now: float, try_open) -> List[ServeRequest]:
        """Admit waiting requests while slots and pages allow.

        ``try_open(req)`` is the engine callback that claims cache space
        (pages or a dense slot) and returns True on success; on False the
        head request keeps waiting (no backfill past a starved head —
        request sizes are near-uniform, so EASY-style reservations don't
        pay for themselves here).
        """
        admitted: List[ServeRequest] = []
        while self.waiting and len(self.active) < self.max_slots:
            head = min(self.waiting, key=self._key)
            if not try_open(head):
                break
            self.waiting.remove(head)
            head.state = PREFILL
            head.t_admit = now
            head.prefilled = head.n_cached
            self.active.append(head)
            admitted.append(head)
        return admitted

    # ------------------------------------------------------ work selection --
    def prefill_work(self) -> List[ServeRequest]:
        """Up to ``prefill_batch`` requests that still owe prompt tokens,
        in policy order — the chunk batch for this iteration."""
        owing = [r for r in self.active
                 if r.state == PREFILL and r.prefilled < r.prompt_len]
        owing.sort(key=self._key)
        return owing[:self.prefill_batch]

    def decode_work(self) -> List[ServeRequest]:
        return [r for r in self.active if r.state == DECODE]

    def iteration_plan(self) -> List[Tuple[ServeRequest, int]]:
        """The fused continuous-batching iteration: ``(request, n_new)``
        rows mixing decode and prefill in ONE batch.

        Decode rows always ride (one token each; a long prompt can never
        stall them past the budget), then prefill chunks pack the
        remaining ``token_budget`` in policy order — the last chunk is
        clipped to the budget, so TTFT-critical short prompts behind a
        long one still start this iteration.
        """
        plan: List[Tuple[ServeRequest, int]] = [
            (r, 1) for r in self.decode_work() if r.out]
        budget = self.token_budget - len(plan)
        owing = [r for r in self.active
                 if r.state == PREFILL and r.prefilled < r.prompt_len]
        owing.sort(key=self._key)
        for r in owing:
            if budget <= 0:
                break
            n = min(self.chunk_for(r), budget)
            plan.append((r, n))
            budget -= n
        return plan

    # ------------------------------------------------------------ lifecycle --
    def chunk_for(self, req: ServeRequest) -> int:
        """Tokens of ``req``'s next prefill chunk (<= prefill_chunk)."""
        return min(self.prefill_chunk, req.prompt_len - req.prefilled)

    def note_prefilled(self, req: ServeRequest, n_tokens: int,
                       now: float) -> None:
        req.prefilled += n_tokens
        if req.prefilled >= req.prompt_len:
            req.state = DECODE

    def note_token(self, req: ServeRequest, token: int, now: float) -> bool:
        """Record one generated token; returns True when the request just
        finished (the engine then releases its cache space)."""
        if not req.out:
            req.t_first = now
        req.t_last = now
        req.out.append(int(token))
        if len(req.out) >= req.max_new:
            req.state = DONE
            self.active.remove(req)
            self.finished.append(req)
            return True
        return False

    def cancel(self, req: ServeRequest, why: str = "cancelled") -> bool:
        """Pull a live request out of the scheduler (deadline expiry or
        client abort).  Returns True if it was still live; the engine
        then releases whatever cache space the request held — withOUT
        registering its half-written prefix pages for reuse."""
        if req in self.waiting:
            self.waiting.remove(req)
        elif req in self.active:
            self.active.remove(req)
        else:
            return False
        req.state = TIMED_OUT
        req.why_rejected = why
        self.cancelled.append(req)
        return True

    # -------------------------------------------------------------- queries --
    def all_done(self) -> bool:
        return not self.waiting and not self.active

    def n_pending(self) -> int:
        return len(self.waiting) + len(self.active)
