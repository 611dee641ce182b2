"""Serving engine: prefill + decode steps over KV caches, held against
``repro/serve/engine.py``.

Two engines sit on top of the steps:

  * ``ServeEngine`` -- the dense-slot baseline: sequences occupy slots of a
    fixed-size batch with per-slot ``max_seq``-wide caches;
  * ``AsyncServeEngine`` -- the production shape: a paged KV cache
    (``serve.kvcache``: shared page pool, block tables, prefix-hash reuse),
    an SLO-aware request scheduler (``serve.scheduler``) with chunked prefill
    interleaved against the decode batch, and per-request telemetry
    (``cluster.telemetry.ServingStats``).

Where the kernels sit (``attn_impl="kernel"``):

  * an iteration whose rows are all decode rows reads the page pool
    directly: per layer the new token's K/V/pos are written into the pool
    pages and ``kernels.ops.paged_attention`` attends through the block
    tables -- the dense view is never built;
  * iterations that carry prefill chunks keep the reference's gather ->
    ``chunk_decode_attention`` -> scatter in plain PyTorch;
  * one-shot prefill (``make_prefill_step``: ``ServeEngine`` and the dense
    mode) runs the flash-attention kernel (with the window for
    ``attn_local`` layers), the SSD kernel for ``ssm`` layers and the RG-LRU
    kernel for ``rglru`` layers; their decode steps are plain PyTorch over
    ring buffers and recurrent states, as in the reference.

With ``attn_impl="full"`` every path runs its plain version: the oracle.

Where the reference jits a step (``jax.jit``: one program per input shape),
``AsyncServeEngine`` runs it through ``serve.graphs.StepGraphs``: one CUDA
graph per step key, captured in ``warmup()`` and replayed per step.  Its
steps are padded to the reference's power-of-two buckets, which keep the
keys few: batch rows to ``min(bucket_pow2(B, floor=1), n_slots)``, block
tables to ``min(bucket_pow2(pages, floor=1), pages_for(max_seq))`` and
dense-mode prompts to ``min(bucket_pow2(L, floor=16), max_seq)``.  Graphs
hold the paged decode step (width 1), the dense decode step and the dense
bucketed prefill; the paged step with prefill chunks runs eagerly, bucketed
all the same.  ``graphs=False`` runs every step eagerly through the same
static buffers (the counterpart of ``jax.disable_jit()``), as the CPU does.

Under a ``mesh`` the engine runs the model's tensor-parallel paths
(``models/transformer.ParallelCtx``): each rank holds its pieces of the
parameters (``MeshPlacement``; a leaf the rule splits along another dim
than its block's work is kept whole).  ``ServeEngine`` and the dense mode
hold their pieces of the caches, placed by
``core/policy.placed_cache_specs`` (slots over the dp axes where they
divide, the attention cache's length and the recurrent leaves' channels
over the tp axis).  Every
rank runs the same host program on the same requests: a decode step runs
the rank's slots and gathers every slot's logits (the vocabulary over the
tp axis, the slots over the dp axes), so every rank samples the same
tokens; a one-row prefill runs on every rank of the dp axes and is written
into its slot by the rank that holds it.  Steps under a mesh run eagerly
(no CUDA graphs: the collectives count per call).  The paged mode splits
heads over the tp axis: each rank's pool holds the KV heads its query
heads read (``serve/kvcache.PagePool(kv_heads=)``), the page tables and
the scheduler are the host's and the same on every rank, and every rank
serves every row; a mesh whose other axes exceed 1 raises
(``_check_paged_mesh``).

Other differences from the reference: caches and the pool are updated in
place, and the parameters are cast to the compute dtype **once**, when the
engine is built (``LM.cast_weights_``), instead of on every call -- same
values, same arithmetic.  Engines run on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cluster.telemetry import ServingStats
from repro_torch.configs.base import ATTN, ModelConfig, PolicyConfig
from repro_torch.kernels.registry import bucket_pow2
from repro_torch.models.attention import PagedDecodeCache, pool_kv_heads
from repro_torch.models.lm import LM, require_device
from repro_torch.models import transformer
from repro_torch.serve import kvcache
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.scheduler import (DECODE, PREFILL, RequestScheduler,
                                         ServeRequest)
from repro_torch.train.trainer import make_run_ctx


def _place(model: LM, device) -> torch.device:
    dev = require_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model lies on {model.device} but the engine "
                         f"was asked to run on {dev}")
    return model.device


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------
class MeshPlacement:
    """An engine's pieces on ``mesh``: the parameters each rank computes
    with (``train/sharding.Layout.use_specs``) and each dense cache leaf's
    spec (``core/policy.placed_cache_specs`` over ``n_slots`` slots), the
    ``ParallelCtx`` the steps run under, and the slots' dp rows."""

    def __init__(self, cfg: ModelConfig, policy: PolicyConfig, mesh,
                 n_slots: int, max_seq: int):
        from repro_torch.core import policy as pol
        from repro_torch.train import sharding
        self.mesh = mesh
        layout = sharding.Layout(cfg, dataclasses.replace(
            policy, zero_stage=0), mesh)
        self.use_specs, self.pctx = layout.use_specs, layout.pctx
        self.traffic = layout.traffic
        meta = transformer.init_stack_cache(cfg, n_slots, max_seq,
                                            device="meta")
        self.cache_specs = pol.placed_cache_specs(
            meta, policy, layout.axes,
            tp_min=sharding.tp_min(policy, layout.axes))
        entries = {spec[0] for row in self.cache_specs
                   for spec in row.values()}
        if len(entries) != 1:
            raise ValueError(f"cache leaves split their slots differently: "
                             f"{entries}")
        self.dp_entry = entries.pop()
        self.n_slots = n_slots

    @property
    def moe_dp(self):
        """The dp axes that split the slots (``RunCtx.moe_dp``)."""
        from repro_torch.core.policy import entry_axes
        return entry_axes(self.dp_entry)

    def lay_out(self, model: LM) -> LM:
        """Cut ``model``'s parameters (whole) to this rank's pieces."""
        from repro_torch.train.sharding import piece
        for n, p in model.named_parameters():
            if any(e is not None for e in self.use_specs[n]):
                p.data = piece(p.data, self.use_specs[n], self.mesh).clone()
        return model

    def caches(self, whole):
        """This rank's pieces of whole per-layer caches."""
        from repro_torch.train.sharding import piece
        return [{n: piece(t, self.cache_specs[i][n], self.mesh).clone()
                 for n, t in layer.items()} for i, layer in enumerate(whole)]

    def rows(self, t):
        """This rank's slots of a (n_slots, ...) host or device array."""
        from repro_torch.train.sharding import piece
        return piece(t, (self.dp_entry,), self.mesh) if self.dp_entry \
            else t

    def join_rows(self, t):
        """Every slot's rows from each rank's (an all-gather over the dp
        axes that split the slots)."""
        if not self.dp_entry:
            return t
        from repro_torch.core import hierarchy
        from repro_torch.core.policy import entry_axes
        return hierarchy.all_gather(t, self.pctx.group(
            entry_axes(self.dp_entry)), 0)

    def scatter_slot(self, caches, one, slot: int) -> None:
        """``kvcache.scatter_slot`` on the rank that holds ``slot``."""
        if not self.dp_entry:
            kvcache.scatter_slot(caches, one, slot)
            return
        from repro_torch.train.sharding import _index
        n = caches[0][next(iter(caches[0]))].shape[0]
        if slot // n == _index(self.dp_entry, self.mesh):
            kvcache.scatter_slot(caches, one, slot % n)


def _check_paged_mesh(mesh, policy: PolicyConfig, prefill_chunk: int):
    """The paged mode's mesh: a tp axis (any size; heads over it) and every
    other axis of size 1.  The reference runs one replicated program on a
    mesh whose dp axes exceed 1, and a router over replicas is no part of
    it; a chunk of one token a row would take the dense engines' decode
    path, whose cache splits length, not heads."""
    wide = {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)
            if a != policy.tp_axis and int(n) > 1}
    if wide:
        raise NotImplementedError(
            f"paged serving on a mesh whose axes {wide} exceed 1 is not "
            f"ported: the reference runs one replicated program there and "
            f"routes no requests over replicas (ROADMAP queue A item 7); "
            f"use mode='dense' or one engine a replica")
    if prefill_chunk < 2:
        raise ValueError("paged serving on a mesh takes prefill chunks of "
                         "2 tokens or more")


def make_prefill_step(cfg: ModelConfig, policy: PolicyConfig, *,
                      cache_capacity: int, mesh=None,
                      bucketed: bool = False, pctx=None) -> Callable:
    """prefill(model, tokens) -> (last-token logits, caches).

    ``bucketed=True`` returns ``prefill(model, tokens, length)`` for
    pow2-padded prompts: ``tokens`` (B, S_bucket) right-padded, ``length``
    (B,) int real lengths.  Padded columns never reach a real query row
    (causal mask), the caches mark them empty, and the logits are read at
    ``length - 1``.
    """
    ctx = dataclasses.replace(
        make_run_ctx(cfg, policy, mesh, seq_len=cache_capacity),
        cache_capacity=cache_capacity)
    if pctx is not None:
        ctx = dataclasses.replace(ctx, pctx=pctx)

    @torch.no_grad()
    def prefill(model: LM, tokens):
        hidden, caches, _ = model(tokens, ctx, caches="init",
                                  return_hidden=True)
        return model.logits(hidden[:, -1:], ctx), caches

    @torch.no_grad()
    def prefill_bucketed(model: LM, tokens, length):
        B, S = tokens.shape[0], tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        mask = positions < length[:, None]
        hidden, caches, _ = model(tokens, ctx, positions=positions,
                                  caches="init", kv_mask=mask,
                                  return_hidden=True)
        last = hidden[torch.arange(B, device=tokens.device),
                      length.long() - 1][:, None]
        return model.logits(last, ctx), caches

    return prefill_bucketed if bucketed else prefill


def make_decode_step(cfg: ModelConfig, policy: PolicyConfig, mesh=None,
                     max_seq: Optional[int] = None,
                     batch: Optional[int] = None, pctx=None,
                     moe_dp=()) -> Callable:
    """decode(model, caches, tokens, positions) -> (logits, caches).

    tokens (B, 1) int; positions (B, 1) int.  The caches are updated in
    place and handed back; their capacity is ``max_seq``.  Under a mesh's
    tp axis the logits are the whole vocabulary's.  ``moe_dp``: the dp
    axes that split the slots (``RunCtx.moe_dp``)."""
    ctx = make_run_ctx(cfg, policy, mesh, seq_len=max_seq, decode=True,
                       batch=batch)
    ctx = dataclasses.replace(ctx, cache_capacity=max_seq or 0,
                              moe_dp=tuple(moe_dp))
    if pctx is not None:
        ctx = dataclasses.replace(ctx, pctx=pctx)

    @torch.no_grad()
    def decode(model: LM, caches, tokens, positions):
        hidden, new_caches, _ = model(tokens, ctx, positions=positions,
                                      caches=caches, return_hidden=True)
        return model.logits(hidden, ctx), new_caches

    return decode


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device="cuda"):
    return transformer.init_stack_cache(cfg, batch, max_seq, dtype,
                                        require_device(device))


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]


def pow2_buckets(top: int, floor: int = 1) -> List[int]:
    """Every ``min(bucket_pow2(n, floor), top)`` for n in 1..top: the padded
    sizes, hence the step keys, a dimension capped at ``top`` can take."""
    out, b = [], floor
    while b < top:
        out.append(b)
        b *= 2
    return out + [top]


# ---------------------------------------------------------------------------
# slot-based continuous batching
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor           # (S,) int
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Minimal continuous-batching server over the decode step.

    Slots are prefilling/decoding independently: a finished sequence frees
    its slot immediately (no head-of-line blocking)."""

    def __init__(self, cfg: ModelConfig, model: LM, policy: PolicyConfig, *,
                 n_slots: int = 4, max_seq: int = 512, mesh=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = _place(model, device)
        self.policy = policy
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.ctx_dtype = torch.bfloat16 \
            if policy.compute_dtype == "bfloat16" else torch.float32
        self.place = MeshPlacement(cfg, policy, mesh, n_slots, max_seq) \
            if mesh is not None else None
        pctx = self.place.pctx if self.place is not None else None
        if self.place is not None:
            self.place.lay_out(model)
        self.model = model.cast_weights_(self.ctx_dtype).eval()
        self.decode = make_decode_step(
            cfg, policy, mesh, max_seq=max_seq, pctx=pctx,
            moe_dp=self.place.moe_dp if self.place is not None else ())
        self.prefill = make_prefill_step(cfg, policy, cache_capacity=max_seq,
                                         mesh=mesh, pctx=pctx)
        self.caches = init_caches(cfg, n_slots, max_seq, self.ctx_dtype,
                                  self.device)
        if self.place is not None:
            self.caches = self.place.caches(self.caches)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = [0] * n_slots
        self.slot_tok = [0] * n_slots

    def add_request(self, req: Request) -> bool:
        for s, cur in enumerate(self.slot_req):
            if cur is None:
                self._prefill_into_slot(s, req)
                return True
        return False

    def _prefill_into_slot(self, s: int, req: Request) -> None:
        toks = torch.as_tensor(req.prompt, dtype=torch.int32,
                               device=self.device)[None, :]
        logits, caches = self.prefill(self.model, toks)
        nxt = int(greedy_sample(logits)[0, 0])
        if self.place is not None:
            self.place.scatter_slot(self.caches, caches, s)
        else:
            kvcache.scatter_slot(self.caches, caches, s)
        self.slot_req[s] = req
        self.slot_pos[s] = int(toks.shape[1])
        self.slot_tok[s] = nxt
        req.out.append(nxt)

    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        toks = torch.tensor(self.slot_tok, dtype=torch.int32,
                            device=self.device)[:, None]
        pos = torch.tensor(self.slot_pos, dtype=torch.int32,
                           device=self.device)[:, None]
        if self.place is not None:
            toks, pos = self.place.rows(toks), self.place.rows(pos)
        logits, self.caches = self.decode(self.model, self.caches, toks, pos)
        if self.place is not None:
            logits = self.place.join_rows(logits)
        nxt = greedy_sample(logits)[:, 0].tolist()
        self.slot_tok = nxt
        for s in active:
            self.slot_pos[s] += 1
            req = self.slot_req[s]
            req.out.append(nxt[s])
            if len(req.out) >= req.max_new:
                req.done = True
                self.slot_req[s] = None
        return len(active)


# ---------------------------------------------------------------------------
# AsyncServeEngine: paged KV cache + SLO scheduler + chunked prefill
# ---------------------------------------------------------------------------
class AsyncServeEngine:
    """Production-shaped serving engine.

    One ``step()`` is one engine iteration.  In the default **fused** mode
    (true continuous batching) admission is followed by a SINGLE step over a
    mixed batch: every decode row (one token each) plus prefill chunks
    packed up to the scheduler's ``token_budget``
    (``RequestScheduler.iteration_plan``) -- prefill never runs as a separate
    step that stalls decode.  ``fused=False`` keeps the two-step iteration
    (one batched prefill-chunk step, then one batched decode step) as the
    comparison baseline; both orderings produce the same fp32 logits per
    request because masking is purely positional.

    ``warmup()`` builds and first-launches the kernels (and the libraries'
    own first-call set-up) and captures a CUDA graph of every step key
    (``serve.graphs``) so latency percentiles measure steady state; that
    time is reported separately (``report()["compile_s"]``, and the
    captures' seconds, count and pool bytes under ``report()["graphs"]``).
    A replay adds its captured launches to the counts, so a caller that
    counts the launches of the served path sets the counts to zero after
    ``warmup()`` and reads them as if every step had run eagerly.
    ``graphs=False`` serves eagerly (for comparisons); with graphs on a CUDA
    device a capture or replay that fails raises.

    Execution modes:
      * ``paged``  -- all-attention architectures: block tables over a
        shared page pool.  Pure-decode iterations attend straight off the
        pool (paged decode kernel); iterations with prefill chunks gather
        the dense view, run the stack and scatter the new K/V back.  A
        prefix-cache hit simply starts the first chunk at the first uncached
        token;
      * ``dense``  -- per-slot dense caches (the ``ServeEngine`` layout:
        ring buffers for windowed layers, conv tails and states for the
        recurrent ones) under the same scheduler, admission and telemetry;
        one-shot pow2-bucketed prefill through the kernels; no paging or
        prefix reuse.

    ``mode="auto"`` picks ``paged`` for all-attention patterns and ``dense``
    for every other (ring-buffer or recurrent caches do not page).
    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).

    ``tracker`` is an optional ``repro_torch.tracking.Run`` (default: the
    process-wide ``tracking.current_run()``); with one active, every
    ``track_every`` engine iterations one windowed metrics row is logged
    plus a sample of KV-page occupancy.
    """

    def __init__(self, cfg: ModelConfig, model: LM, policy: PolicyConfig, *,
                 n_slots: int = 4, max_seq: int = 512, page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 64,
                 prefill_batch: int = 2, token_budget: Optional[int] = None,
                 fused: bool = True, sched_policy: str = "slo",
                 mode: str = "auto", mesh=None, clock=None,
                 tracker=None, track_every: int = 16,
                 request_timeout_s: float = 0.0, graphs: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.device = _place(model, device)
        self.policy = policy
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.fused = fused
        # under a mesh the steps run eagerly: their collectives count per
        # call
        self.graphs = StepGraphs(self.device,
                                 capture=graphs and mesh is None)
        self.request_timeout_s = request_timeout_s
        self._draining = False
        self.clock = clock or time.monotonic
        self.ctx_dtype = torch.bfloat16 \
            if policy.compute_dtype == "bfloat16" else torch.float32
        if mode == "auto":
            mode = "paged" if all(b == ATTN for b in cfg.pattern) \
                else "dense"
        self.mode = mode
        self.place = None
        if mesh is not None:
            if mode == "paged":
                _check_paged_mesh(mesh, policy, prefill_chunk)
            self.place = MeshPlacement(cfg, policy, mesh, n_slots, max_seq)
            self.place.lay_out(model)
        self.model = model.cast_weights_(self.ctx_dtype).eval()
        self.sched = RequestScheduler(
            max_slots=n_slots, max_prompt=max_seq,
            prefill_chunk=prefill_chunk, prefill_batch=prefill_batch,
            token_budget=token_budget, policy=sched_policy)
        self.stats = ServingStats()
        self.compile_s = 0.0           # accumulated warmup() time
        self._util_sum = 0.0           # sum of per-iteration utilization
        ctx = make_run_ctx(cfg, policy, mesh, seq_len=max_seq, decode=True,
                           batch=n_slots)
        self.ctx = dataclasses.replace(ctx, cache_capacity=max_seq)
        pctx = self.place.pctx if self.place is not None else None
        if pctx is not None:
            self.ctx = dataclasses.replace(self.ctx, pctx=pctx)
        self._iters = 0
        self._decode_iters = 0         # paged steps whose rows all decode
        self.tracker = tracker
        self.track_every = max(int(track_every), 1)
        self._win_completed = 0
        self._win_tokens = 0
        self._win_t: Optional[float] = None
        if self.mode == "paged":
            # under a tp axis each rank's pool holds its heads' KV heads
            kv_heads = None if pctx is None or not pctx.tp_on else \
                pool_kv_heads(cfg.n_heads, cfg.n_kv_heads, pctx.tp)
            self.pool = kvcache.PagePool(
                cfg,
                n_pages=n_pages or n_slots * (-(-max_seq // page_size)),
                page_size=page_size, dtype=self.ctx_dtype,
                device=self.device, kv_heads=kv_heads)
        else:
            self.pool = None
            self.caches = init_caches(cfg, n_slots, max_seq, self.ctx_dtype,
                                      self.device)
            if self.place is not None:
                self.caches = self.place.caches(self.caches)
            # a decode graph reads and writes these tensors: the decode step
            # must update them in place, never rebind them
            self._cache_leaves = [(layer, name, leaf)
                                  for layer in self.caches
                                  for name, leaf in layer.items()]
            self.slot_req: List[Optional[ServeRequest]] = [None] * n_slots
            # pow2-bucketed one-shot prefill: prompts are right-padded to
            # the next power of two (few distinct kernel shapes)
            self.prefill = make_prefill_step(
                cfg, policy, cache_capacity=max_seq, mesh=mesh,
                bucketed=True, pctx=pctx)
            self.decode = make_decode_step(
                cfg, policy, mesh, max_seq=max_seq, batch=n_slots,
                pctx=pctx,
                moe_dp=self.place.moe_dp if self.place is not None else ())

    # ------------------------------------------------------------ plumbing --
    def now(self) -> float:
        return self.clock()

    def submit(self, req: ServeRequest) -> bool:
        """Admission-queue a request; False = rejected (with reason in
        ``req.why_rejected`` -- the scheduler owns the capacity check)."""
        now = self.now()
        self.stats.mark(now)
        self.stats.requests_submitted += 1
        if self._draining:
            req.t_submit = now
            req.state = "rejected"
            req.why_rejected = "engine draining (planned detach)"
            self.sched.rejected.append(req)
            self.stats.requests_rejected += 1
            return False
        ok = self.sched.submit(req, now)
        if not ok:
            self.stats.requests_rejected += 1
        return ok

    def drain(self) -> None:
        """Planned detach announced: stop admitting new requests and let
        the in-flight ones finish (``run()`` then returns once the
        admitted population drains)."""
        self._draining = True

    def _expire_timeouts(self, now: float) -> None:
        """Cancel every request older than ``request_timeout_s`` and give
        its cache space back.  Half-written prefix pages are NOT
        registered for reuse -- a timed-out prompt must not poison the
        prefix cache."""
        if self.request_timeout_s <= 0:
            return
        for req in (list(self.sched.waiting) + list(self.sched.active)):
            if now - req.t_submit <= self.request_timeout_s:
                continue
            was_active = req.state in (PREFILL, DECODE)
            if not self.sched.cancel(
                    req, f"timed out after {self.request_timeout_s:g}s"):
                continue
            self.stats.requests_timed_out += 1
            self.stats.requests_failed += 1
            if was_active and req.table is not None:
                if self.mode == "paged":
                    self.pool.release(req.table)
                else:
                    self.slot_req[req.table] = None
                req.table = None

    def _try_open(self, req: ServeRequest) -> bool:
        if self.mode == "paged":
            try:
                table, n_cached = self.pool.open_sequence(
                    req.prompt, req.max_new)
            except kvcache.PageError:
                return False
            req.table, req.n_cached = table, n_cached
            return True
        for s, cur in enumerate(self.slot_req):
            if cur is None:
                self.slot_req[s] = req
                req.table = s
                return True
        return False

    def _finish(self, req: ServeRequest, now: float) -> None:
        if self.mode == "paged":
            self.pool.close_sequence(req.prompt, req.table)
            req.table = None
        else:
            self.slot_req[req.table] = None
        self.stats.add_request(
            t_done=now, wait_s=req.queue_wait_s(), ttft_s=req.ttft_s(),
            tpot_s=req.tpot_s(), prompt_tokens=req.prompt_len,
            cached_tokens=req.n_cached, output_tokens=len(req.out),
            slo_ok=req.slo_met())

    # ------------------------------------------------------- paged stepping --
    @torch.no_grad()
    def _paged_step(self, tables, toks, positions, valid, last_idx,
                    dense_view: bool):
        """One paged step; returns (greedy next tokens at ``last_idx``,
        logits there).

        ``dense_view=True`` (prefill chunks, any row width): gather the
        dense view, run the stack, scatter the new K/V back to the pool.
        ``dense_view=False`` (row width 1): every layer writes the new
        token into its pool pages and attends straight off the pool."""
        pool = self.pool
        if dense_view:
            dense = kvcache.gather_dense(pool.pages, tables)
            hidden, new_caches, _ = self.model(
                toks, self.ctx, positions=positions, caches=dense,
                return_hidden=True)
            kvcache.scatter_tokens(pool.pages, new_caches, tables, positions,
                                   valid, pool.page_size, pool.trash)
        else:
            ok = valid[:, 0]
            pos0 = positions[:, 0].long()
            rows = torch.arange(toks.shape[0], device=self.device)
            page = torch.where(
                ok, tables.long()[rows, pos0 // pool.page_size], pool.trash)
            slot = page * pool.page_size + pos0 % pool.page_size
            new_pos = torch.where(ok, positions[:, 0], -1)
            lengths = torch.where(ok, positions[:, 0] + 1, 0)
            caches = [PagedDecodeCache(
                k=layer["k"], v=layer["v"], pos=layer["pos"], tables=tables,
                slot=slot, new_pos=new_pos, lengths=lengths)
                for layer in pool.pages]
            hidden, _, _ = self.model(
                toks, self.ctx, positions=positions, caches=caches,
                return_hidden=True)
        h = hidden[torch.arange(toks.shape[0], device=self.device),
                   last_idx.long()]
        logits = self.model.logits(h, self.ctx)
        return logits.argmax(dim=-1).to(torch.int32), logits

    def _decode_rows_step(self, tables, toks, positions, valid, last_idx):
        return self._paged_step(tables, toks, positions, valid != 0,
                                last_idx, dense_view=False)

    def _chunk_rows_step(self, tables, toks, positions, valid, last_idx):
        return self._paged_step(tables, toks, positions, valid != 0,
                                last_idx, dense_view=True)

    def _table_width(self, reqs: List[ServeRequest], span: int) -> int:
        """The reference's bucketed block-table width, ``min(bucket_pow2(
        pages, floor=1), pages_for(max_seq))`` over the rows' pages, and at
        least ``span`` token slots, so that the padded columns of a chunk row
        (positions after its valid tokens, up to ``span - 1``) index inside
        the dense view; the extra entries name the scratch page.  (The
        reference lets XLA drop out-of-range scatter indices instead.)"""
        need = max(len(r.table) for r in reqs)
        cap = self.pool.pages_for(self.max_seq)
        return max(min(bucket_pow2(need, floor=1), cap),
                   self.pool.pages_for(span))

    def _padding_rows(self, B: int, P: int, W: int) -> Dict[str, np.ndarray]:
        """A paged step's host inputs for ``B`` rows of width ``W`` over
        ``P`` table entries, every row padding: a table of the scratch
        page, token 0, position 0, ``valid`` False, ``last_idx`` 0."""
        z = np.zeros((B, W), np.int32)
        return {"tables": np.full((B, P), self.pool.trash, np.int32),
                "toks": z, "positions": z.copy(), "valid": z.copy(),
                "last_idx": np.zeros((B,), np.int32)}

    def _run_paged(self, reqs: List[ServeRequest], toks, positions, valid,
                   last_idx, *, dense_view: Optional[bool] = None):
        """Returns (next tokens as a host list, last-position logits) of the
        live rows.  ``toks``/``positions``/``valid``/``last_idx`` are host
        lists; ``dense_view=None`` picks by row width (1 -> straight off the
        pool).  As in the reference, the rows are padded to
        ``min(bucket_pow2(B, floor=1), n_slots)`` with ``_padding_rows``: a
        padding row's paged length is 0 and its K/V lands on the scratch
        page; its logits are stripped here.  The step then runs
        under the key (kind, rows, table width, row width): a graph replay
        for width 1.  The logits are valid until the next step."""
        W = len(toks[0])
        if dense_view is None:
            dense_view = W > 1
        if not dense_view:
            self._decode_iters += 1
        B = len(reqs)
        Bp = min(bucket_pow2(B, floor=1), self.n_slots)
        P = self._table_width(reqs, max(max(row) for row in positions) + 1)
        arrays = self._padding_rows(Bp, P, W)
        for i, r in enumerate(reqs):
            arrays["tables"][i] = self.pool.padded_table(r.table, P)
        arrays["toks"][:B] = toks
        arrays["positions"][:B] = positions
        arrays["valid"][:B] = valid
        arrays["last_idx"][:B] = last_idx
        if dense_view:
            nxt, logits = self.graphs.run(("chunk", Bp, P, W),
                                          self._chunk_rows_step, arrays,
                                          capture=False)
        else:
            nxt, logits = self.graphs.run(("decode", Bp, P, W),
                                          self._decode_rows_step, arrays)
        return nxt[:B].tolist(), logits[:B]   # .tolist() waits for the device

    def _paged_prefill_chunks(self, now: float) -> int:
        work = self.sched.prefill_work()
        if not work:
            return 0
        C = self.prefill_chunk
        toks, poss, vals, last = [], [], [], []
        for r in work:
            n = self.sched.chunk_for(r)
            row = [int(t) for t in r.prompt[r.prefilled:r.prefilled + n]]
            row += [0] * (C - n)
            toks.append(row)
            poss.append(list(range(r.prefilled, r.prefilled + C)))
            vals.append([i < n for i in range(C)])
            last.append(n - 1)
        nxt, _ = self._run_paged(work, toks, poss, vals, last,
                                 dense_view=True)
        now = self.now()        # token timestamps see the finished step
        done_tokens = 0
        for i, r in enumerate(work):
            n = self.sched.chunk_for(r)
            done_tokens += n
            r.table.n_tokens = r.prefilled + n
            self.sched.note_prefilled(r, n, now)
            if r.state == DECODE:
                # prompt complete: register its full pages now -- they are
                # immutable from this point, so concurrent shared-prefix
                # requests can hit them while this one is still decoding --
                # and the chunk's last hidden IS the first generated token
                self.pool.register_prefix(r.prompt, r.table)
                if self.sched.note_token(r, nxt[i], now):
                    self._finish(r, now)
        return done_tokens

    def _paged_fused(self, now: float) -> int:
        """True continuous batching: ONE step over a mixed batch of decode
        rows (width-1) and prefill chunks, per the scheduler's token-budget
        ``iteration_plan``.  Row width is 1 (pure decode: the paged kernel
        path) or ``prefill_chunk`` (any prefill present: the dense-view
        path); padded columns carry positions AFTER the row's valid tokens
        (causal masking excludes them) and their K/V scatter lands on the
        scratch page -- each row's logits equal the unfused two-step
        path's."""
        plan = self.sched.iteration_plan()
        if not plan:
            return 0
        pure_decode = all(r.state == DECODE for r, _ in plan)
        W = 1 if pure_decode else self.prefill_chunk
        toks, poss, vals, last = [], [], [], []
        for r, n in plan:
            if r.state == DECODE:
                p0 = r.prompt_len + len(r.out) - 1
                toks.append([r.out[-1]] + [0] * (W - 1))
                poss.append([p0 + i for i in range(W)])
                vals.append([True] + [False] * (W - 1))
                last.append(0)
            else:
                row = [int(t) for t in r.prompt[r.prefilled:r.prefilled + n]]
                toks.append(row + [0] * (W - n))
                poss.append(list(range(r.prefilled, r.prefilled + W)))
                vals.append([i < n for i in range(W)])
                last.append(n - 1)
        nxt, _ = self._run_paged([r for r, _ in plan], toks, poss, vals,
                                 last, dense_view=not pure_decode)
        now = self.now()        # token timestamps see the finished step
        done_tokens = 0
        for i, (r, n) in enumerate(plan):
            done_tokens += n
            if r.state == DECODE:
                r.table.n_tokens += 1
                if self.sched.note_token(r, nxt[i], now):
                    self._finish(r, now)
                continue
            r.table.n_tokens = r.prefilled + n
            self.sched.note_prefilled(r, n, now)
            if r.state == DECODE:
                # prompt complete: register its (now immutable) full
                # pages and take the chunk's last hidden as the first
                # generated token, exactly like the unfused chunk path
                self.pool.register_prefix(r.prompt, r.table)
                if self.sched.note_token(r, nxt[i], now):
                    self._finish(r, now)
        return done_tokens

    def warmup(self, max_tokens: Optional[int] = None) -> float:
        """Build and first-launch what the engine's steps run, and capture
        one CUDA graph per step key (``serve.graphs``), up to the table
        width or prompt bucket that serves ``max_tokens`` (default
        ``max_seq``): paged, the width-1 step at every row bucket and table
        width (and the chunk step once, eagerly, at the widest); dense, the
        prefill at every prompt bucket and the decode step.  Paged rows are
        all padding -- K/V writes land on the scratch page -- so pool state,
        request stats and the prefix cache are untouched; a dense prefill's
        cache is dropped, and the dense decode step writes only slots that
        a prefill overwrites whole before they serve.  Returns the seconds
        spent (also accumulated into ``self.compile_s`` and reported
        separately so latency percentiles measure steady state)."""
        t0 = time.perf_counter()
        tokens = max_tokens or self.max_seq
        if self.mode == "paged":
            cap = self.pool.pages_for(self.max_seq)
            top = min(bucket_pow2(self.pool.pages_for(tokens), floor=1), cap)
            rows = pow2_buckets(self.n_slots)
            for B in rows:
                for P in pow2_buckets(top):
                    self.graphs.prepare(("decode", B, P, 1),
                                        self._decode_rows_step,
                                        self._padding_rows(B, P, 1))
            C = self.prefill_chunk
            self.graphs.prepare(("chunk", rows[-1], top, C),
                                self._chunk_rows_step,
                                self._padding_rows(rows[-1], top, C),
                                capture=False)
        else:
            top = min(bucket_pow2(tokens, floor=16), self.max_seq)
            for S in pow2_buckets(top, floor=16):
                self.graphs.prepare(("prefill", S), self._prefill_step,
                                    self._prompt_rows([0], S))
            z = np.zeros((self.n_slots, 1), np.int32)
            self.graphs.prepare(("decode", self.n_slots), self._decode_step,
                                {"toks": z, "positions": z})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.compile_s += dt
        return dt

    def _paged_decode(self, now: float) -> int:
        work = [r for r in self.sched.decode_work() if r.out]
        if not work:
            return 0
        toks = [[r.out[-1]] for r in work]
        pos = [[r.prompt_len + len(r.out) - 1] for r in work]
        valid = [[True]] * len(work)
        last = [0] * len(work)
        nxt, _ = self._run_paged(work, toks, pos, valid, last,
                                 dense_view=False)
        now = self.now()        # token timestamps see the finished step
        for i, r in enumerate(work):
            r.table.n_tokens += 1
            if self.sched.note_token(r, nxt[i], now):
                self._finish(r, now)
        return len(work)

    # ------------------------------------------------------- dense stepping --
    def _prefill_step(self, tokens, length):
        """(greedy next tokens, logits, caches) of a bucketed prefill."""
        logits, caches = self.prefill(self.model, tokens, length)
        return greedy_sample(logits)[:, 0], logits, caches

    def _decode_step(self, toks, positions):
        """(greedy next tokens, logits) of a decode step over every slot;
        the caches are written in place."""
        if self.place is not None:
            toks, positions = (self.place.rows(toks),
                               self.place.rows(positions))
        logits, caches = self.decode(self.model, self.caches, toks,
                                     positions)
        if self.place is not None:
            logits = self.place.join_rows(logits)
        if not (all(a is b for a, b in zip(caches, self.caches))
                and all(layer[name] is leaf
                        for layer, name, leaf in self._cache_leaves)):
            raise RuntimeError("the decode step rebound a cache tensor: a "
                               "replayed graph would read stale state")
        return greedy_sample(logits)[:, 0], logits

    def _prompt_rows(self, prompt, S: int) -> Dict[str, np.ndarray]:
        """A prefill's host inputs: ``prompt`` right-padded to ``S``."""
        tokens = np.zeros((1, S), np.int32)
        tokens[0, :len(prompt)] = prompt
        return {"tokens": tokens,
                "length": np.array([len(prompt)], np.int32)}

    def prefill_once(self, prompt):
        """One prefill of ``prompt`` padded to its pow2 bucket (capped at
        capacity), through the bucket's graph where there is one: (greedy
        next token (1,), logits, the caches of one slot)."""
        S = min(bucket_pow2(len(prompt), floor=16), self.max_seq)
        return self.graphs.run(("prefill", S), self._prefill_step,
                               self._prompt_rows(prompt, S))

    def decode_once(self, toks, positions):
        """One decode step over every slot (``toks``, ``positions``:
        (n_slots, 1) host ints), through its graph where there is one:
        (greedy next tokens (n_slots,), logits)."""
        return self.graphs.run(("decode", self.n_slots), self._decode_step,
                               {"toks": toks, "positions": positions})

    def _dense_prefill(self, now: float) -> int:
        work = self.sched.prefill_work()
        if not work:
            return 0
        done = 0
        for req in work[:1]:          # one-shot prefill, one request/iter
            # padded to the pow2 bucket (capped at capacity)
            nxt, _, one = self.prefill_once([int(t) for t in req.prompt])
            if self.place is not None:
                self.place.scatter_slot(self.caches, one, req.table)
            else:
                kvcache.scatter_slot(self.caches, one, req.table)
            nxt = int(nxt[0])
            done += req.prompt_len
            self.sched.note_prefilled(req, req.prompt_len, now)
            if self.sched.note_token(req, nxt, now):
                self._finish(req, now)
        return done

    def _dense_decode(self, now: float) -> int:
        work = [r for r in self.sched.decode_work() if r.out]
        if not work:
            return 0
        toks = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots, 1), np.int32)
        for r in work:
            toks[r.table, 0] = r.out[-1]
            pos[r.table, 0] = r.prompt_len + len(r.out) - 1
        nxt, _ = self.decode_once(toks, pos)
        nxt = nxt.tolist()
        for r in list(work):
            if self.sched.note_token(r, nxt[r.table], now):
                self._finish(r, now)
        return len(work)

    # ---------------------------------------------------------------- loop --
    def step(self) -> int:
        """One engine iteration; returns tokens processed (prefill +
        decode) so callers can loop ``while eng.step() or not
        eng.sched.all_done()``."""
        now = self.now()
        self._iters += 1
        self._expire_timeouts(now)
        self.sched.admit(now, self._try_open)
        if self.mode == "paged":
            if self.fused:
                n = self._paged_fused(now)
            else:
                n = self._paged_prefill_chunks(now)
                n += self._paged_decode(now)
            self._util_sum += self.pool.utilization()
        else:
            n = self._dense_prefill(now)
            n += self._dense_decode(now)
        if self._iters % self.track_every == 0:
            self._track_window(now)
        return n

    def _track_window(self, now: float) -> None:
        """Log one windowed metrics row to the active tracking run."""
        from repro_torch import tracking
        run = self.tracker or tracking.current_run()
        if run is None:
            return
        s = self.stats
        dt = now - self._win_t if self._win_t is not None else 0.0
        row = {
            "iter": self._iters,
            "queue_depth": len(self.sched.waiting),
            "active": len(self.sched.active),
            "completed": s.requests_completed,
            "window_completed": s.requests_completed - self._win_completed,
            "window_tok_s": ((s.output_tokens - self._win_tokens) / dt
                             if dt > 0 else 0.0),
            "slo_attainment": s.slo_met / max(s.requests_completed, 1),
        }
        if s.ttft_s:
            row["ttft_p50_s"] = ServingStats._dist(s.ttft_s)["p50"]
        if s.tpot_s:
            row["tpot_p50_s"] = ServingStats._dist(s.tpot_s)["p50"]
        run.log(row, step=self._iters)
        if self.pool is not None:
            kv = self.pool.stats()
            run.log_system({"kv.pages_in_use": kv["in_use"],
                            "kv.hit_rate": kv["hit_rate"]})
        self._win_completed = s.requests_completed
        self._win_tokens = s.output_tokens
        self._win_t = now

    def run(self, max_iters: int = 1_000_000) -> None:
        """Drive until every submitted request finished or nothing moves."""
        for _ in range(max_iters):
            if self.sched.all_done():
                return
            if self.step() == 0 and not self.sched.active:
                return            # starved: nothing admitted, nothing runs

    # -------------------------------------------------------------- report --
    def report(self) -> Dict[str, Any]:
        rep = self.stats.report()
        rep["mode"] = self.mode
        rep["fused"] = self.fused
        rep["iterations"] = self._iters
        rep["decode_iterations"] = self._decode_iters
        rep["compile_s"] = self.compile_s
        rep["graphs"] = self.graphs.report()
        if self.pool is not None:
            kv = self.pool.stats()
            # mean occupancy over engine iterations; "utilization" alone
            # is the post-drain sample (always 0 once requests finished)
            kv["mean_utilization"] = self._util_sum / max(self._iters, 1)
            rep["kv_pages"] = kv
        return rep
