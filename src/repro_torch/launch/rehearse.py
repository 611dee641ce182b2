"""Rehearse the data-parallel layer on the CPU: ``world`` processes in one
``gloo`` group, each a rank of a ``DeviceMesh``, running the mesh step
(``train/trainer.py``), the int8 error-feedback exchange
(``core/hierarchy.py``) and an elastic shrink (``train/elastic.py``).  What
the multi-card half of the layer does between cards, a card cannot show
alone; four processes can, at a reduced size.

  PYTHONPATH=src python -m repro_torch.launch.rehearse

prints one JSON line: ZeRO-3 against DP on ``data = 4``, the int8 exchange
on ``(pod, data) = (2, 2)`` against the same arithmetic in numpy, a
checkpoint saved on 4 ranks and resumed on the first 2 of them after the
others' devices fail, tensor parallelism on ``(data, model) = (2, 2)``
against DP on ``data = 4`` (reduced llama3.2-3b, and recurrentgemma-2b's
RG-LRU and windowed attention), expert parallelism with ZeRO-3 against
without, a ``ServeEngine``'s greedy streams on ``(2, 2)`` and the paged
engine's on ``(1, 4)`` (heads over ``model``) against one process's; exit
0 when all hold.

Each rank runs on one thread, meets the others through a ``FileStore`` in
a temporary directory (no port), and gives its group a timeout; ``spawn``
joins with a timeout and kills what is left, so a hang fails the call and
stalls nothing.  The ranks import neither JAX nor the reference: a caller
that compares with the reference hands numpy arrays in and gets numpy
arrays back.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import json
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

GROUP_TIMEOUT_S = 60.0          # a collective that no peer reaches fails


def spawn(fn: Callable, world: int, *args, timeout: float = 120.0,
          store_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` fresh processes of one
    ``gloo`` group; returns each rank's result in rank order.  Raises with
    the ranks' tracebacks when one fails, and when they have not all
    answered within ``timeout`` seconds (the processes are killed).  The
    rendezvous file goes to a new directory under ``store_dir``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rehearse_", dir=store_dir)
    answers = ctx.Queue()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(rank, world, os.path.join(tmp, "store"), fn,
                               args, answers))
             for rank in range(world)]
    results: List[Any] = [None] * world
    errors: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in range(world):
            try:
                rank, ok, value = answers.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                errors.append(f"no answer within {timeout} s")
                break
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
                break
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0)
                   if not errors else 1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} on {world} "
                           f"ranks failed: " + "\n".join(errors))
    return results


def _rank(rank, world, store, fn, args, answers):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        answers.put((rank, True, fn(rank, world, *args)))
    except Exception:       # the boundary: report it to the parent
        answers.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Job:
    """One training run on a mesh: ``reduced(arch, n_layers)`` in fp32 with
    per-block remat, ZeRO stage ``zero``, ``steps`` steps of ``batch`` x
    ``seq`` synthetic tokens (step i's batch: ``make_batch(..., step=i)``)."""
    arch: str = "qwen2-0.5b"
    n_layers: int = 2
    mesh: Tuple[Tuple[str, int], ...] = (("data", 4),)
    zero: int = 0
    compression: str = "none"
    steps: int = 1
    batch: int = 8
    seq: int = 32
    lr: float = 1e-3
    masked: bool = False            # a loss mask, uneven over the ranks
    grad_accum: int = 1
    capacity_factor: Optional[float] = None     # the MoE's, where given

    def cfg(self):
        from repro_torch.configs import get_config, reduced
        cfg = reduced(get_config(self.arch), n_layers=self.n_layers)
        if self.capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=self.capacity_factor))
        return cfg

    def policy(self):
        from repro_torch.configs.base import PolicyConfig
        axes = tuple(a for a, _ in self.mesh if a != "model")
        return PolicyConfig(dp_axes=axes, zero_stage=self.zero,
                            compute_dtype="float32",
                            grad_compression=self.compression,
                            grad_accum=self.grad_accum, remat="block",
                            attn_impl="kernel")

    def batch_at(self, i: int):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data import make_batch
        batch = make_batch(self.cfg(), ShapeConfig("rehearse", self.seq,
                                                   self.batch, "train"),
                           step=i)
        if self.masked:
            r = np.random.RandomState(i)
            keep = r.rand(self.batch, self.seq) < np.linspace(
                0.1, 0.9, self.batch)[:, None]
            batch["mask"] = keep.astype(np.float32)
        return batch


def _model(job: Job, weights: Optional[Mapping[str, Any]], seed: int,
           cfg=None):
    from repro_torch import convert
    from repro_torch.models.lm import LM
    cfg = cfg or job.cfg()
    if weights is None:
        return LM.init(cfg, seed=seed, device="cpu")
    return convert.from_reference(weights, cfg, device="cpu")


def _state(job: Job, mesh, weights=None, seed: int = 0):
    """The job's state on ``mesh``, from the reference's ``weights`` (a
    pytree of numpy arrays) or else from ``seed``."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import trainer
    return trainer.TrainState.create(_model(job, weights, seed),
                                     job.policy(), AdamWConfig(lr=job.lr),
                                     mesh=mesh)


def _whole(state) -> Dict[str, np.ndarray]:
    from repro_torch.train import checkpoint
    # copies: the state's own tensors go on changing
    return {k: np.array(x.detach().float() if hasattr(x, "detach") else x)
            for k, x in checkpoint.whole_leaves(state)}


def _steps(job: Job, state, mesh, first: int, last: int):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import trainer
    step = trainer.make_train_step(job.cfg(), job.policy(),
                                   AdamWConfig(lr=job.lr), mesh=mesh)
    metrics = []
    for i in range(first, last):
        state, m = step(state, job.batch_at(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, step.traffic.report()


def train_jobs(rank: int, world: int, jobs, weights=None) -> List[dict]:
    """Each job from the same weights (``weights[arch]``, else seed 0) on
    its mesh; rank 0 returns the whole parameters after the steps, the
    metrics of every step and the step's collective traffic, and for a
    job with gradient compression also the first moments and the int8
    residuals (``m``, ``ef``), whole; for a job with a ``model`` axis the
    first moments."""
    from repro_torch.launch.mesh import make_mesh
    out = []
    for job in jobs:
        mesh = make_mesh([s for _, s in job.mesh], [a for a, _ in job.mesh],
                         device="cpu")
        state = _state(job, mesh, (weights or {}).get(job.arch))
        state, metrics, traffic = _steps(job, state, mesh, 0, job.steps)
        whole = _whole(state)
        prefixes = {"params": "params/"}
        if job.compression != "none":
            prefixes.update(m="opt/m/", ef="ef/")
        elif "model" in dict(job.mesh):
            prefixes.update(m="opt/m/")
        row = {part: {k[len(pre):]: v for k, v in whole.items()
                      if k.startswith(pre)}
               for part, pre in prefixes.items()}
        out.append(dict(row, metrics=metrics, traffic=traffic)
                   if rank == 0 else None)
    return out


def int8_exchange(rank: int, world: int, seed: int, steps: int = 2):
    """``allreduce_int8_ef`` over the pod axis of a ``(pod, data) = (2,
    world // 2)`` mesh, ``steps`` times with the residual carried: a tree
    of three leaves drawn from ``(seed, step, rank)``.  Every rank returns
    its inputs, outputs and residuals."""
    import torch
    from repro_torch.core import hierarchy
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, world // 2), ("pod", "data"), device="cpu")
    traffic = hierarchy.Traffic()
    pods = hierarchy.axis_group(mesh, ("pod",), traffic)
    shapes = {"a": (37, 53), "b": (1000,), "c": (4, 8, 16)}
    res = None
    rows = []
    for s in range(steps):
        r = np.random.RandomState([seed, s, rank])
        tree = {k: torch.from_numpy((r.standard_normal(sh) * 10.0 ** r.uniform(
            -3, 1)).astype(np.float32)) for k, sh in shapes.items()}
        if res is None:
            res = hierarchy.init_residual(tree)
        out, res = hierarchy.allreduce_int8_ef(tree, res, pods)
        rows.append({"g": {k: v.numpy() for k, v in tree.items()},
                     "out": {k: v.numpy() for k, v in out.items()},
                     "res": {k: v.numpy() for k, v in res.items()}})
    return {"coord": mesh.get_coordinate(), "steps": rows,
            "traffic": traffic.report()}


def save_and_go_on(rank: int, world: int, job: Job, ckpt_dir: str,
                   save_at: int):
    """The uninterrupted run of an elastic pair: a composition of
    ``job.mesh``'s ``data`` ranks in a modelled pool, the job's steps with
    a checkpoint after ``save_at``; then half the devices fail and the
    composition shrinks.  Returns (rank 0: the run's metrics, the traffic
    of the steps after the save, the final state whole and the events,
    else None; every rank: the shrunk system)."""
    from repro_torch.core import compose
    from repro_torch.core.topology import LinkClass, make_pool
    from repro_torch.train import checkpoint, elastic
    n = dict(job.mesh)["data"]
    pool = make_pool(n, 0, pods=1)
    system = compose.compose(pool, "rehearsal", ("data",), (n,),
                             {"data": LinkClass.LOCAL})
    mesh = system.mesh(device="cpu")
    state = _state(job, mesh)
    state, before, _ = _steps(job, state, mesh, 0, save_at)
    checkpoint.save(ckpt_dir, save_at, state)
    state, after, traffic = _steps(job, state, mesh, save_at, job.steps)
    run = elastic.ElasticRun(system, ckpt_dir)
    new = elastic.handle_failure(run, pool, system.device_uids[n // 2:],
                                 step=save_at)
    whole = _whole(state)
    out = {"metrics": before + after, "whole": whole, "system": new,
           "traffic": traffic,
           "events": [dataclasses.asdict(e) for e in run.events]}
    return (out if rank == 0 else None), new


def resume_and_go_on(rank: int, world: int, job: Job, ckpt_dir: str,
                     system):
    """The resumed half: ``system`` (the shrunk composition) as a mesh of
    the group's first ranks (the others stop), a state drawn from another
    seed laid out on it, ``elastic.resume`` from the checkpoint, then the
    remaining steps.  Rank 0 returns the restored state whole, the
    metrics and the final state whole."""
    from repro_torch.train import elastic, trainer
    mesh = system.mesh(device="cpu")
    if mesh.get_coordinate() is None:
        return None
    job = dataclasses.replace(job, mesh=tuple(system.shape.items()))
    state = _state(job, mesh, seed=5)
    run = elastic.ElasticRun(system, ckpt_dir)
    specs = trainer.state_specs(state, job.cfg(), job.policy(),
                                dict(system.shape))
    state, step = elastic.resume(run, state, mesh, specs)
    restored = _whole(state)
    state, metrics, _ = _steps(job, state, mesh, step, job.steps)
    whole = _whole(state)
    return {"step": step, "restored": restored, "metrics": metrics,
            "whole": whole,
            "events": [dataclasses.asdict(e) for e in run.events]} \
        if rank == 0 else None


# ---------------------------------------------------------------------------
# the tensor- and expert-parallel paths, case by case
# ---------------------------------------------------------------------------
def _pctx(mesh, fsdp_experts: bool = False):
    from repro_torch.models.transformer import ParallelCtx
    return ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model",
                       fsdp_experts=fsdp_experts)


def _rows(a, mesh):
    """This rank's rows (its piece over ``data``) of a numpy array, as a
    tensor."""
    import torch
    from repro_torch.train.sharding import piece
    return torch.from_numpy(np.ascontiguousarray(piece(a, ("data",),
                                                       mesh)))


def _flash_case(pctx, mesh, case):
    from repro_torch.models.attention import sharded_flash
    q, k, v = (_rows(case[n], mesh) for n in ("q", "k", "v"))
    return sharded_flash(q, k, v, pctx=pctx, causal=True,
                         whole=True).numpy()


def _decode_case(pctx, mesh, case):
    import torch
    from repro_torch.models.attention import cache_w_split, sharded_decode
    from repro_torch.train.sharding import piece
    W, tp = case["k"].shape[1], pctx.tp
    spec = ("data", "model") if cache_w_split(W, tp) else ("data",)
    cache = {n: torch.from_numpy(np.ascontiguousarray(piece(case[n], spec,
                                                            mesh)))
             for n in ("k", "v", "pos")}
    res = sharded_decode(*(_rows(case[n], mesh) for n in (
        "q", "k_new", "v_new")), cache, _rows(case["positions"], mesh),
        pctx=pctx, W=W, window=case["window"])
    if res is None:
        return None
    out, cache = res
    return {"out": out.numpy(), **{n: t.numpy() for n, t in cache.items()}}


def _ssd_case(pctx, mesh, case):
    from repro_torch.models.ssm import ssd_sharded
    x, dt, Bm, Cm = (_rows(case[n], mesh) for n in ("x", "dt", "B", "C"))
    import torch
    A = torch.from_numpy(case["A"])
    H = x.shape[2]
    y, h = ssd_sharded(x, dt, A, Bm, Cm, chunk=case["chunk"], pctx=pctx,
                       heads=H)
    if y.shape[2] != H:
        y, h = pctx.all_gather(y, 2), pctx.all_gather(h, 1)
    return {"y": y.numpy(), "h": h.numpy()}


def _moe_case(pctx, mesh, case):
    import types
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import _moe_ep
    from repro_torch.train.sharding import piece
    cfg = reduced(get_config(case["arch"]))
    n_dp = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["data"]
    params = {"router": torch.from_numpy(case["router"])}
    for n in ("wi", "wg", "wo"):
        w = case[n]
        spec = ["model", None, None]
        if case["fsdp"]:
            # the reference's ``_fsdp_dim``: the largest non-E dim that
            # divides over the dp ranks
            spec[max((w.shape[d], d) for d in (1, 2)
                     if w.shape[d] % n_dp == 0)[1]] = "data"
        params[n] = torch.from_numpy(np.ascontiguousarray(
            piece(w, tuple(spec), mesh)))
    y, aux = _moe_ep(types.SimpleNamespace(**params),
                     _rows(case["x"], mesh), cfg, torch.float32, pctx, None)
    return {"y": y.numpy(), "aux": float(aux)}


def _moe_dp_case(pctx, mesh, case):
    """``moe_sorted`` on this rank's rows of a batch split over ``data``, in
    the global batch's order (``dp_group``), at ``case["capacity_factor"]``;
    this rank's y and the global aux."""
    import types
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import moe_sorted
    cfg = reduced(get_config(case["arch"]))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=case["capacity_factor"]))
    params = types.SimpleNamespace(**{n: torch.from_numpy(case[n]) for n in (
        "router", "wi", "wg", "wo")})
    y, aux = moe_sorted(params, _rows(case["x"], mesh), cfg,
                        compute_dtype=torch.float32,
                        dp_group=pctx.group(("data",)))
    return {"y": y.numpy(), "aux": float(aux)}


def serve_streams(arch: str, weights, prompts, max_new: int, mesh=None,
                  n_slots: int = 4, max_seq: int = 64,
                  engine: str = "slots", n_layers: int = 2,
                  overrides: Optional[Mapping[str, Any]] = None
                  ) -> List[List[int]]:
    """Greedy streams of a reduced ``arch``'s ``ServeEngine`` (``engine``
    "slots"; "dense" or "paged": ``AsyncServeEngine`` in that mode, page
    16, chunks of 16), fp32 on the CPU, from ``weights`` (the reference's
    pytree, numpy; else seed 0), on ``mesh`` or none.  ``n_layers`` and
    ``overrides`` (config fields) shape the reduced config."""
    import torch
    from repro_torch.configs.base import PolicyConfig
    from repro_torch.serve.engine import (AsyncServeEngine, Request,
                                          ServeEngine)
    from repro_torch.serve.scheduler import ServeRequest
    job = Job(arch=arch, n_layers=n_layers)
    cfg = dataclasses.replace(job.cfg(), **(overrides or {}))
    model = _model(job, weights, 0, cfg)
    policy = PolicyConfig(compute_dtype="float32", attn_impl="kernel")
    if engine in ("dense", "paged"):
        kw = dict(page_size=16, prefill_chunk=16) if engine == "paged" \
            else {}
        # a clock of steps, not of the host: the scheduler's choices (and
        # so every rank's collectives) cannot depend on a rank's timing
        ticks = iter(range(1 << 62))
        eng = AsyncServeEngine(cfg, model, policy, n_slots=n_slots,
                               max_seq=max_seq, mode=engine, mesh=mesh,
                               graphs=False, device="cpu",
                               clock=lambda: next(ticks) * 1e-3, **kw)
        reqs = [ServeRequest(i, list(p), max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            if not eng.submit(r):
                raise ValueError(f"request {r.rid}: {r.why_rejected}")
        eng.run()
        return [list(r.out) for r in reqs]
    eng = ServeEngine(cfg, model, policy, n_slots=n_slots,
                      max_seq=max_seq, mesh=mesh, device="cpu")
    reqs = [Request(rid=i, prompt=torch.tensor(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        if not eng.add_request(r):
            raise ValueError("more prompts than slots")
    while any(not r.done for r in reqs):
        eng.step()
    return [list(r.out) for r in reqs]


def _serve_case(pctx, mesh, case):
    return serve_streams(case["arch"], case.get("weights"), case["prompts"],
                         case["max_new"], mesh=mesh,
                         engine=case.get("engine", "slots"),
                         n_layers=case.get("n_layers", 2),
                         max_seq=case.get("max_seq", 64),
                         overrides=case.get("overrides"))


def _group_case(pctx, mesh, case):
    """An all-reduce of each rank's global rank over ``case["axes"]``'s
    group, and the rank's mesh coordinate."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import hierarchy
    group = hierarchy.axis_group(mesh, case["axes"], hierarchy.Traffic())
    x = torch.tensor([float(dist.get_rank())])
    return {"sum": float(hierarchy.all_reduce(x, group)[0]),
            "coord": list(mesh.get_coordinate()), "size": group.size}


_CASES = {"flash": _flash_case, "decode": _decode_case, "ssd": _ssd_case,
          "moe": _moe_case, "moe_dp": _moe_dp_case, "serve": _serve_case,
          "group": _group_case}


def tp_cases(rank: int, world: int, cases: Mapping[str, dict]) -> dict:
    """Each case (``kind``: flash, decode, ssd, moe, moe_dp, serve or group,
    on its ``mesh``, ((axes), (sizes))) from numpy inputs:
    ``sharded_flash`` (every head, joined), ``sharded_decode`` (its output
    and this rank's cache piece, or None where it declines),
    ``ssd_sharded`` (every head), ``_moe_ep`` (this rank's tokens' y, the
    global aux), ``moe_sorted`` in the global batch's order over ``data``
    (the same), an engine's greedy streams (``serve_streams``) and an
    all-reduce over a group of axes.  Every rank returns its own; a rank
    past a smaller mesh returns None."""
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for name, case in cases.items():
        axes, sizes = case["mesh"]
        mesh = make_mesh(sizes, axes, device="cpu")
        if mesh.get_coordinate() is None:
            out[name] = None
            continue
        pctx = _pctx(mesh, case.get("fsdp", False))
        out[name] = _CASES[case["kind"]](pctx, mesh, case)
    return out


def four_ranks(rank: int, world: int, jobs, weights, ckpt_dir: str = None,
               save_job: Optional[Job] = None, save_at: int = 1,
               cases: Optional[Mapping[str, dict]] = None) -> dict:
    """``train_jobs``, then (with ``save_job``) ``int8_exchange``,
    ``save_and_go_on`` on all the ranks and ``resume_and_go_on`` on the
    shrunk composition's, then (with ``cases``) ``tp_cases``: one start of
    the processes; ``started``: the host's clock when the rank's group was
    up."""
    out = {"started": time.time(),
           "train": train_jobs(rank, world, jobs, weights)}
    if save_job is not None:
        out["int8"] = int8_exchange(rank, world, 0)
        out["saved"], system = save_and_go_on(rank, world, save_job,
                                              ckpt_dir, save_at)
        out["resumed"] = resume_and_go_on(rank, world, save_job, ckpt_dir,
                                          system)
    if cases is not None:
        out["cases"] = tp_cases(rank, world, cases)
    return out


def emulate_int8(ranks: List[dict], encode=None, decode=None) -> List[dict]:
    """The int8 exchange of ``int8_exchange``'s ranks, emulated on the
    host: per step and pod group (the ranks of one ``data`` coordinate), y
    = g + r, the scale from the group's largest |y|, the payloads summed in
    int32, decoded and divided by the group's size.  ``encode(y, max)`` /
    ``decode(q, scale)`` default to numpy's float32 arithmetic; a test
    hands in the reference's ``int8_encode`` / ``int8_decode``."""
    def np_encode(y, m):
        scale = np.float32(max(np.float32(m), np.float32(1e-30))
                           / np.float32(127.0))
        return (np.clip(np.round(y / scale), -127, 127).astype(np.int8),
                scale)

    def np_decode(q, scale):
        return q.astype(np.float32) * np.float32(scale)

    encode, decode = encode or np_encode, decode or np_decode
    want = [{"steps": []} for _ in ranks]
    groups: Dict[int, List[int]] = {}
    for i, r in enumerate(ranks):
        groups.setdefault(r["coord"][1], []).append(i)
    res = {i: None for i in range(len(ranks))}
    for s in range(len(ranks[0]["steps"])):
        rows = {i: {"out": {}, "res": {}} for i in range(len(ranks))}
        for members in groups.values():
            for k in ranks[0]["steps"][s]["g"]:
                ys = {i: ranks[i]["steps"][s]["g"][k] + (
                    res[i][k] if res[i] is not None else np.float32(0.0))
                    for i in members}
                m = max(float(np.abs(y).max()) for y in ys.values())
                qs = {i: encode(y, m) for i, y in ys.items()}
                total = sum(q.astype(np.int32) for q, _ in qs.values())
                scale = qs[members[0]][1]
                out = np.asarray(decode(total, scale)) / np.float32(
                    len(members))
                for i in members:
                    rows[i]["out"][k] = out.astype(np.float32)
                    rows[i]["res"][k] = ys[i] - np.asarray(
                        decode(qs[i][0].astype(np.int32), qs[i][1]))
        for i in rows:
            res[i] = rows[i]["res"]
            want[i]["steps"].append(rows[i])
    return want


# ---------------------------------------------------------------------------
# the standard rehearsal
# ---------------------------------------------------------------------------
REHEARSAL_JOB = Job(arch="qwen2-0.5b", n_layers=2, steps=2, batch=8, seq=32)
# tensor parallelism against data parallelism on the same four ranks, and
# expert parallelism with ZeRO-3 against without
TP_MESH = (("data", 2), ("model", 2))
TP_JOB = Job(arch="llama3.2-3b", mesh=TP_MESH)
EP_JOB = Job(arch="moonshot-v1-16b-a3b", mesh=TP_MESH, steps=2)
# recurrentgemma-2b's RG-LRU and windowed attention under ``model``
HYBRID_JOB = Job(arch="recurrentgemma-2b", n_layers=3, mesh=TP_MESH)
SERVE_PROMPTS = [[(7 * i + 3 * j) % 500 for j in range(9 + 5 * i)]
                 for i in range(4)]


# The key bias adds the same q . bk to every score of a query's row, which
# the softmax takes out: its gradient is rounding noise, and Adam's first
# steps turn noise into updates of up to lr.  These leaves are held to
# |a - b| <= 2 lr a step instead (as in tests/test_torch_train.py).
NOISE_LEAVES = ("attn.bk",)


def _rel(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray],
         noise_bound: float) -> float:
    """Largest |a - b| over a leaf's largest |b|, over the leaves; a
    ``NOISE_LEAVES`` leaf past ``noise_bound`` counts as infinite."""
    worst = 0.0
    for k in b:
        d = float(np.abs(a[k] - b[k]).max())
        if any(k.endswith(n) for n in NOISE_LEAVES):
            worst = worst if d <= noise_bound else float("inf")
        else:
            worst = max(worst, d / max(float(np.abs(b[k]).max()), 1e-30))
    return worst


def _rel_sure(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray],
              m: Mapping[str, np.ndarray], bound: float) -> float:
    """``_rel`` over the elements whose first moment ``m`` (``b``'s run's)
    is above 1e-7 -- a gradient above ~1e-6, where rounding noise cannot
    steer Adam's step; an element below it counts as infinite past
    ``bound``.  Two reduction orders (tensor- against data-parallel) move
    such a gradient by rounding noise, which Adam's first steps turn into
    updates of up to lr."""
    worst = 0.0
    for k in b:
        d = np.abs(a[k] - b[k])
        sure = np.abs(m[k]) > 1e-7
        if np.any(d[~sure] > bound):
            return float("inf")
        if np.any(sure):
            worst = max(worst, float(d[sure].max())
                        / max(float(np.abs(b[k]).max()), 1e-30))
    return worst


def rehearse(job: Job = REHEARSAL_JOB, tol: float = 1e-5) -> dict:
    """The three checks on four ranks (module docstring); ``ok`` when
    ZeRO-3's parameters are within ``tol`` of DP's (each leaf's largest
    difference over its largest value; ``NOISE_LEAVES`` within 2 lr a
    step), the int8 exchange equals the numpy arithmetic within one part
    in a million, the restored state equals the saved one bit for bit and
    the resumed run's parameters equal the uninterrupted run's as ZeRO-3's
    equal DP's.  The uninterrupted run is the ZeRO-3 run held to DP: a
    checkpoint after its first step, then the rest of ``job.steps``."""
    t0 = time.perf_counter()
    clock0 = time.time()
    zero3 = dataclasses.replace(job, zero=3)
    tp_dp = dataclasses.replace(TP_JOB, mesh=(("data", 4),))
    ep_z3 = dataclasses.replace(EP_JOB, zero=3)
    hyb_dp = dataclasses.replace(HYBRID_JOB, mesh=(("data", 4),))
    serve = {"kind": "serve", "mesh": (("data", "model"), (2, 2)),
             "arch": TP_JOB.arch, "prompts": SERVE_PROMPTS, "max_new": 6}
    # the paged engine with heads over model = 4 (H = 6 padded to 8)
    paged = dict(serve, mesh=(("data", "model"), (1, 4)), engine="paged")
    ckpt = tempfile.mkdtemp(prefix="rehearse_ckpt_")
    try:
        # the streams without a mesh, from a thread while the ranks run
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            want_streams = pool.submit(serve_streams, TP_JOB.arch, None,
                                       SERVE_PROMPTS, 6)
            want_paged = pool.submit(serve_streams, TP_JOB.arch, None,
                                     SERVE_PROMPTS, 6, engine="paged")
            four = spawn(four_ranks, 4, [job, TP_JOB, tp_dp, EP_JOB, ep_z3,
                                         HYBRID_JOB, hyb_dp],
                         None, ckpt, zero3, 1, {"serve": serve,
                                                "paged": paged})
            streams_want = want_streams.result()
            paged_want = want_paged.result()
        first, second = four[0]["saved"], four[0]["resumed"]
        saved = np.load(os.path.join(ckpt, "step_0000000001",
                                     "arrays.npz"))
        restored_equal = all(np.array_equal(second["restored"][k], saved[k])
                             for k in saved.files)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    dp, tp, tpdp, ep, epz3, hyb, hybdp = four[0]["train"]
    params = lambda d: {k[len("params/"):]: v     # noqa: E731
                        for k, v in d.items() if k.startswith("params/")}
    tp_vs_dp = _rel_sure(tp["params"], tpdp["params"], tp["m"],
                         2 * TP_JOB.lr * TP_JOB.steps)
    ep_zero3_vs_ep = _rel(epz3["params"], ep["params"],
                          2 * job.lr * job.steps)
    hyb_vs_dp = _rel_sure(hyb["params"], hybdp["params"], hyb["m"],
                          2 * HYBRID_JOB.lr * HYBRID_JOB.steps)
    streams_equal = all(r["cases"]["serve"] == streams_want for r in four)
    paged_equal = all(r["cases"]["paged"] == paged_want for r in four)
    zero3_vs_dp = _rel(params(first["whole"]), dp["params"],
                       2 * job.lr * job.steps)
    ranks = [r["int8"] for r in four]
    want = emulate_int8(ranks)
    int8_err = max(
        max(float(np.abs(g[part][k] - w[part][k]).max())
            / max(float(np.abs(w[part][k]).max()), 1e-30)
            for part in ("out", "res") for k in w[part])
        for r, e in zip(ranks, want)
        for g, w in zip(r["steps"], e["steps"]))
    resumed_vs_uninterrupted = _rel(params(second["whole"]),
                                    params(first["whole"]),
                                    2 * job.lr * job.steps)
    t_end = time.perf_counter()
    ok = (zero3_vs_dp <= tol and int8_err <= 1e-6 and restored_equal
          and resumed_vs_uninterrupted <= tol and tp_vs_dp <= tol
          and ep_zero3_vs_ep <= tol and streams_equal and hyb_vs_dp <= tol
          and paged_equal)
    return {"ok": ok, "arch": job.arch, "n_layers": job.n_layers,
            "batch": job.batch, "seq": job.seq, "steps": job.steps,
            "zero3_vs_dp_data4_rel": zero3_vs_dp,
            "losses_dp": [m["loss"] for m in dp["metrics"]],
            "losses_zero3": [m["loss"] for m in first["metrics"]],
            "traffic_dp_data4": dp["traffic"],
            "traffic_zero3_data4_after_the_save": first["traffic"],
            "int8_pod2_data2_vs_numpy_rel": int8_err,
            "int8_traffic_rank0": ranks[0]["traffic"],
            "resume": {"saved_on": dict(zero3.mesh), "saved_at": 1,
                       "resumed_on": dict(first["system"].shape),
                       "restored_bit_identical": restored_equal,
                       "resumed_vs_uninterrupted_rel":
                           resumed_vs_uninterrupted,
                       "losses_resumed":
                           [m["loss"] for m in second["metrics"]],
                       "events": first["events"] + second["events"]},
            "tensor_parallel": {
                "arch": TP_JOB.arch, "mesh": dict(TP_MESH),
                "tp_vs_dp_data4_rel": tp_vs_dp,
                "losses_tp": [m["loss"] for m in tp["metrics"]],
                "losses_dp": [m["loss"] for m in tpdp["metrics"]],
                "traffic_tp_rank0": tp["traffic"],
                "serve_streams_equal_no_mesh": streams_equal,
                "paged_model4_streams_equal_no_mesh": paged_equal},
            "tensor_parallel_hybrid": {
                "arch": HYBRID_JOB.arch, "n_layers": HYBRID_JOB.n_layers,
                "mesh": dict(TP_MESH), "tp_vs_dp_data4_rel": hyb_vs_dp,
                "losses_tp": [m["loss"] for m in hyb["metrics"]],
                "losses_dp": [m["loss"] for m in hybdp["metrics"]],
                "traffic_tp_rank0": hyb["traffic"]},
            "expert_parallel": {
                "arch": EP_JOB.arch, "mesh": dict(TP_MESH),
                "zero3_vs_zero0_rel": ep_zero3_vs_ep,
                "losses": [m["loss"] for m in ep["metrics"]],
                "traffic_zero3_rank0": epz3["traffic"]},
            "tol": tol,
            "startup_s": max(r["started"] for r in four) - clock0,
            "wall_s": t_end - t0}


def main() -> int:
    out = rehearse()
    print(json.dumps(out, default=str))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
