"""Training launcher, held against ``repro/launch/train.py`` (the same flags,
plus ``--device``; ``--reduced`` / ``--no-reduced`` as there).

Runs a real training loop -- synthetic data, AdamW, checkpoints, resume --
on the GPU unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it raises.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch llama3.2-3b --reduced --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --no-reduced --dtype bfloat16 --batch 2 --seq 4096 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch recurrentgemma-2b --reduced --steps 3 --batch 2 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --no-reduced --dtype bfloat16 --batch 2 \\
      --seq 4096 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --no-reduced --dtype bfloat16 --batch 2 --seq 4096 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 30 --fail-at 12 --ckpt ckpt_demo  # exits 17; then
      ... --resume auto                                  # carries on

``--mesh data=N[,model=M][,pod=P]`` trains on a ``DeviceMesh`` of those
axes (``train/trainer.py``: the batch over ``pod`` and ``data``, tensor and
expert parallelism over ``model`` -- every LM arch, recurrentgemma-2b's
RG-LRU and windowed attention included; MoE on a mesh without ``model``
in the global batch's order) under ``--zero`` 0 / 1 / 3 and
``--compress int8_ef`` (the pod axis), or under one rung of the paper's
ladder, ``--rung`` (``core/policy.ladder``: DP, DDP, DDP+mixed,
DDP+mixed+sharded; it sets the ZeRO stage and the compute dtype).  Under
``torchrun`` each process joins its group (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and takes its rows of
every global batch; without a launcher the program starts a one-rank group
itself: NCCL on the card, ``gloo`` with ``--device cpu``.  A failed NCCL
start raises: nothing falls back to ``gloo`` or the CPU.  Without
``--mesh``, ``--zero`` has no effect (as in the reference's un-sharded
step).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --rung DDP+mixed+sharded --mesh data=1 --batch 2 --seq 4096 --steps 5
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \\
      qwen2-0.5b --rung DDP+mixed+sharded --mesh data=4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --mesh data=1 --zero 3 --steps 3
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch moonshot-v1-16b-a3b --reduced --mesh data=2,model=2 --steps 3

``--track`` records the run
through ``repro_torch.tracking`` (``results/torch/runs/<run_id>/
events.jsonl`` under the working directory): one row per step from a
``StepTracker``, and a ``ProcSampler`` for the process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 3 --track
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, PolicyConfig, ShapeConfig
from repro_torch.core.policy import ladder
from repro_torch.data import SyntheticDataset
from repro_torch.launch.mesh import (  # noqa: F401 (re-export)
    AXIS_ORDER, make_mesh, parse_mesh, start_group)
from repro_torch.models.lm import require_device
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import checkpoint, trainer


def preset_100m(cfg: ModelConfig) -> ModelConfig:
    """~100M-param same-family config (the reference's preset)."""
    return dataclasses.replace(
        reduced(cfg, n_layers=min(12, cfg.n_layers), width_div=4,
                vocab=32768),
        name=cfg.name + "-100m")


def build(args):
    cfg = get_config(args.arch)
    if args.preset == "100m":
        cfg = preset_100m(cfg)
    elif args.reduced:
        cfg = reduced(cfg)
    axes = parse_mesh(args.mesh)
    policy = PolicyConfig(
        compute_dtype=args.dtype, remat=args.remat, attn_impl="kernel",
        zero_stage=args.zero, grad_accum=args.grad_accum,
        grad_compression=args.compress,
        **({"dp_axes": tuple(a for a in axes if a != "model")}
           if axes else {}))
    if args.rung:
        policy = ladder(policy)[args.rung]
    optcfg = AdamWConfig(lr=args.lr)
    schedcfg = ScheduleConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps)
    return cfg, policy, optcfg, schedcfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="", choices=["", "100m"])
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--zero", type=int, default=3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="", choices=["", "auto"])
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a crash at this step (elastic test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--track", action="store_true",
                    help="record the run via repro_torch.tracking "
                         "(results/torch/runs/<run_id>/events.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    ap.add_argument("--mesh", default="",
                    help="data=N[,model=M][,pod=P]: train on a device mesh "
                         "(model: tensor and expert parallelism)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--rung", default="", choices=[""] + list(
        ladder(PolicyConfig())))
    args = ap.parse_args(argv)

    cfg, policy, optcfg, schedcfg = build(args)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh = None
    if args.mesh:
        require_device(args.device)
        start_group(args.device)
        axes = parse_mesh(args.mesh)
        mesh = make_mesh(tuple(axes.values()), tuple(axes),
                         device=torch.device(args.device).type)
    try:
        return _loop(args, cfg, policy, optcfg, schedcfg, shape, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _loop(args, cfg, policy, optcfg, schedcfg, shape, mesh) -> int:
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    run = None
    if args.track and lead:
        from repro_torch import tracking
        run = tracking.init(
            f"train-{args.arch}",
            config={"arch": args.arch, "preset": args.preset,
                    "steps": args.steps, "batch": args.batch,
                    "seq": args.seq, "lr": args.lr, "dtype": args.dtype,
                    "zero": policy.zero_stage, "grad_accum": args.grad_accum,
                    "mesh": args.mesh, "rung": args.rung,
                    "compress": args.compress},
            tags=("train",), samplers=[tracking.ProcSampler()])
        say(f"tracking run {run.id} -> {run.path}")
    where = args.device
    if mesh is not None:
        where += (f", mesh {args.mesh}, zero {policy.zero_stage}, "
                  f"{policy.compute_dtype} compute")
    say(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"batch {args.batch} x seq {args.seq}, {args.steps} steps on "
        f"{where}")

    state = trainer.init_state(cfg, policy, optcfg, seed=0,
                               device=args.device, mesh=mesh)
    start = 0
    if args.resume == "auto" and args.ckpt and \
            checkpoint.latest_step(args.ckpt) is not None:
        state, start = checkpoint.restore(args.ckpt, state)
        say(f"resumed from step {start}")

    step_fn = trainer.make_train_step(cfg, policy, optcfg, schedcfg,
                                      mesh=mesh, shape=shape)
    ds = SyntheticDataset(cfg, shape)
    stepper = trainer.StepTracker(shape.tokens, run)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, ds.batch_at(step))
        stepper.step(step, metrics)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, step + 1, state)
        if args.fail_at and step + 1 == args.fail_at:
            if args.ckpt:
                checkpoint.save(args.ckpt, step + 1, state)
            say(f"simulated failure at step {step + 1} -- restart with "
                f"--resume auto")
            if run is not None:
                stepper.summary()
                run.finish("failed")
            return 17
        if (step + 1) % args.log_every == 0 or step == start:
            toks = shape.tokens * (step + 1 - start)
            say(f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}"
                f"  grad_norm {float(metrics['grad_norm']):.3f}"
                f"  tok/s {toks / (time.time() - t0):.0f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, args.steps, state)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    if run is not None:
        stepper.summary()
        run.finish()
    say(f"done in {time.time() - t0:.1f}s")
    if mesh is not None:
        say(f"collectives: {step_fn.traffic.report()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
