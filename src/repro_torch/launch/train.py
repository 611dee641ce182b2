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

``--zero`` has no effect without a mesh (as in the reference's un-sharded
step); meshes are ROADMAP queue A item 7.  ``--track`` needs the tracking
plane, queue A item 8, and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, PolicyConfig, ShapeConfig
from repro_torch.data import SyntheticDataset
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
    policy = PolicyConfig(
        compute_dtype=args.dtype, remat=args.remat, attn_impl="kernel",
        zero_stage=args.zero, grad_accum=args.grad_accum)
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
                    help="record the run via the tracking plane (not "
                         "ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)

    if args.track:
        raise NotImplementedError(
            "--track needs the tracking plane, which is not ported yet: "
            "ROADMAP queue A item 8")
    cfg, policy, optcfg, schedcfg = build(args)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.steps} steps "
          f"on {args.device}")

    state = trainer.init_state(cfg, policy, optcfg, seed=0,
                               device=args.device)
    start = 0
    if args.resume == "auto" and args.ckpt and \
            checkpoint.latest_step(args.ckpt) is not None:
        state, start = checkpoint.restore(args.ckpt, state)
        print(f"resumed from step {start}")

    step_fn = trainer.make_train_step(cfg, policy, optcfg, schedcfg,
                                      shape=shape)
    ds = SyntheticDataset(cfg, shape)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, ds.batch_at(step))
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, step + 1, state)
        if args.fail_at and step + 1 == args.fail_at:
            if args.ckpt:
                checkpoint.save(args.ckpt, step + 1, state)
            print(f"simulated failure at step {step + 1} -- restart with "
                  f"--resume auto")
            return 17
        if (step + 1) % args.log_every == 0 or step == start:
            toks = shape.tokens * (step + 1 - start)
            print(f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}"
                  f"  grad_norm {float(metrics['grad_norm']):.3f}"
                  f"  tok/s {toks / (time.time() - t0):.0f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, args.steps, state)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"done in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
