"""Serving launcher: batched requests through the async serving engine, held
against ``repro/launch/serve.py`` (same flags and exit codes, plus
``--device`` and ``--dtype``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --no-reduced --dtype bfloat16 --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu  # reduced

Runs on the GPU unless ``--device cpu`` is given.  The engine warms up
(builds and first-launches its kernels) before serving so TTFT/TPOT
percentiles measure steady state; that time is printed separately
(``--no-warmup`` to skip).

Requests whose prompt + decode budget exceed ``--max-seq`` are rejected up
front (exit code 2) -- the engine never truncates silently.

``--request-timeout SECONDS`` puts a deadline on every request: requests
past the deadline are cancelled, a per-request timeout report is printed,
and the command exits 3.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.models.lm import LM
from repro_torch.serve import AsyncServeEngine, ServeRequest


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--sched", default="slo",
                    choices=["slo", "priority", "fcfs"])
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "paged", "dense"])
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="continuous batching: fuse prefill chunks and "
                         "decode rows into one iteration (--no-fused "
                         "falls back to alternating batches)")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="build and first-launch the kernels before "
                         "serving so reported latencies are steady-state")
    ap.add_argument("--request-timeout", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none); "
                         "timed-out requests are cancelled and reported "
                         "instead of hanging the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute and cache dtype")
    args = ap.parse_args(argv)

    if args.prompt_len + args.max_new > args.max_seq:
        print(f"error: prompt ({args.prompt_len}) + max-new "
              f"({args.max_new}) tokens exceed --max-seq ({args.max_seq}); "
              f"raise --max-seq or shorten the request")
        return 2

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    policy = PolicyConfig(compute_dtype=args.dtype, remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=getattr(torch, args.dtype),
                    device=args.device)
    eng = AsyncServeEngine(
        cfg, model, policy, n_slots=args.slots, max_seq=args.max_seq,
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        sched_policy=args.sched, mode=args.mode, fused=args.fused,
        request_timeout_s=args.request_timeout, device=args.device)
    if args.warmup:
        dt = eng.warmup()
        print(f"warmup: built and first-launched the kernels and captured "
              f"{eng.graphs.n_graphs} step graphs in {dt:.1f}s")

    pending = deque(
        ServeRequest(i, np.random.RandomState(i).randint(
            0, cfg.vocab_size, args.prompt_len).tolist(),
            max_new=args.max_new)
        for i in range(args.requests))
    reqs = list(pending)
    t0 = time.time()
    while pending:
        req = pending.popleft()
        if not eng.submit(req):
            print(f"error: request {req.rid} rejected: {req.why_rejected}")
            return 2
    eng.run()
    dt = time.time() - t0

    rep = eng.report()
    done = sum(r.done for r in reqs)
    print(f"served {done}/{len(reqs)} requests in {dt:.1f}s "
          f"[{rep['mode']} mode"
          f"{', fused' if rep.get('fused') else ''}] "
          f"tput={rep['throughput_tok_s']:.1f} tok/s "
          f"ttft_p50={rep['ttft_s']['p50']*1e3:.0f}ms "
          f"tpot_p50={rep['tpot_s']['p50']*1e3:.0f}ms "
          f"compile={rep['compile_s']:.1f}s")
    if "kv_pages" in rep:
        kv = rep["kv_pages"]
        print(f"kv pages: {kv['n_pages']}x{kv['page_size']}tok "
              f"hit_rate={kv['hit_rate']*100:.0f}% "
              f"evictions={kv['evictions']}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    if eng.sched.cancelled:
        print(f"error: {len(eng.sched.cancelled)}/{len(reqs)} requests "
              f"timed out (--request-timeout {args.request_timeout:g}s):")
        for r in eng.sched.cancelled:
            print(f"  req {r.rid}: {r.why_rejected} "
                  f"({len(r.out)}/{r.max_new} tokens generated)")
        return 3
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
