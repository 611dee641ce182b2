#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
computes the right thing on an NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and the checkout's sources -- no network,
no CPU fallback.  Any failure (no GPU, a kernel that does not build or
launch, a comparison out of tolerance, an unserved request, a loss that does
not fall) ends the run with a non-zero exit code.  Phases, one JSON object
per line, each with ``at_s``, the seconds since the script's imports ended:

  env           card name and power limit (``nvidia-smi``), torch / CUDA /
                nvcc versions, seconds spent building the kernels;
  kernel_cases  each CUDA kernel against its plain PyTorch version on the
                card: the reference's test cases (forward fp32 at 2e-5 /
                1e-5, backward fp32 at 5e-4, bf16 at 2e-2; the training
                kernels' bf16 results also against the size of what they
                compare, see ``SCALED_TOL``) and the shapes the served and
                the trained llama3.2-3b give them, and at stablelm-12b's
                head_dim 160 (fp32 and bf16; its served prefill, decode and
                trained shapes), with times (CUDA events), the plain
                version's time, one PyTorch library call's time where there
                is one, and the bound (least time the card could take); at
                both train shapes, faults planted in the plain backward's
                result (a skipped 64- or 128-key tile) must fail the same
                comparison, and at D = 160 so must a dropped tail panel
                (columns 128-159 of o, dq, dk and dv zeroed); the training
                kernels also at recurrentgemma-2b's D = 256 (the reference's
                backward cases at D = 256 in fp32 and bf16, its MQA heads
                under windows, and its trained shape, 2 x 4096 tokens under
                the 2048 window, where a dropped tail panel, a lost column
                half (columns 128-255 of dq, dk and dv: one warpgroup's
                dK and dV), tiles skipped under the window and a head
                slice's dK/dV partial dropped or counted twice must be
                rejected, and two calls must be bit-identical); the RG-LRU
                backward
                against its plain reverse scan and autograd of the plain
                forward (ragged S, with and without h0) and at the trained
                shape, where a zeroed carry into chunk 1 must be rejected,
                each of its saved forwards (the RG-LRU kernel's, the trained
                shape's included) held to the plain forward; the SSD
                backward against its written-out plain version (ragged S, S
                shorter than a chunk, G = 2, h0, a gradient of h_final, fp32
                and bf16; see ``SSD_BWD_TOL_BF16``), in fp32 also against
                autograd of the plain forward, and at mamba2's trained
                shape (2 x 4096 tokens), where the SSD forward is held to
                its plain version too, two calls must be bit-identical,
                three faults planted in the plain result (a zeroed carry of
                the reverse state pass, one chunk's dB partial dropped from
                the group sum, dA summed over one batch row) and the
                backward with its split fp32 operands in bf16 alone must be
                rejected;
  ptxas         registers and spills that ``nvcc -Xptxas -v`` reported for
                the kernels of ``PTXAS_KERNELS``; a spill fails the run;
  memory_guards the bf16 warpgroup forward (served, with statistics),
                dK/dV and dQ at stablelm-12b's served and trained shapes and
                at ragged ones, and at recurrentgemma-2b's D = 256 (served
                and trained shapes under the 2048 window, a ragged windowed
                one), and the RG-LRU backward at its trained shape and a
                ragged one, and the SSD backward at its trained shape and a
                ragged one with h0 and dh_final (their scratch guarded too:
                the D = 256 dK/dV's head-slice partials, the SSD backward's
                states and partials), on tensors inside NaN guard bands at
                two alignments: no
                guard may change, and every output must equal the unguarded
                launch bit for bit, five times in a row (``memory_guards``,
                ``rglru_guards``, ``ssd_bwd_guards``);
  serve_paged   llama3.2-3b at full width in bf16, random weights from seed
                0 made on the device, 16 requests through
                ``AsyncServeEngine(mode="paged")``; pure-decode iterations
                must go through the paged decode kernel.  Every serving
                phase serves through the engine's CUDA graphs (its
                default): ``warmup()`` captures one per step key, and the
                line reports their count, capture seconds and pool bytes;
                the launch counts include the replays' captured launches;
  graphs        the served engine against one with ``graphs=False``, in
                turns (graphs, eager, eager, graphs: two rounds each, two
                sets of prompts), for llama3.2-3b paged here and for
                mamba2-780m and recurrentgemma-2b dense after their serving
                phases: greedy streams identical, launch counts equal, TTFT
                / TPOT p50 / p99 and tokens/s of each round, and one
                profiled decode step each way (a paged decode iteration of
                8 rows for llama; the dense decode step over every slot)
                whose logits must be bit-identical, or else within 2e-2 of
                max-abs;
  serve_dense   the same model, ``mode="dense"``, 4 requests; every prefill
                must go through the flash-attention kernel;
  parity        greedy streams with the kernels equal those with the plain
                oracle (2 layers, full-width heads, fp32); one bf16 decode
                step's logits kernel vs plain at full depth;
  train         llama3.2-3b trained at full width and depth (28 layers, bf16
                compute, fp32 parameters, per-block activation
                checkpointing, AdamW) on 2 x 4096-token synthetic batches
                for 5 steps; every step must launch the stats-emitting
                forward 2 x 28 times (forward and recompute) and each
                backward kernel 28 times; the first step's loss and
                attention gradients (wq, wk, wv of every layer) must agree
                within 2e-2 with a pass through the plain attention from the
                same weights and batch; the loss must fall (a smoke signal
                only); then one more step under torch.profiler (device time
                by kind of kernel, idle share);
  train_parity  one step with the kernels against one with the plain
                attention from the same weights and batch (2 layers,
                full-width heads, fp32: loss, grad norm, every gradient
                within 5e-4 of its max-abs) and bf16 gradients at full depth
                (grad norm, and the attention gradients of every layer,
                within 2e-2);
  serve_ssm     mamba2-780m at full width and depth in bf16 (48 SSM layers),
                random weights from seed 0 made on the device, 12 requests
                through ``AsyncServeEngine(mode="auto")`` (dense); every
                prefill must launch the SSD kernel once per layer;
  serve_hybrid  recurrentgemma-2b at full width and depth in bf16 ((R, R,
                A) x 8 + (R, R)), 6 requests, prompts up to 3000 tokens
                (past the 2048-token window, so the window mask and the ring
                wrap run); every prefill must launch the RG-LRU kernel 18
                times and the windowed flash kernel (D = 256) 8 times;
  parity_recurrent  for each of the two: greedy streams with the kernels
                equal those with the plain versions (2-layer mamba2, 3-layer
                (R, R, A) recurrentgemma, full width, fp32); one prefill at
                full depth, last-token logits kernel vs plain within 2e-4 of
                max-abs in fp32, and in bf16 within twice the spread between
                two plain implementations measured in the same run (one
                prefill; a prefill of all but 16 tokens, then 16 decode
                steps);
  train (again) recurrentgemma-2b trained at full width and depth ((R, R,
                A) x 8 + (R, R), 2.69 B parameters) as llama is: every step
                launches the stats forward 16 times, dK/dV and dQ 8 (D =
                256, window 2048), the RG-LRU forward 36 and its backward
                18; the first step's loss and the gradients of wq, wk, wv,
                wa, wx, lam and in_rec within 2e-2 of a pass through the
                plain attention and RG-LRU;
  serve_paged, serve_dense (again)  stablelm-12b (head_dim 160) at full
                width and depth in bf16 (40 layers, 12.1 B parameters),
                after llama's model is freed: the paged decode kernel once per
                layer of every pure-decode iteration, the flash kernel once
                per layer of every prefill;
  train (again) mamba2-780m trained at full width and depth (48 SSM layers,
                0.78 B parameters) as llama is: every step launches the SSD
                forward 96 times (forward and recompute) and the SSD
                backward 48; the loss and the gradients of in_x, in_b,
                in_c, in_dt, A_log, D and dt_bias of one pass through the
                kernels against one through the plain SSD, both in fp32 on
                the first batch, within 5e-4 of max-abs (bf16 alone moves
                them by up to 22 % at 48 layers; that pass runs the SSD
                backward's fp32 design, the bf16 steps its tensor-core
                design, held at the trained shape in kernel_cases), and the
                first step's bf16 loss within 2e-2 of the fp32 plain
                pass's;
  train (again) stablelm-12b at full width with its depth cut to 2 layers
                (its fp32 parameters and AdamW state at full depth, about
                194 GB, do not fit one card), 2 steps of 1 x 4096 tokens:
                the same launch counts per step and first-step parity;
  summary       the run's elapsed seconds, the kernels' build included;
  kernels       the per-kernel summary line, launches counted on the served
                and trained runs above (the attention kernels have a row per
                head dim: llama's D = 128, stablelm's D = 160 and
                recurrentgemma's D = 256; the SSD one for the served and one
                for the trained shape), and the RG-LRU and SSD backwards'
                rows (no TPU kernel: each replaces the reference's XLA
                gradient), each row with the design the library's dispatch
                names for its shape.

``kernel_cases`` also holds the SSD kernel (the reference's cases, the
ragged one included, fp32 and bf16 x/B/C, cases at mamba2's P and N with S
ragged, S shorter than a chunk, G > 1 and B > 1 over several chunks, h0 in
both dtypes, the sequential-recurrence case and the served shape; y and
h_final within 2e-4 of max |want| and per row, see ``SSD_TOL``; a dropped
chunk state update and a state passed on without its chunk's decay,
planted in the plain result, must fail the comparison, and so must the
chunked SSD with the split fp32 operands rounded to bf16; two calls must be
bit-identical), the RG-LRU kernel (the reference's cases at 2e-5, the
chunked scan's: a ragged last chunk, S shorter than a chunk, one step, B > 1
at the served width; and the served shape) and the flash kernel at D = 256
with a window (at the served shape a dropped last 64-column panel of o and
a key tile skipped under the window, planted in the plain result, must be
rejected).

Then the card's name and power limit as ``nvidia-smi`` prints them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.configs.base import (ATTN, ATTN_LOCAL,        # noqa: E402
                                      RGLRU, SSM, PolicyConfig,
                                      ShapeConfig)
from repro_torch.cluster.telemetry import ServingStats        # noqa: E402
from repro_torch.data import SyntheticDataset                  # noqa: E402
from repro_torch.kernels import build, ops                     # noqa: E402
from repro_torch.kernels.registry import bucket_pow2           # noqa: E402
from repro_torch.kernels.flash_attention import (              # noqa: E402
    attention_plain, design, flash_attention, live_key_tiles)
from repro_torch.kernels.flash_attention_bwd import (          # noqa: E402
    BWD_HEAD_DIMS, D256_DKV_BM, D256_DKV_BN, D256_DQ_BN, attention_bwd_plain,
    attention_delta, attention_fwd_stats_plain, design_dkv, design_dq,
    dkv_d256_slices, dkv_slices, flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd_stats, flash_attention_vjp)
from repro_torch.kernels.paged_attention import (              # noqa: E402
    paged_attention_plain, paged_decode_attention, split_pieces)
from repro_torch.kernels.rglru import (                        # noqa: E402
    CHUNK as rglru_chunk_len, rglru, rglru_bwd, rglru_bwd_plain, rglru_plain)
from repro_torch.kernels.ssd import (                          # noqa: E402
    CHUNK, bwd_design as ssd_bwd_design, bwd_slices as ssd_bwd_slices,
    design as ssd_design, kernel_chunk, ssd, ssd_bwd, ssd_bwd_plain,
    ssd_plain)
from repro_torch.models.lm import LM                           # noqa: E402
from repro_torch.models.ssm import ssd_decode_step             # noqa: E402
from repro_torch.optim import (AdamWConfig, ScheduleConfig,    # noqa: E402
                               global_norm)
from repro_torch.serve import AsyncServeEngine, ServeRequest   # noqa: E402
from repro_torch.serve.engine import (make_decode_step,        # noqa: E402
                                      make_prefill_step)
from repro_torch.train import trainer                          # noqa: E402

# published peaks of one H100 SXM (dense): what the bounds are stated against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ARCH = "llama3.2-3b"
DEV = "cuda"
# the trained shape: TRAIN_4K's sequence, its global batch of 256 cut to 2
# for one card
TRAIN_SHAPE = ShapeConfig("train_4k_b2", 4096, 2, "train")
TRAIN_SHAPE_BS = (TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len)
TRAIN_STEPS = 5
TRAIN_KERNELS = ("flash_attention_fwd_stats", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")

# stablelm-12b: head_dim 5120 / 32 = 160.  Served at full width and depth
# (12.1 B parameters, 24 GB in bf16); trained at full width with its depth
# cut, as 12.1 B fp32 parameters with AdamW state (about 194 GB) do not fit
# one card
STABLELM_ARCH = "stablelm-12b"
TRAIN_CUT_LAYERS = 2
TRAIN_CUT_SHAPE = ShapeConfig("train_4k_b1", 4096, 1, "train")
TRAIN_CUT_STEPS = 2
TRAIN_CUT = ("depth 40 -> 2 layers (12.1 B fp32 parameters with AdamW "
             "state, ~194 GB, do not fit one card)",
             "global batch 256 -> 1 (one card)", "5 steps -> 2")

# recurrentgemma-2b trained at full width and depth ((R, R, A) x 8 + (R, R),
# 2.69 B parameters, ~43 GB of fp32 parameters, gradients and AdamW state) on
# TRAIN_SHAPE: 4096 tokens a row, past its 2048-token window.  The first
# step is held against the plain attention and RG-LRU on the attention
# blocks' projections and these RG-LRU leaves
HYBRID_TRAIN_LEAVES = ("wq", "wk", "wv", "wa", "wx", "lam", "in_rec")
# mamba2-780m trained at full width and depth (48 SSM layers, 0.78 B
# parameters) on TRAIN_SHAPE; the first step is held against the plain SSD
# on the SSM leaves that reach the scan
SSM_TRAIN_LEAVES = ("in_x", "in_b", "in_c", "in_dt", "A_log", "D", "dt_bias")

# the bf16 design the library's dispatch must name for each attention
# kernel at the served and trained head dims (the stats-emitting forward is
# the forward's launch)
WANT_DESIGN = {
    "flash_attention": {32: "mma.sync", 64: "wgmma", 128: "wgmma",
                        160: "wgmma", 256: "wgmma"},
    "flash_attention_bwd_dkv": {32: "mma.sync", 64: "wgmma", 128: "wgmma",
                                160: "wgmma", 256: "wgmma"}}
WANT_DESIGN["flash_attention_fwd_stats"] = WANT_DESIGN["flash_attention"]
WANT_DESIGN["flash_attention_bwd_dq"] = WANT_DESIGN["flash_attention_bwd_dkv"]

# kernels whose registers and spills ``nvcc -Xptxas -v`` must report (no
# spill allowed)
PTXAS_KERNELS = [
    "flash_fwd_wgmma_kernelILi256", "flash_fwd_wgmma_kernelILi160",
    "flash_fwd_wgmma_kernelILi128", "flash_fwd_wgmma_kernelILi64",
    "flash_bwd_dkv_wgmma_kernelILi160", "flash_bwd_dkv_wgmma_kernelILi128",
    "flash_bwd_dkv_wgmma_kernelILi64", "flash_bwd_dq_wgmma_kernelILi160",
    "flash_bwd_dq_wgmma_kernelILi128", "flash_bwd_dq_wgmma_kernelILi64",
    "flash_bwd_dkv_d256_kernel", "flash_bwd_dq_d256_kernel",
    "flash_bwd_dkv_sum_kernel",
    "flash_bwd_dkv_kernelIfLi256", "flash_bwd_dq_kernelIfLi256",
    "flash_fwd_kernelIfLi160", "flash_fwd_kernelIfLi256",
    "flash_bwd_dkv_kernelIfLi160", "flash_bwd_dq_kernelIfLi160",
    "paged_split_kernel", "paged_merge_kernel",
    "ssd_state_tc_kernel", "ssd_pass_kernel", "ssd_output_tc_kernel",
    "ssd_state_kernel", "ssd_output_kernel",
    "rglru_chunk_kernel", "rglru_carry_kernel", "rglru_scan_kernel",
    "rglru_bwd_chunk_kernel", "rglru_bwd_carry_kernel",
    "rglru_bwd_scan_kernel", "ssd_bwd_state_kernel", "ssd_bwd_pass_kernel",
    "ssd_bwd_chunk_kernel", "ssd_bwd_group_kernel", "ssd_bwd_da_kernel",
    "ssd_bwd_state_tc_kernel", "ssd_bwd_tc_kernel"]


def cut_depth(cfg, n_layers):
    """``cfg`` with only its first ``n_layers`` blocks."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-{n_layers}l",
                               n_layers=n_layers,
                               block_pattern=cfg.pattern[:n_layers])


T_IMPORTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s``: seconds since the script's imports ended."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_IMPORTED}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(calls, iters: int) -> float:
    """Mean device milliseconds of one call: ``iters`` rounds over the
    closures in ``calls`` (several closures over different buffers keep a
    bandwidth-bound kernel's inputs out of the L2 cache), timed with CUDA
    events after a warm-up."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    n = iters * len(calls)
    # one graph of all the launches: the events then time the device, not
    # the Python that enqueues it
    with torch.cuda.graph(graph):
        for _ in range(iters):
            for f in calls:
                f()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_in_turns(new, earlier, iters: int):
    """(new ms, earlier ms): two designs of one kernel timed in turns --
    new, earlier, earlier, new -- each the mean of its two timings."""
    a1, b1, b2, a2 = (time_ms([f], iters) for f in (new, earlier, earlier,
                                                     new))
    return (a1 + a2) / 2, (b1 + b2) / 2


def _entry(lib, entry, tensors, causal=True, window=0):
    """A closure that launches ``entry`` of the kernels' library ``lib``
    with the arguments of the forward or backward entry points: the
    pointers of ``tensors`` (None for a null pointer; q and k first, bf16),
    then the shapes and the mask.  It holds the tensors, so their memory
    outlives it."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    q, k = tensors[:2]
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]

    def call():
        # the pointers are taken here, from ``tensors``: the closure holds
        # the tensors, not only their addresses
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        rc = fn(*ptrs, B, S, T, H, K, D, 1, int(causal), int(window), 0.0,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{entry} returned {rc}")
    return call


# ---------------------------------------------------------------------------
# kernels vs their plain versions
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # B, S, T, H, K, D, causal, window, dtype -- the reference's test cases
    (2, 128, 128, 8, 2, 32, True, 0, torch.float32),
    (1, 256, 256, 4, 4, 64, True, 0, torch.float32),
    (2, 128, 128, 6, 1, 32, False, 0, torch.float32),
    (1, 256, 256, 8, 2, 32, True, 64, torch.float32),
    (1, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 64, 64, 2, 2, 128, True, 32, torch.float32),
    # ragged tiles, S != T, soft-cap
    (1, 100, 77, 6, 2, 64, True, 0, torch.float32),
    (2, 130, 130, 3, 1, 128, True, 50, torch.bfloat16),
    (2, 96, 200, 4, 4, 32, False, 0, torch.bfloat16),
    (1, 200, 200, 6, 2, 64, True, 0, torch.bfloat16),
    # the warpgroup design (bf16, D = 64 / 128): several 128-row and 128-key
    # tiles, heads of a group in different blocks, S != T with a window
    (1, 384, 384, 24, 8, 128, True, 0, torch.bfloat16),
    (2, 300, 520, 6, 2, 128, True, 200, torch.bfloat16),
    (2, 300, 300, 6, 2, 64, True, 0, torch.bfloat16),
    # stablelm-12b's D = 160 (bf16 on the warpgroup design in five 32-column
    # panels; fp32 in float2 column slices): ragged tiles, S != T, a window,
    # MHA and G = 4
    (1, 200, 200, 8, 2, 160, True, 0, torch.float32),
    (2, 130, 77, 4, 4, 160, False, 0, torch.float32),
    (1, 300, 300, 8, 2, 160, True, 64, torch.bfloat16),
    (2, 130, 200, 12, 4, 160, False, 0, torch.bfloat16),
    (1, 256, 256, 32, 8, 160, True, 0, torch.bfloat16),
]
PAGED_CASES = [
    # B, T, D, G, K, page_size, lengths -- the reference's test cases
    (2, 64, 32, 2, 2, 16, [64, 40]),
    (1, 128, 64, 1, 4, 16, [96]),
    (4, 64, 32, 4, 1, 8, [64, 8, 17, 33]),
    (2, 64, 32, 2, 2, 16, [16, 32]),
    (3, 32, 64, 2, 2, 8, [1, 31, 32]),
    (2, 64, 32, 2, 2, 16, [0, 64]),            # zero-length row
    (2, 96, 128, 6, 2, 12, [95, 3]),           # page size not a power of 2
    (2, 64, 64, 12, 1, 16, [64, 5]),           # G > 8: two head chunks
    # split-KV (pieces of 128 tokens, whole pages): rows of several pieces,
    # lengths at and one past a piece boundary, a row shorter than a piece,
    # pieces with no live token, a zero-length row
    (4, 1024, 128, 3, 8, 16, [1024, 257, 256, 1]),
    (3, 384, 160, 4, 8, 16, [129, 128, 0]),    # stablelm-12b's D and G
    (2, 512, 160, 4, 2, 16, [512, 300]),
    (2, 96, 160, 2, 2, 12, [95, 3]),           # 120-token pieces
    (2, 256, 160, 12, 1, 16, [200, 129]),      # G > 8 at D = 160
]


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=DEV,
                       dtype=torch.float32).to(dtype)


def _tol(dtype, fp32_tol):
    return 2e-2 if dtype == torch.bfloat16 else fp32_tol


def _within(got, want, tol) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _err(got, want, tol, what):
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(_within(got, want, tol),
          f"{what}: max abs err {err} exceeds atol=rtol={tol}")
    return err


# The training kernels' bf16 results are also held to the size of what they
# compare: at the train shape a typical gradient entry is about 0.03, so 2e-2
# elementwise alone would let a kernel drop part of every row.  Errors over
# the largest |want|, over the norm of want (relative Frobenius), and each
# row's (last axis) error over that row's norm, floored at the median row
# norm (a query that sees a single key has a zero gradient).
SCALED_TOL = {"max_err_over_max_abs": 2e-2, "rel_fro": 1e-2,
              "row_rel_max": 5e-2}


def _scaled(got, want):
    got, want = got.float(), want.float()
    diff = got - want
    rows = want.norm(dim=-1)
    floor = rows.flatten().median()
    return {"max_err_over_max_abs":
            float(diff.abs().max() / want.abs().max()),
            "rel_fro": float(diff.norm() / want.norm()),
            "row_rel_max": float((diff.norm(dim=-1)
                                  / torch.maximum(rows, floor)).max())}


def _passes(scaled, tol=SCALED_TOL) -> bool:
    return all(v <= tol[k] for k, v in scaled.items())


def _scaled_err(got, want, what, tol=SCALED_TOL):
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    s = _scaled(got, want)
    check(_passes(s, tol), f"{what}: scaled errors {s} exceed {tol}")
    return s


def flash_cases(gen):
    rows = []
    for (B, S, T, H, K, D, causal, window, dt) in ATTN_CASES:
        q = _randn(gen, B, S, H, D, dtype=dt)
        k = _randn(gen, B, T, K, D, dtype=dt)
        v = _randn(gen, B, T, K, D, dtype=dt)
        for softcap in (0.0, 30.0):
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_plain(q, k, v, **kw)
            tol = _tol(dt, 2e-5)
            what = f"flash_attention {(B, S, T, H, K, D, causal, window)} " \
                   f"{dt} softcap={softcap}"
            rows.append({"shape": [B, S, T, H, K, D], "causal": causal,
                         "window": window, "softcap": softcap,
                         "dtype": str(dt), "tol": tol,
                         "max_abs_err": _err(got, want, tol, what)})
    return rows


# A dropped tail panel -- at D = 160 columns 128-159 of a result left out,
# as a 64-column panel split of the 160 columns would drop them; at D = 256
# the last of the four 64-column panels -- planted in the plain result: each
# must fail both comparisons the kernel passes.
TAIL_COLUMNS = {160: slice(128, 160), 256: slice(192, 256)}


def _tail_panel_fault(want, what):
    """``want`` with its tail panel (``TAIL_COLUMNS`` of its last axis)
    zeroed, held to ``want`` by the elementwise 2e-2 and ``SCALED_TOL``;
    fails the run if either accepts it.  Returns the fault's scaled
    errors."""
    bad = want.float().clone()
    bad[..., TAIL_COLUMNS[want.shape[-1]]] = 0.0
    scaled = _scaled(bad, want)
    check(not _within(bad, want, 2e-2) and not _passes(scaled),
          f"planted fault {what} (tail panel dropped) passes a comparison "
          f"{scaled}: it cannot see it")
    return scaled


def flash_main_shape(gen, cfg, S):
    """Prefill of one ``S``-token bucket of the served model: bf16, causal.
    At D = 160 a dropped tail panel of o must be rejected."""
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    q = _randn(gen, 1, S, H, D, dtype=dt)
    k = _randn(gen, 1, S, K, D, dtype=dt)
    v = _randn(gen, 1, S, K, D, dtype=dt)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, causal=True)
    what = f"flash_attention main shape {cfg.name} S={S}"
    err = _err(got, want, 2e-2, what)
    scaled = _scaled_err(got, want, what)

    faults = {}
    if D in TAIL_COLUMNS:
        faults["planted_fault_tail_panel"] = _tail_panel_fault(want,
                                                               f"{what} o")
    ms = time_ms([lambda: flash_attention(q, k, v, causal=True)], 10)
    plain_ms = time_ms([lambda: attention_plain(q, k, v, causal=True)], 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(
        [lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)], 10)
    # each input read once, the output written once; causal: query i sees
    # i + 1 keys, two products of 2*D flops per (query, key) pair
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * D * H * (S * (S + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {"arch": cfg.name, "shape": [1, S, S, H, K, D], "dtype": str(dt),
            "tol": 2e-2, "design": design(D, dt), "max_abs_err": err,
            "scaled": scaled, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, **faults}


def _paged_inputs(gen, B, T, D, G, K, ps, lengths, dt, copies=1):
    """Random q and ``copies`` disjoint pools' worth of pages with shuffled,
    per-row exclusive tables (one table set per copy)."""
    H, P = G * K, T // ps
    n = copies * B * P + 1
    q = _randn(gen, B, H, D, dtype=dt)
    kp = _randn(gen, n, ps, K, D, dtype=dt)
    vp = _randn(gen, n, ps, K, D, dtype=dt)
    tables = [(torch.randperm(B * P, generator=gen, device=DEV)
               .reshape(B, P) + c * B * P).to(torch.int32)
              for c in range(copies)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return q, kp, vp, tables, lens


def paged_cases(gen):
    rows = []
    for (B, T, D, G, K, ps, lengths) in PAGED_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, tabs, lens = _paged_inputs(gen, B, T, D, G, K, ps,
                                                  lengths, dt)
            for softcap in (0.0, 30.0):
                got = paged_decode_attention(q, kp, vp, tabs[0], lens,
                                             softcap=softcap)
                torch.cuda.synchronize()
                want = paged_attention_plain(q, kp, vp, tabs[0], lens,
                                             softcap=softcap)
                tol = _tol(dt, 1e-5)
                what = f"paged_decode_attention " \
                       f"{(B, T, D, G, K, ps, lengths)} {dt} " \
                       f"softcap={softcap}"
                err = _err(got, want, tol, what)
                for b, n in enumerate(lengths):
                    if n == 0:
                        check(bool((got[b] == 0).all()),
                              f"{what}: zero-length row is not zero")
                rows.append({"shape": [B, T, D, G, K, ps],
                             "lengths": lengths, "softcap": softcap,
                             "dtype": str(dt), "tol": tol,
                             "max_abs_err": err})
    # slots at or past lengths[b] are never read: poison them with NaN
    B, T, D, G, K, ps, lengths = 2, 64, 32, 2, 2, 16, [40, 17]
    q, kp, vp, tabs, lens = _paged_inputs(gen, B, T, D, G, K, ps, lengths,
                                          torch.float32)
    clean = paged_decode_attention(q, kp, vp, tabs[0], lens)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[-1] = vp2[-1] = float("nan")
    tab = tabs[0].cpu()
    for b, n in enumerate(lengths):
        for t in range(n, T):
            kp2[tab[b, t // ps], t % ps] = float("nan")
            vp2[tab[b, t // ps], t % ps] = float("nan")
    dirty = paged_decode_attention(q, kp2, vp2, tabs[0], lens)
    check(bool(torch.equal(clean, dirty)),
          "paged_decode_attention read a slot past lengths[b]")
    return rows


def paged_main_shape(gen, cfg):
    """Decode step of the served model: 8 sequences, page 16, ragged lengths
    up to 2048, bf16.  Four disjoint pools are cycled so that every launch
    finds its K/V in device memory, not in the L2 cache, as a layer of the
    served model does."""
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lengths = [2048, 1900, 1500, 1111, 1024, 700, 300, 129]
    dt = torch.bfloat16
    q, kp, vp, tabs, lens = _paged_inputs(gen, 8, 2048, D, H // K, K, 16,
                                          lengths, dt, copies=4)
    err = 0.0
    for tab in tabs:
        got = paged_decode_attention(q, kp, vp, tab, lens)
        torch.cuda.synchronize()
        err = max(err, _err(got, paged_attention_plain(q, kp, vp, tab, lens),
                            2e-2, f"paged_decode_attention main shape "
                                  f"{cfg.name}"))
    ms = time_ms([lambda tab=tab: paged_decode_attention(q, kp, vp, tab, lens)
                  for tab in tabs], 10)
    plain_ms = time_ms(
        [lambda tab=tab: paged_attention_plain(q, kp, vp, tab, lens)
         for tab in tabs], 3)
    # device time of the call's two kernels (the pieces, their merge), over
    # 20 calls
    staged = _profile(lambda: [paged_decode_attention(q, kp, vp, tab, lens)
                               for tab in tabs * 5],
                      f"paged_decode_attention {cfg.name}")
    stage_ms = {re.search(r"paged_\w+_kernel", name).group(0): t / 20
                for name, t in staged["top_kernels_ms"] if "paged_" in name}
    live = sum(lengths)
    pages, n_pieces = split_pieces(tabs[0].shape[1], 16)
    # live K and V rows read once, q read and out written once, plus the
    # table entries and lengths the kernel follows
    nbytes = (2 * live * K * D + 2 * q.numel()) * q.element_size() \
        + 4 * (sum(-(-n // 16) for n in lengths) + len(lengths))
    flops = 4 * live * H * D
    return dict({"arch": cfg.name, "shape": [8, 2048, D, H // K, K, 16],
                 "lengths": lengths, "dtype": str(dt), "tol": 2e-2,
                 "design": "split-KV", "piece_tokens": pages * 16,
                 "pieces": n_pieces,
                 "live_blocks": K * sum(-(-n // (pages * 16))
                                        for n in lengths),
                 "max_abs_err": err, "ms": ms, "stage_ms_profiled": stage_ms,
                 "plain_ms": plain_ms, "library_ms": None},
                **_bound(nbytes, flops, dt))


# ---------------------------------------------------------------------------
# the training kernels (stats-emitting forward, dK/dV, dQ)
# ---------------------------------------------------------------------------
BWD_CASES = [
    # B, S, T, H, K, D, causal, window, dtype -- tests/test_kernels_bwd.py
    (2, 128, 128, 4, 2, 32, True, 0, torch.float32),
    (1, 128, 128, 4, 4, 64, True, 0, torch.float32),      # MHA
    (1, 128, 128, 6, 1, 32, False, 0, torch.float32),     # MQA, bidir.
    (1, 256, 256, 4, 2, 32, True, 64, torch.float32),     # window
    # ragged S*G and T tiles, S != T, windows, MQA with G = 6
    (1, 100, 77, 6, 2, 64, True, 0, torch.float32),
    (2, 130, 130, 3, 1, 128, True, 50, torch.float32),
    (1, 96, 200, 6, 1, 64, False, 0, torch.float32),
    (1, 200, 150, 4, 2, 128, True, 0, torch.float32),
    (1, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 130, 130, 6, 1, 32, True, 50, torch.bfloat16),
    (1, 100, 77, 24, 8, 128, True, 0, torch.bfloat16),
    # the warpgroup dK/dV (bf16, D = 128 and 64): window 50 with G = 3,
    # S = 100 against T = 77, MQA (G = 6) bidirectional with S != T, and
    # several 128-key tiles at 24 / 8 heads
    (2, 130, 130, 3, 1, 128, True, 50, torch.bfloat16),
    (2, 130, 130, 6, 2, 64, True, 50, torch.bfloat16),
    (1, 100, 77, 6, 2, 64, True, 0, torch.bfloat16),
    (1, 96, 200, 6, 1, 128, False, 0, torch.bfloat16),
    (1, 96, 200, 6, 1, 64, False, 0, torch.bfloat16),
    (1, 384, 384, 24, 8, 128, True, 0, torch.bfloat16),
    (1, 384, 384, 24, 8, 64, True, 0, torch.bfloat16),
    # the warpgroup dQ (bf16, D = 128 and 64, 128 positions a block):
    # several blocks with ragged S, windows, G = 3, S != T
    (2, 300, 300, 6, 2, 64, True, 100, torch.bfloat16),
    (1, 300, 520, 6, 2, 128, True, 200, torch.bfloat16),
    # stablelm-12b's D = 160 (bf16 dK/dV on the warpgroup design at 32-query
    # tiles, dQ at 64-key tiles, both on five 32-column panels; fp32 on the
    # CUDA cores): ragged tiles, S != T, a window, MQA bidirectional, G = 4
    (1, 200, 150, 4, 2, 160, True, 0, torch.float32),
    (2, 130, 130, 3, 1, 160, True, 50, torch.float32),
    (1, 100, 77, 8, 2, 160, True, 0, torch.bfloat16),
    (2, 130, 130, 6, 2, 160, True, 50, torch.bfloat16),
    (1, 96, 200, 4, 1, 160, False, 0, torch.bfloat16),
    (1, 384, 384, 32, 8, 160, True, 0, torch.bfloat16),
    # the warpgroup dQ at D = 160: several blocks of 128 positions with
    # ragged S, windows, G = 3, S != T
    (2, 300, 300, 6, 2, 160, True, 100, torch.bfloat16),
    (1, 300, 520, 6, 2, 160, True, 200, torch.bfloat16),
    # recurrentgemma-2b's D = 256: the reference's four cases above in fp32
    # and bf16 at D = 256 (the fp32 CUDA cores at 32 x 32 tiles; bf16 dK/dV
    # in items of 64 keys and a head slice, 64-query tiles, dQ at 48-key
    # tiles), then its
    # MQA heads (G = 10) under windows, ragged S, S != T, G = 2 and 3
    (2, 128, 128, 4, 2, 256, True, 0, torch.float32),
    (1, 128, 128, 4, 4, 256, True, 0, torch.float32),
    (1, 128, 128, 6, 1, 256, False, 0, torch.float32),
    (1, 256, 256, 4, 2, 256, True, 64, torch.float32),
    (2, 128, 128, 4, 2, 256, True, 0, torch.bfloat16),
    (1, 128, 128, 4, 4, 256, True, 0, torch.bfloat16),
    (1, 128, 128, 6, 1, 256, False, 0, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, True, 64, torch.bfloat16),
    (1, 300, 300, 10, 1, 256, True, 64, torch.float32),
    (1, 300, 300, 10, 1, 256, True, 64, torch.bfloat16),
    (2, 130, 130, 10, 1, 256, True, 0, torch.bfloat16),
    (1, 1000, 1000, 10, 1, 256, True, 200, torch.bfloat16),
    (1, 300, 520, 4, 2, 256, True, 100, torch.bfloat16),
    (2, 200, 333, 10, 1, 256, False, 0, torch.bfloat16),
    (1, 100, 77, 6, 3, 256, True, 0, torch.bfloat16),
]


def _bwd_inputs(gen, B, S, T, H, K, D, dt):
    return (_randn(gen, B, S, H, D, dtype=dt), _randn(gen, B, T, K, D, dtype=dt),
            _randn(gen, B, T, K, D, dtype=dt), _randn(gen, B, S, H, D, dtype=dt))


def _bwd_check(q, k, v, ct, kw, tol_fwd, tol_bwd, what):
    """Each of the three kernels against its plain version on the same
    inputs; returns the largest error of each and, for bf16, the scaled
    errors of o, dq, dk and dv."""
    o, m, l = flash_attention_fwd_stats(q, k, v, **kw)
    torch.cuda.synchronize()
    o2, m2, l2 = attention_fwd_stats_plain(q, k, v, **kw)
    err_f = max(_err(o, o2, tol_fwd, f"{what} fwd_stats o"),
                _err(m, m2, tol_fwd, f"{what} fwd_stats m"),
                _err(l, l2, tol_fwd, f"{what} fwd_stats l"))
    delta = attention_delta(o, ct)
    dk, dv = flash_attention_bwd_dkv(q, k, v, ct, m, l, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, ct, m, l, delta, **kw)
    torch.cuda.synchronize()
    dq2, dk2, dv2 = attention_bwd_plain(q, k, v, ct, m, l, delta, **kw)
    err_kv = max(_err(dk, dk2, tol_bwd, f"{what} bwd_dkv dk"),
                 _err(dv, dv2, tol_bwd, f"{what} bwd_dkv dv"))
    err_q = _err(dq, dq2, tol_bwd, f"{what} bwd_dq dq")
    scaled = {}
    if q.dtype == torch.bfloat16:
        scaled = {n: _scaled_err(a, b, f"{what} {n}") for n, a, b in
                  (("o", o, o2), ("dq", dq, dq2), ("dk", dk, dk2),
                   ("dv", dv, dv2))}
    return err_f, err_kv, err_q, scaled


def bwd_cases(gen):
    rows = []
    for (B, S, T, H, K, D, causal, window, dt) in BWD_CASES:
        q, k, v, ct = _bwd_inputs(gen, B, S, T, H, K, D, dt)
        for softcap in (0.0, 30.0):
            kw = dict(causal=causal, window=window, softcap=softcap)
            what = f"flash bwd {(B, S, T, H, K, D, causal, window)} {dt} " \
                   f"softcap={softcap}"
            tol_f, tol_b = _tol(dt, 2e-5), _tol(dt, 5e-4)
            ef, ekv, eq, scaled = _bwd_check(q, k, v, ct, kw, tol_f, tol_b,
                                             what)
            rows.append({"shape": [B, S, T, H, K, D], "causal": causal,
                         "window": window, "softcap": softcap,
                         "dtype": str(dt), "tol_fwd": tol_f, "tol_bwd": tol_b,
                         "err_fwd_stats": ef, "err_bwd_dkv": ekv,
                         "err_bwd_dq": eq, "scaled": scaled})
    # the gradients of the whole Function against autograd of the plain
    # forward (fp32, the first reference case, with and without soft-cap)
    B, S, T, H, K, D = 2, 128, 128, 4, 2, 32
    q, k, v, ct = _bwd_inputs(gen, B, S, T, H, K, D, torch.float32)
    autograd = []
    for softcap in (0.0, 30.0):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(
            (flash_attention_vjp(*leaves, True, 0, softcap) * ct).sum(),
            leaves)
        want = torch.autograd.grad(
            (attention_plain(*leaves, causal=True, softcap=softcap)
             * ct).sum(), leaves)
        autograd.append({"softcap": softcap, "tol": 5e-4, "max_abs_err": max(
            _err(g, w, 5e-4, f"flash_attention_vjp vs autograd {n}")
            for g, w, n in zip(got, want, ("dq", "dk", "dv")))})
    return rows, autograd


def _bound(nbytes, flops, dt):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _window_mask(S, T, window):
    """(S, T) bool, True where causal attention under ``window`` attends."""
    i = torch.arange(S, device=DEV)[:, None]
    j = torch.arange(T, device=DEV)[None, :]
    return (j <= i) & (i - j < window)


def _library_bwd_ms(q, k, v, do, iters, rounds=5, window=0):
    """The backward of ``scaled_dot_product_attention`` (dq, dk and dv in
    one call; causal, under ``window`` as a boolean mask where it is
    given) through ``torch.autograd.grad``, timed with CUDA events around
    ``iters`` eager calls, in ``rounds`` rounds (autograd's backward is not
    graph-captured here, and one round's time spread 1.2-2.7 ms between
    calls): the median and the minimum of the rounds' means."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    mask = dict(is_causal=True) if window == 0 else dict(
        attn_mask=_window_mask(q.shape[1], k.shape[1], window))
    times = []
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask)
        for _ in range(2):
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        for _ in range(rounds):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), float(min(times))


def _planted_faults(q, k, v, do, stats, kw, tile=64):
    """Faults planted in the plain backward's result, each of which the
    scaled comparison must reject: (a) every query row loses the keys of
    its own ``tile``-key block -- a skipped diagonal tile -- in dq, dk and
    dv; (b) the ``tile`` query positions at mid-sequence lose one block of
    ``tile`` keys at a quarter of it -- a single skipped tile.  Returns each
    fault's scaled errors."""
    B, S = q.shape[:2]
    want = dict(zip(("dq", "dk", "dv"),
                    attention_bwd_plain(q, k, v, do, *stats, **kw)))

    def tiles(x):
        return x.float().reshape(B * (S // tile), tile, *x.shape[2:])

    faults = {}
    diag = attention_bwd_plain(*(tiles(x) for x in (q, k, v, do) + stats),
                               **kw)
    for (n, w), part in zip(want.items(), diag):
        faults[f"{n}_diagonal_tile"] = w.float() - part.reshape(w.shape)
    r, c = slice(S // 2, S // 2 + tile), slice(S // 4, S // 4 + tile)
    one = attention_bwd_plain(q[:, r].float(), k[:, c].float(),
                              v[:, c].float(), do[:, r].float(),
                              *(x[:, r] for x in stats), causal=False,
                              softcap=kw["softcap"])
    for (n, w), part, sl in zip(want.items(), one, (r, c, c)):
        bad = w.float().clone()
        bad[:, sl] -= part
        faults[f"{n}_one_tile"] = bad
    out = {}
    for n, bad in faults.items():
        out[n] = _scaled(bad, want[n[:2]])
        check(not _passes(out[n]), f"planted fault {n} passes the scaled "
                                   f"comparison {out[n]}: it cannot see it")
    return out


# The D = 256 backward keeps dK and dV of columns 128-255 in its second
# consumer warpgroup, and dQ's wide product covers them: a lost column half
# (zeroed in the plain result) must fail both comparisons.
HALF_COLUMNS = {256: slice(128, 256)}


def _pair_block(q, k, v, do, stats, rows, keys, window):
    """The share of the (query, key) pairs ``rows`` x ``keys`` in dq, dk and
    dv (fp32, causal under ``window``; ``stats`` = (m, l, delta)): what a
    kernel that skips that tile leaves out."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    m, l, delta = (x[:, rows].float() for x in stats)        # (B, r, H)
    qr, dor = q[:, rows].float(), do[:, rows].float()
    kk, vv = (x[:, keys].float().repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("brhd,bthd->bhrt", qr, kk) / D ** 0.5
    live = _window_mask(S, k.shape[1], window)[rows][:, keys]
    p = torch.where(live, torch.exp(s - m.permute(0, 2, 1)[..., None])
                    / l.permute(0, 2, 1)[..., None], 0.0)
    dp = torch.einsum("brhd,bthd->bhrt", dor, vv)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None]) / D ** 0.5
    dq = torch.einsum("bhrt,bthd->brhd", ds, kk)
    dk = torch.einsum("bhrt,brhd->bthd", ds, qr)
    dv = torch.einsum("bhrt,brhd->bthd", p, dor)
    return (dq, dk.reshape(B, -1, K, G, D).sum(3),
            dv.reshape(B, -1, K, G, D).sum(3))


def _window_tile_faults(q, k, v, do, stats, want, window):
    """Faults of the D = 256 walks under the window, planted in the plain
    backward's result ``want`` (dq, dk, dv): the dQ block of 128 positions
    whose first live key tile the window decides skips that tile (its
    ``D256_DQ_BN`` keys), and the dK/dV work items of the 64 keys at a
    quarter of the sequence skip the last query tile (``D256_DKV_BM``
    positions) the window leaves them.  The scaled comparison must reject
    each.  Returns their scaled errors."""
    S, T = q.shape[1], k.shape[1]
    bn = D256_DQ_BN
    m0 = 3 * S // 4 // 128 * 128       # m0 - window + 1: mid-tile at 2048
    n_begin = live_key_tiles(m0, 128, bn, T, True, window)[0]
    rows, keys = slice(m0, m0 + 128), slice(n_begin, n_begin + bn)
    dq_part = _pair_block(q, k, v, do, stats, rows, keys, window)[0]
    bad_dq = want[0].float().clone()
    bad_dq[:, m0:m0 + 128] -= dq_part
    n0 = T // 4 - T // 4 % D256_DKV_BN
    n1 = n0 + D256_DKV_BN
    m_end = min(S, n1 - 1 + window)
    m_last = (m_end - 1) // D256_DKV_BM * D256_DKV_BM
    _, dk_part, dv_part = _pair_block(q, k, v, do, stats,
                                      slice(m_last, m_end), slice(n0, n1),
                                      window)
    bad_dk, bad_dv = (w.float().clone() for w in want[1:])
    bad_dk[:, n0:n1] -= dk_part
    bad_dv[:, n0:n1] -= dv_part
    out = {}
    for n, bad, w in (("dq", bad_dq, want[0]), ("dk", bad_dk, want[1]),
                      ("dv", bad_dv, want[2])):
        out[n] = _scaled(bad, w)
        check(not _passes(out[n]), f"planted fault: a {n} tile skipped "
                                   f"under the window passes the scaled "
                                   f"comparison {out[n]}")
    out.update(dq_rows=[m0, m0 + 128], dq_keys=[n_begin, n_begin + bn],
               dkv_keys=[n0, n1], dkv_rows=[m_last, m_end])
    return out


def _slice_partial_faults(q, k, v, do, stats, want, window):
    """Faults of the D = 256 dK/dV's head slices, planted in the plain
    result ``want`` (dq, dk, dv; one KV head): the partial of the first
    head slice of the 64 keys at a quarter of the sequence (its heads'
    share of those keys' dK and dV, over every query) dropped from the
    fixed-order sum, and counted twice.  The scaled comparison must reject
    both.  Returns their scaled errors."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    check(K == 1, "the slice faults are planted for one KV head")
    nsl = dkv_slices(B, T, H, K, D, q.dtype)
    check(nsl == dkv_d256_slices(B, T, K, H // K),
          f"the library's {nsl} head slices and dkv_d256_slices' differ")
    gs = H // nsl + (H % nsl > 0)              # heads of slice 0
    n0 = T // 4 - T // 4 % D256_DKV_BN
    keys = slice(n0, n0 + D256_DKV_BN)
    _, dk_part, dv_part = _pair_block(
        q[:, :, :gs], k, v, do[:, :, :gs], tuple(x[:, :, :gs] for x in stats),
        slice(0, S), keys, window)
    out = {"slices": nsl, "heads": [0, gs], "keys": [n0, n0 + D256_DKV_BN]}
    for fault, sign in (("dropped", -1.0), ("doubled", 1.0)):
        for n, w, part in (("dk", want[1], dk_part), ("dv", want[2], dv_part)):
            bad = w.float().clone()
            bad[:, keys] += sign * part
            out[f"{n}_{fault}"] = _scaled(bad, w)
            check(not _passes(out[f"{n}_{fault}"]),
                  f"planted fault: {n} with a head slice's partial {fault} "
                  f"passes the scaled comparison {out[f'{n}_{fault}']}")
    return out


def bwd_main_shape(gen, cfg, B, S, window=0):
    """The trained model's attention at B x S tokens: its heads and head_dim,
    bf16, causal under ``window`` (llama3.2-3b: 24 heads over 8 KV heads of
    128; stablelm-12b: 32 over 8 of 160; recurrentgemma-2b: 10 over 1 of
    256, window 2048).  Faults planted in the plain backward's result must
    fail the comparison: a skipped 64- or 128-key tile; at D = 160 and 256
    a dropped tail panel of o, dq, dk and dv; at D = 256 a lost column half
    of dq, dk and dv, tiles skipped under the window and a head slice's
    dK/dV partial dropped or doubled.  At D = 256 two calls must also be
    bit-identical."""
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    q, k, v, do = _bwd_inputs(gen, B, S, S, H, K, D, dt)
    kw = dict(causal=True, window=window, softcap=0.0)
    ef, ekv, eq, scaled = _bwd_check(q, k, v, do, kw, 2e-2, 2e-2,
                                     f"flash bwd main shape {cfg.name}")
    o, m, l = flash_attention_fwd_stats(q, k, v, **kw)
    delta = attention_delta(o, do)
    stats = (m, l, delta)
    # a skipped tile of the mma.sync designs and of the warpgroup dQ (64
    # keys) and of the warpgroup forward and dK/dV (128 keys) must be seen
    faults = {f"tile_{t}": _planted_faults(q, k, v, do, stats, kw, tile=t)
              for t in (64, 128)}
    if D in TAIL_COLUMNS:
        o2 = attention_fwd_stats_plain(q, k, v, **kw)[0]
        grads = attention_bwd_plain(q, k, v, do, *stats, **kw)
        faults["tail_panel"] = {
            n: _tail_panel_fault(w, f"{cfg.name} {n}")
            for n, w in zip(("o", "dq", "dk", "dv"), (o2,) + grads)}
        if D in HALF_COLUMNS:
            faults["column_half"] = {}
            for n, w in zip(("dq", "dk", "dv"), grads):
                bad = w.float().clone()
                bad[..., HALF_COLUMNS[D]] = 0.0
                sc = _scaled(bad, w)
                check(not _within(bad, w, 2e-2) and not _passes(sc),
                      f"planted fault {cfg.name} {n} (columns 128-255 "
                      f"zeroed) passes a comparison {sc}")
                faults["column_half"][n] = sc
            faults["window_tiles"] = _window_tile_faults(q, k, v, do, stats,
                                                         grads, window)
            faults["slice_partials"] = _slice_partial_faults(
                q, k, v, do, stats, grads, window)
        del o2, grads
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * q.element_size()
    row_bytes = m.numel() * 4                  # one fp32 per query row
    # live (query, key) pairs
    pairs = H * B * _live_pairs(S, S, True, window)
    shape = {"arch": cfg.name, "shape": [B, S, S, H, K, D], "dtype": str(dt),
             "window": window, "tol": 2e-2}

    fwd = dict(shape, max_abs_err=ef, design=design(D, dt), **_bound(
        qkv_bytes + q.numel() * 2 + 2 * row_bytes, 4 * D * pairs, dt))

    fwd["ms"] = time_ms([lambda: flash_attention_fwd_stats(q, k, v, **kw)],
                        5)
    fwd["plain_ms"] = time_ms(
        [lambda: attention_fwd_stats_plain(q, k, v, **kw)], 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = dict(is_causal=True) if window == 0 else dict(
        attn_mask=_window_mask(S, S, window))
    fwd["library_ms"] = time_ms(
        [lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask)], 5)

    # backward: q, k, v, dO and three row statistics read; dk, dv or dq
    # written (in the inputs' dtype)
    bwd_in = qkv_bytes + do.numel() * 2 + 3 * row_bytes
    library_ms, library_min = _library_bwd_ms(q, k, v, do, 5, window=window)
    dkv = dict(shape, max_abs_err=ekv, design=design_dkv(D, dt), **_bound(
        bwd_in + (k.numel() + v.numel()) * 2, 8 * D * pairs, dt))

    dkv["ms"] = time_ms(
        [lambda: flash_attention_bwd_dkv(q, k, v, do, *stats, **kw)], 3)
    dq = dict(shape, max_abs_err=eq, design=design_dq(D, dt), **_bound(
        bwd_in + q.numel() * 2, 6 * D * pairs, dt))

    dq["ms"] = time_ms(
        [lambda: flash_attention_bwd_dq(q, k, v, do, *stats, **kw)], 3)
    plain_ms = time_ms(
        [lambda: attention_bwd_plain(q, k, v, do, *stats, **kw)], 1)
    for row in (dkv, dq):
        # the plain version and the library call compute dq, dk and dv
        # together: their times stand in both rows
        row["plain_ms"] = plain_ms
        row["library_ms"] = library_ms
        row["library_ms_min"] = library_min
    fwd["scaled"] = {"o": scaled["o"]}
    dkv["scaled"] = {n: scaled[n] for n in ("dk", "dv")}
    dq["scaled"] = {"dq": scaled["dq"]}
    if D in HALF_COLUMNS:
        _d256_bit_identical(q, k, v, do, stats, kw, dkv, dq)
    return fwd, dkv, dq, faults


def _d256_bit_identical(q, k, v, do, stats, kw, dkv, dq):
    """The D = 256 backward at the trained shape: two calls on the same
    inputs must be bit-identical (the slices' partials are summed in a fixed
    order).  Adds ``bit_identical_calls`` to the rows ``dkv`` and ``dq``."""
    got = flash_attention_bwd_dkv(q, k, v, do, *stats, **kw) + \
        (flash_attention_bwd_dq(q, k, v, do, *stats, **kw),)
    again = flash_attention_bwd_dkv(q, k, v, do, *stats, **kw) + \
        (flash_attention_bwd_dq(q, k, v, do, *stats, **kw),)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "flash bwd D=256: two calls on the same inputs differ")
    for row in (dkv, dq):
        row["bit_identical_calls"] = True


# ---------------------------------------------------------------------------
# the bf16 warpgroup attention kernels' memory accesses
# ---------------------------------------------------------------------------
# B, S, H, K, D, window of the guarded launches: stablelm-12b's served
# prefill and trained shapes, and ragged ones (S a multiple of no tile) at
# D = 160 and at D = 128, which runs the same code; recurrentgemma-2b's
# served shape (D = 256, MQA, window 2048) and a ragged one with a window
GUARD_SHAPES = [(1, 2048, 32, 8, 160, 0), (2, 4096, 32, 8, 160, 0),
                (2, 300, 4, 2, 160, 0), (1, 200, 6, 2, 128, 0),
                (1, 4096, 10, 1, 256, 2048), (2, 300, 10, 1, 256, 50),
                (2, 4096, 10, 1, 256, 2048)]
# B, S, W, h0 of the guarded RG-LRU backward: the trained shape and a
# ragged one with an initial state
RGLRU_GUARD_SHAPES = [(2, 4096, 2560, False), (3, 777, 300, True)]
GUARD = 4096            # NaN elements on each side of a guarded tensor
GUARD_OFFSETS = (0, 16)  # bytes past a 1024-byte boundary a tensor starts
GUARD_REPEATS = 5


def _guarded(x, offset):
    """``x`` copied into a NaN-filled buffer, ``GUARD`` elements plus
    ``offset`` bytes from its start and ``GUARD`` elements from its end:
    (the view, the buffer, the view's first element in the buffer)."""
    lo = GUARD + offset // x.element_size()
    buf = torch.full((lo + x.numel() + GUARD,), float("nan"), dtype=x.dtype,
                     device=x.device)
    view = buf[lo:lo + x.numel()].view(x.shape)
    view.copy_(x)
    return view, buf, lo


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _guards_intact(view, buf, lo) -> bool:
    nan = _bits(torch.full((1,), float("nan"), dtype=buf.dtype,
                           device=buf.device))
    rest = torch.cat([buf[:lo], buf[lo + view.numel():]])
    return bool((_bits(rest) == nan).all())


def _guarded_runs(call, g_in, g_out, wants, tag, repeats):
    """``call()`` on guarded inputs and outputs ``repeats`` times: the guard
    bands keep their bits and every output equals ``wants`` bit for bit."""
    for _ in range(repeats):
        for view, _, _ in g_out:
            view.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        check(all(_guards_intact(*g) for g in g_in + g_out),
              f"{tag}: a guard band changed")
        check(all(torch.equal(_bits(g[0]), _bits(w))
                  for g, w in zip(g_out, wants)),
              f"{tag}: output differs from the unguarded launch")


def rglru_guards(shapes=RGLRU_GUARD_SHAPES, repeats=GUARD_REPEATS):
    """The RG-LRU backward's C entry point on guarded tensors, as
    ``memory_guards`` does for the attention kernels; its workspace lies in
    a guard band too."""
    from repro_torch.kernels.rglru import _kernel as rglru_entry
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    fn = rglru_entry("repro_rglru_bwd", 8)
    out = []
    for B, S, W, with_h0 in shapes:
        la, g, h0, dy = _rglru_inputs(gen, B, S, W)
        h0 = h0 if with_h0 else None
        hs = rglru(la, g, h0=h0)
        wants = [w for w in rglru_bwd(la, hs, dy, h0=h0) if w is not None]
        torch.cuda.synchronize()
        what = f"rglru_guards {(B, S, W)} h0={with_h0}"
        err = _rel_errs(wants + ([None] if h0 is None else []),
                        rglru_bwd_plain(la, hs, dy, h0=h0), what)
        n_chunks = -(-S // rglru_chunk_len)
        ws = torch.zeros(2 * B * n_chunks * W, device=DEV)
        for offset in GUARD_OFFSETS:
            g_in = [_guarded(x, offset) for x in (la, hs, dy) +
                    ((h0,) if h0 is not None else ())]
            g_out = [_guarded(w, offset) for w in wants]
            g_ws = _guarded(ws, offset)
            ptrs_in = [x[0] for x in g_in] + ([None] if h0 is None else [])
            ptrs_out = [x[0] for x in g_out] + ([None] if h0 is None else [])

            def call():
                rc = fn(*(None if t is None else t.data_ptr()
                          for t in ptrs_in + ptrs_out + [g_ws[0]]),
                        n_chunks, B, S, W,
                        torch.cuda.current_stream().cuda_stream)
                check(rc == 0, f"repro_rglru_bwd returned {rc}")
            _guarded_runs(call, g_in + [g_ws], g_out, wants,
                          f"{what} offset {offset} B", repeats)
            del g_in, g_out, g_ws
        out.append({"shape": [B, S, W], "h0": with_h0, "err_vs_plain": err,
                    "offsets_bytes": list(GUARD_OFFSETS),
                    "repeats": repeats})
    return out


def memory_guards(shapes=GUARD_SHAPES, repeats=GUARD_REPEATS):
    """The bf16 warpgroup forward (served, and with statistics), dK/dV and
    dQ (at the training head dims), called through their C entry points on
    tensors that lie inside NaN guard bands, 1024-byte aligned and 16 bytes
    past that: no launch may write outside its outputs (every guard keeps
    its bits), a read past an input's end would carry NaN into the result,
    and every output, filled with NaN before each launch, must come out bit
    for bit as the launch on ordinary tensors gave it, ``repeats`` times in
    a row (a race would show as a difference).  Those outputs are held to
    the plain versions first.  The D = 256 dK/dV's head-slice partials lie
    in a guard band too.  Then the same for the RG-LRU backward
    (``rglru_guards``)."""
    lib = build.load()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    out = []
    for B, S, H, K, D, window in shapes:
        kw = dict(causal=True, window=window)
        q, k, v, do = _bwd_inputs(gen, B, S, S, H, K, D, torch.bfloat16)
        served = flash_attention(q, k, v, **kw)
        o, m, l = flash_attention_fwd_stats(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"memory_guards {(B, S, H, K, D, window)}"
        o2, m2, l2 = attention_fwd_stats_plain(q, k, v, **kw)
        pairs = [(served, o2), (o, o2), (m, m2), (l, l2)]
        # entry point, inputs, outputs, scratch (after the outputs; None: a
        # null pointer)
        launches = {
            "fwd": ("repro_flash_attention_fwd", (q, k, v), (served,), ()),
            "fwd_stats": ("repro_flash_attention_fwd_stats", (q, k, v),
                          (o, m, l), ())}
        if D in BWD_HEAD_DIMS:
            delta = attention_delta(o, do)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, delta, **kw)
            dq = flash_attention_bwd_dq(q, k, v, do, m, l, delta, **kw)
            torch.cuda.synchronize()
            pairs += zip((dq, dk, dv), attention_bwd_plain(
                q, k, v, do, m, l, delta, **kw))
            stats = (m, l, delta)
            nsl = dkv_slices(B, S, H, K, D, torch.bfloat16)
            ws = torch.zeros(2 * nsl * k.numel(), device=DEV) \
                if nsl > 1 else None
            launches["bwd_dkv"] = ("repro_flash_attention_bwd_dkv",
                                   (q, k, v, do) + stats, (dk, dv), (ws,))
            launches["bwd_dq"] = ("repro_flash_attention_bwd_dq",
                                  (q, k, v, do) + stats, (dq,), ())
        err = max(_err(a, b, 2e-2, what) for a, b in pairs)
        del o2, m2, l2, pairs
        for name, (entry, ins, wants, scratch) in launches.items():
            for offset in GUARD_OFFSETS:
                g_in = [_guarded(x, offset) for x in ins]
                g_out = [_guarded(w, offset) for w in wants]
                g_ws = [None if x is None else _guarded(x, offset)
                        for x in scratch]
                call = _entry(lib, entry, [g[0] for g in g_in + g_out] +
                              [None if g is None else g[0] for g in g_ws],
                              True, window)
                _guarded_runs(call, g_in + [g for g in g_ws if g], g_out,
                              wants, f"{what} {name} offset {offset} B",
                              repeats)
                del g_in, g_out, g_ws, call
        out.append({"shape": [B, S, S, H, K, D], "window": window,
                    "max_abs_err": err, "launches": sorted(launches),
                    "scratch": {n: [None if x is None else x.numel()
                                    for x in s[3]]
                                for n, s in launches.items() if s[3]},
                    "offsets_bytes": list(GUARD_OFFSETS),
                    "repeats": repeats})
        del q, k, v, do, served, o, m, l, launches
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the recurrent kernels (SSD, RG-LRU) and the flash kernel at D = 256
# ---------------------------------------------------------------------------
SSD_CASES = [
    # B, S, H, P, G, N, chunk -- tests/test_kernels.py
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 8, 32, 2, 16, 16),
    (1, 256, 2, 64, 1, 64, 64),
    (3, 96, 4, 16, 4, 16, 32),      # ragged for the kernel's 64 steps
    (3, 100, 4, 16, 4, 16, 32),     # ragged for every chunk length
]
# the chunk-parallel design (64-step chunks), mostly at mamba2's P = 64,
# N = 128, where bf16 runs on the tensor cores: B, S, H, P, G, N, served
# distributions (small dt: the state carries across chunks)
SSD_CHUNK_CASES = [
    (1, 100, 4, 64, 1, 128, False),     # S not a multiple of the chunk
    (1, 40, 4, 64, 1, 128, False),      # S shorter than one chunk
    (2, 200, 6, 64, 3, 128, False),     # G = 3, 4 chunks
    (2, 300, 8, 64, 2, 128, True),      # B = 2, 5 chunks, slow decay
    (1, 100, 4, 8, 1, 4, False),        # bf16 on the CUDA cores too
]
# y and h_final of the SSD kernel against its plain version: fp32 math on
# both sides (bf16 inputs widen exactly), so the summation order and the
# kernel's own chunk length differ -- and, for bf16 x/B/C on the tensor
# cores, the fp32 operands' split into two bf16 halves (about 2^-17 of each)
SSD_TOL = {"max_err_over_max_abs": 2e-4, "rel_fro": 2e-4,
           "row_rel_max": 2e-4}
RGLRU_CASES = [(2, 128, 64), (1, 64, 256), (3, 96, 32), (1, 128, 8),
               # the chunked scan (64-step chunks): a ragged last chunk, S
               # shorter than a chunk, one step, B > 1 over many chunks at
               # the served width
               (2, 1000, 300), (1, 40, 130), (1, 1, 64), (3, 777, 2560)]
ATTN_D256_CASES = [
    # B, S, T, H, K, D, causal, window, dtype: recurrentgemma's MQA heads
    (1, 300, 300, 10, 1, 256, True, 64, torch.float32),
    (1, 300, 300, 10, 1, 256, True, 64, torch.bfloat16),
    (2, 130, 130, 10, 1, 256, True, 0, torch.bfloat16),
    (1, 200, 200, 4, 2, 256, True, 50, torch.float32),
    # the warpgroup design (bf16, 64-key tiles on four 64-column panels):
    # several 128-row blocks under a window, S != T with G = 2 (every row
    # sees a key), MQA bidirectional with a ragged T
    (1, 1000, 1000, 10, 1, 256, True, 200, torch.bfloat16),
    (1, 300, 520, 4, 2, 256, True, 100, torch.bfloat16),
    (2, 200, 333, 10, 1, 256, False, 0, torch.bfloat16),
]
SSD_SERVED = (1, 2048, 48, 64, 1, 128)      # mamba2-780m, one 2048 prefill
RGLRU_SERVED = (1, 4096, 2560)              # recurrentgemma-2b, 4096 prefill
ATTN_SERVED = (1, 4096, 4096, 10, 1, 256, True, 2048, torch.bfloat16)


def _ssd_inputs(gen, B, S, H, P, G, N, dt_, served=False):
    """The reference tests' distributions; at the served shape dt and A
    follow the model's init ranges instead (small dt, A in [-16, -1]), so
    the state carries across many sub-chunks."""
    x = _randn(gen, B, S, H, P, dtype=dt_)
    if served:
        dt = torch.nn.functional.softplus(_randn(gen, B, S, H,
                                                 dtype=torch.float32) - 3.0)
        A = -(1.0 + 15.0 * torch.rand(H, generator=gen, device=DEV))
    else:
        dt = torch.nn.functional.softplus(_randn(gen, B, S, H,
                                                 dtype=torch.float32))
        A = -torch.exp(_randn(gen, H, dtype=torch.float32))
    Bm = (_randn(gen, B, S, G, N, dtype=torch.float32) * 0.5).to(dt_)
    Cm = (_randn(gen, B, S, G, N, dtype=torch.float32) * 0.5).to(dt_)
    return x, dt, A, Bm, Cm


def _ssd_faulty(x, dt, A, Bm, Cm, at, fault, L=64):
    """The plain SSD over sub-chunks of ``L`` steps, the state carried from
    one to the next through ``h0`` -- except at sub-chunk ``at``: with
    ``fault="dropped"`` it leaves the state as it found it (a kernel that
    skips one state update), with ``fault="undecayed"`` it passes on the
    state it found plus its own local state, without the sub-chunk's decay
    (a state passing that drops one exp(acum_end) factor)."""
    B, S, H, P = x.shape
    N = Bm.shape[3]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for j, s0 in enumerate(range(0, S, L)):
        part = (x[:, s0:s0 + L], dt[:, s0:s0 + L], A, Bm[:, s0:s0 + L],
                Cm[:, s0:s0 + L])
        y, h_new = ssd_plain(*part, chunk=L, h0=h)
        ys.append(y)
        if j == at and fault == "dropped":
            h_new = h
        elif j == at and fault == "undecayed":
            h_new = h + ssd_plain(*part, chunk=L)[1]
        h = h_new
    return torch.cat(ys, dim=1), h


def _ssd_hi_only(x, dt, A, Bm, Cm, L=64):
    """The SSD over chunks of ``L`` steps with the tensor-core design's
    fp32 operands -- the weights W of W x, the scaled B of each chunk's
    state, the state entering a chunk -- rounded to bf16 before their
    products, all else fp32: the kernel with the lo halves of its split
    dropped.  A control: the SSD comparison must reject it, or it cannot
    tell the split from plain bf16."""
    def hi(t):
        return t.to(torch.bfloat16).float()
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, L):
        sl = slice(s0, s0 + L)
        xc, dtc = x[:, sl], dt[:, sl]
        Bc, Cc = (t[:, sl].repeat_interleave(H // G, dim=2) for t in (Bm, Cm))
        n = xc.shape[1]
        acum = torch.cumsum(dtc * A, dim=1)                 # (B,n,H)
        decay = torch.exp(torch.clamp(
            acum[:, :, None] - acum[:, None], -60.0, 0.0))  # (B,n,n,H)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        W = torch.where(causal[None, :, :, None], torch.einsum(
            "blhn,bmhn->blmh", Cc, Bc) * decay * dtc[:, None], 0.0)
        ys.append(torch.einsum("blmh,bmhp->blhp", hi(W), xc)
                  + torch.exp(acum)[..., None]
                  * torch.einsum("blhn,bhnp->blhp", Cc, hi(h)))
        rest = torch.exp(torch.clamp(acum[:, -1:] - acum, min=-60.0))
        h = torch.exp(acum[:, -1])[..., None, None] * h + torch.einsum(
            "bmhn,bmhp->bhnp", hi(Bc * (dtc * rest)[..., None]), xc)
    return torch.cat(ys, dim=1), h


def _ssd_check(got, want, what):
    return {"y": _scaled_err(got[0], want[0], f"{what} y", SSD_TOL),
            "h_final": _scaled_err(got[1], want[1], f"{what} h_final",
                                   SSD_TOL)}


def ssd_cases(gen):
    rows = []
    for (B, S, H, P, G, N, chunk) in SSD_CASES:
        for dt_ in (torch.float32, torch.bfloat16):
            ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_)
            got = ssd(*ins)
            torch.cuda.synchronize()
            want = ssd_plain(*ins, chunk=chunk)
            rows.append({"shape": [B, S, H, P, G, N], "chunk": chunk,
                         "dtype": str(dt_), "scaled": _ssd_check(
                             got, want, f"ssd {(B, S, H, P, G, N)} {dt_}")})
    for (B, S, H, P, G, N, served) in SSD_CHUNK_CASES:
        for dt_ in (torch.float32, torch.bfloat16):
            ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_, served=served)
            got = ssd(*ins)
            torch.cuda.synchronize()
            rows.append({"shape": [B, S, H, P, G, N], "chunk": CHUNK,
                         "dtype": str(dt_), "served_dt": served,
                         "design": ssd_design(P, N, dt_),
                         "scaled": _ssd_check(
                             got, ssd_plain(*ins),
                             f"ssd {(B, S, H, P, G, N)} {dt_}")})
    # a given initial state (the first case; bf16 x/B/C on the tensor cores)
    B, S, H, P, G, N, chunk = SSD_CASES[0]
    for dt_ in (torch.float32, torch.bfloat16):
        ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_)
        h0 = _randn(gen, B, H, N, P, dtype=torch.float32)
        got = ssd(*ins, h0=h0)
        torch.cuda.synchronize()
        rows.append({"shape": [B, S, H, P, G, N], "chunk": chunk, "h0": True,
                     "dtype": str(dt_), "scaled": _ssd_check(
                         got, ssd_plain(*ins, chunk=chunk, h0=h0),
                         f"ssd with h0 {dt_}")})
    # the sequential recurrence: one decode step at a time on the card
    B, S, H, P, G, N, _ = 1, 16, 2, 8, 1, 4, 8
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N, torch.float32)
    y, h = ssd(x, dt, A, Bm, Cm)
    hs = torch.zeros((B, H, N, P), device=DEV)
    ys = []
    for t in range(S):
        yt, hs = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                 hs)
        ys.append(yt)
    rows.append({"shape": [B, S, H, P, G, N], "dtype": "torch.float32",
                 "against": "ssd_decode_step, step by step",
                 "scaled": _ssd_check((y, h), (torch.stack(ys, 1), hs),
                                      "ssd vs the sequential recurrence")})
    return rows


def _ssd_least_flops(B, S, H, P, G, N):
    """(chunk, fp32 operations) of the chunked SSD at the chunk length that
    needs the least.  At chunk c: per head, the causal intra-chunk product
    S(c+1)P, the chunk states and their read-out 4SNP, and the state carried
    across chunks 2NP per chunk; per group the causal C B^T, S(c+1)N.
    c = 1 is the plain recurrence."""
    def flops(c):
        return B * (S * (H * ((c + 1) * P + 4 * N * P) + G * (c + 1) * N)
                    + H * -(-S // c) * 2 * N * P)
    return min(((c, flops(c)) for c in range(1, S + 1)), key=lambda t: t[1])


def ssd_main_shape(gen):
    """The served prefill: x, B, C bf16 (the compute dtype), dt and A fp32.
    Faults planted in the plain result at mid-sequence -- a dropped state
    update and a state passed on without its chunk's decay, at the
    kernel's chunk length -- must fail the comparison, and so must the
    control with the split fp32 operands in bf16 alone (``_ssd_hi_only``);
    two calls must give bit-identical outputs."""
    B, S, H, P, G, N = SSD_SERVED
    dt_ = torch.bfloat16
    ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_, served=True)
    got = ssd(*ins)
    again = ssd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "ssd: two calls on the same inputs differ")
    want = ssd_plain(*ins, chunk=256)
    scaled = _ssd_check(got, want, "ssd served shape")
    L = kernel_chunk()
    faults = {}
    for fault in ("dropped", "undecayed", "bf16_hi_only"):
        bad = _ssd_hi_only(*ins, L=L) if fault == "bf16_hi_only" else \
            _ssd_faulty(*ins, at=S // L // 2, fault=fault, L=L)
        faults[fault] = {"y": _scaled(bad[0], want[0]),
                         "h_final": _scaled(bad[1], want[1])}
        check(not all(_passes(v, SSD_TOL) for v in faults[fault].values()),
              f"planted fault ({fault}, {L}-step chunks) passes the SSD "
              f"comparison {faults[fault]}: it cannot see it")
    ms = time_ms([lambda: ssd(*ins)], 10)
    plain_ms = time_ms([lambda: ssd_plain(*ins, chunk=256)], 2)
    # device time of each of the call's three kernels, over 10 calls
    staged = _profile(lambda: [ssd(*ins) for _ in range(10)],
                      "ssd served shape")
    stage_ms = {re.search(r"ssd_\w+", name).group(0): t / 10
                for name, t in staged["top_kernels_ms"] if "ssd_" in name}
    # bytes: each input read once, y and h_final written once
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + (B * S * H * P + B * H * N * P) * 4
    chunk, flops = _ssd_least_flops(B, S, H, P, G, N)
    # the bound of the design that runs: on the tensor cores at the bf16
    # rate, the products with an fp32 operand counted twice (hi and lo
    # halves, so at most 2 x flops); the fp32 CUDA-core bound beside it
    on_tc = ssd_design(P, N, dt_) == "mma.sync"
    bound = _bound(nbytes, 2 * flops if on_tc else flops,
                   torch.bfloat16 if on_tc else torch.float32)
    fp32 = _bound(nbytes, flops, torch.float32)
    return dict({"shape": [B, S, H, P, G, N], "dtype": "x/B/C bf16, dt/A "
                 "fp32", "tol": SSD_TOL["max_err_over_max_abs"],
                 "design": f"chunk-parallel, {ssd_design(P, N, dt_)}",
                 "kernel_chunk": L, "bound_chunk": chunk,
                 "max_abs_err": float((got[0] - want[0]).abs().max()),
                 "scaled": scaled, "bit_identical_calls": True,
                 "planted_faults_rejected": faults,
                 "ms": ms,
                 "plain_ms": plain_ms, "library_ms": None,
                 "stage_ms_profiled": stage_ms,
                 "bound_ms_fp32_cuda_cores": fp32["bound_ms"],
                 "bound_by_fp32_cuda_cores": fp32["bound_by"]},
                **bound)


def rglru_cases(gen):
    rows = []
    for (B, S, W) in RGLRU_CASES:
        la = -torch.nn.functional.softplus(_randn(gen, B, S, W,
                                                  dtype=torch.float32))
        g = _randn(gen, B, S, W, dtype=torch.float32)
        h0 = _randn(gen, B, W, dtype=torch.float32)
        for with_h0 in (False, True):
            kw = dict(h0=h0) if with_h0 else {}
            got = rglru(la, g, **kw)
            torch.cuda.synchronize()
            err = _err(got, rglru_plain(la, g, **kw), 2e-5,
                       f"rglru {(B, S, W)} h0={with_h0}")
            rows.append({"shape": [B, S, W], "h0": with_h0, "tol": 2e-5,
                         "max_abs_err": err})
    return rows


def rglru_main_shape(gen):
    """The served prefill; two input sets in turn keep a launch's 84 MB of
    inputs out of L2."""
    B, S, W = RGLRU_SERVED
    copies = [(-torch.nn.functional.softplus(
        _randn(gen, B, S, W, dtype=torch.float32)),
        _randn(gen, B, S, W, dtype=torch.float32)) for _ in range(2)]
    la, g = copies[0]
    got = rglru(la, g)
    torch.cuda.synchronize()
    err = _err(got, rglru_plain(la, g), 2e-5, "rglru served shape")
    ms = time_ms([lambda a=a, b=b: rglru(a, b) for a, b in copies], 10)
    plain_ms = time_ms([lambda: rglru_plain(la, g)], 2)
    return dict({"shape": [B, S, W], "dtype": "torch.float32", "tol": 2e-5,
                 "design": f"chunked scan, {rglru_chunk_len}-step chunks",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": None},
                **_bound(3 * B * S * W * 4, 3 * B * S * W, torch.float32))


# the RG-LRU backward (rglru_bwd: the adjoint as the chunked scan run from
# the end): ragged S across the 64-step chunks, S shorter than a chunk, one
# step, B > 1 at the served width
RGLRU_BWD_CASES = [(2, 1, 64), (1, 63, 130), (1, 64, 130), (1, 65, 130),
                   (2, 300, 300), (3, 777, 2560)]
RGLRU_TRAINED = (2, 4096, 2560)             # recurrentgemma-2b, TRAIN_SHAPE
# d log_a, d gated (and d h0) against the plain reverse scan and autograd of
# rglru_plain: within 1e-5 of each gradient's max-abs (fp32, other orders of
# summation)
RGLRU_BWD_TOL = 1e-5


def _rglru_inputs(gen, B, S, W):
    la = -torch.nn.functional.softplus(_randn(gen, B, S, W,
                                              dtype=torch.float32))
    return (la, _randn(gen, B, S, W, dtype=torch.float32),
            _randn(gen, B, W, dtype=torch.float32),
            _randn(gen, B, S, W, dtype=torch.float32))


def _rel_errs(got, want, what, tol=RGLRU_BWD_TOL):
    """Each gradient's max error over its max-abs; fails above ``tol``."""
    errs = []
    for n, a, b in zip(("d log_a", "d gated", "d h0"), got, want):
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{what} {n}: non-finite")
        e = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        check(e <= tol, f"{what} {n}: error {e} of max-abs > {tol}")
        errs.append(e)
    return errs


def _rglru_carry_fault(la, hs, dy, h0=None, t1=2 * rglru_chunk_len):
    """The plain backward with the adjoint carried into chunk 1 from its
    right (the adjoint at step ``t1``, the first of chunk 2) zeroed: steps
    before ``t1`` and after it as two separate sequences."""
    head = rglru_bwd_plain(la[:, :t1], hs[:, :t1], dy[:, :t1], h0=h0)
    tail = rglru_bwd_plain(la[:, t1:], hs[:, t1:], dy[:, t1:],
                           h0=hs[:, t1 - 1])
    return torch.cat([head[0], tail[0]], 1), torch.cat([head[1], tail[1]], 1)


def rglru_bwd_cases(gen):
    """rglru_bwd against its plain reverse scan and against autograd of
    rglru_plain, with and without h0; then the trained shape, timed, with a
    planted fault (the carry into chunk 1 zeroed) that must fail the same
    comparison.  Each forward whose output the backward reads (the rglru
    kernel's, at every shape here, the trained one included) is held to
    rglru_plain first."""
    rows = []
    for (B, S, W) in RGLRU_BWD_CASES:
        la, g, h0, dy = _rglru_inputs(gen, B, S, W)
        for with_h0 in (False, True):
            H0 = h0 if with_h0 else None
            hs = rglru(la, g, h0=H0)
            got = rglru_bwd(la, hs, dy, h0=H0)
            torch.cuda.synchronize()
            what = f"rglru_bwd {(B, S, W)} h0={with_h0}"
            # the saved forward is the kernel's: held to the plain scan too
            fwd_err = _err(hs, rglru_plain(la, g, h0=H0), 2e-5,
                           f"rglru {(B, S, W)} h0={with_h0} (saved forward)")
            leaves = [x.clone().requires_grad_()
                      for x in (la, g) + ((h0,) if with_h0 else ())]
            with torch.enable_grad():
                auto = torch.autograd.grad(
                    (rglru_plain(*leaves[:2], h0=leaves[2] if with_h0
                                 else None) * dy).sum(), leaves,
                    allow_unused=True, materialize_grads=True)
            rows.append({"shape": [B, S, W], "h0": with_h0,
                         "tol_rel": RGLRU_BWD_TOL, "fwd_tol": 2e-5,
                         "fwd_max_abs_err": fwd_err,
                         "err_vs_plain": _rel_errs(
                             got, rglru_bwd_plain(la, hs, dy, h0=H0), what),
                         "err_vs_autograd": _rel_errs(got, auto,
                                                      f"{what} autograd")})
    B, S, W = RGLRU_TRAINED
    # two input sets in turn keep a launch's inputs (3 x 84 MB) out of L2
    copies, gated = [], []
    for _ in range(2):
        la, g, _, dy = _rglru_inputs(gen, B, S, W)
        copies.append((la, rglru(la, g), dy))
        gated.append(g)
    la, hs, dy = copies[0]
    torch.cuda.synchronize()
    # the forward kernel at the trained shape (it runs there 36 times a
    # step), held to the plain scan at the forward cases' tolerance
    fwd_err = _err(hs, rglru_plain(la, gated[0]), 2e-5,
                   "rglru trained shape (saved forward)")
    del gated
    got = rglru_bwd(la, hs, dy)
    torch.cuda.synchronize()
    want = rglru_bwd_plain(la, hs, dy)
    errs = _rel_errs(got, want, "rglru_bwd trained shape")
    bad = _rglru_carry_fault(la, hs, dy)
    fault = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(bad, want)]
    check(max(fault) > RGLRU_BWD_TOL, f"planted fault (carry into chunk 1 "
                                      f"zeroed) passes the rglru_bwd "
                                      f"comparison: {fault}")
    ms = time_ms([lambda c=c: rglru_bwd(*c) for c in copies], 10)
    plain_ms = time_ms([lambda: rglru_bwd_plain(la, hs, dy)], 2)
    # log_a, hs and dy read once, d log_a and d gated written once; per
    # step and channel an exp and four multiply-adds
    main = dict({"shape": [B, S, W], "dtype": "torch.float32",
                 "tol_rel": RGLRU_BWD_TOL,
                 "design": f"chunked reverse scan, {rglru_chunk_len}-step "
                           f"chunks",
                 "max_abs_err": float(max((a - b).abs().max()
                                          for a, b in zip(got[:2],
                                                          want[:2]))),
                 "err_vs_plain": errs, "fwd_tol": 2e-5,
                 "fwd_max_abs_err": fwd_err,
                 "planted_fault_carry_into_chunk_1": fault, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": None},
                **_bound(5 * B * S * W * 4, 5 * B * S * W, torch.float32))
    return rows, main


# the SSD backward (ssd_bwd): ragged S, S shorter than one chunk, G = 2,
# h0 given, dh_final nonzero, at mamba2's P = 64, N = 128 and at the
# reference's test widths (bf16 on the tensor-core design there; at P = 64,
# N = 64 on the CUDA-core design): B, S, H, P, G, N, served distributions
# (small dt), h0, dh_final
SSD_BWD_CASES = [
    (1, 100, 4, 64, 1, 128, False, False, False),   # ragged S
    (1, 40, 4, 64, 1, 128, False, True, True),      # shorter than a chunk
    (2, 300, 8, 64, 2, 128, True, True, True),      # G = 2, 5 chunks
    (3, 100, 4, 16, 4, 16, False, True, False),     # the reference's widths
    (1, 256, 2, 64, 1, 64, True, False, False),     # whole chunks
]
SSD_TRAINED = (2, 4096, 48, 64, 1, 128)     # mamba2-780m, TRAIN_SHAPE
# the backward's outputs against ssd_bwd_plain (and autograd of ssd_plain):
# the fp32 ones (ddt, dA, dh0, and every output for fp32 inputs) at
# SSD_TOL -- fp32 math on both sides, other summation orders and chunk
# lengths; dx, dB and dC for bf16 inputs come out in bf16, whose rounding
# alone (8 significant bits) is up to 2^-8 of each element: twice that
SSD_BWD_TOL_BF16 = {"max_err_over_max_abs": 8e-3, "rel_fro": 8e-3,
                    "row_rel_max": 8e-3}
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _ssd_bwd_tol(name, dtype):
    return SSD_BWD_TOL_BF16 if dtype == torch.bfloat16 and \
        name in ("dx", "dB", "dC") else SSD_TOL


def _ssd_bwd_scaled(got, want, dtype):
    """The scaled measures of each output (None where both are None)."""
    return {n: None if w is None else _scaled(g, w)
            for n, g, w in zip(SSD_BWD_NAMES, got, want)}


def _ssd_bwd_check(got, want, dtype, what):
    out = {}
    for n, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            check(g is None, f"{what} {n}: an output where none is wanted")
            continue
        out[n] = _scaled_err(g, w, f"{what} {n}", _ssd_bwd_tol(n, dtype))
    return out


def _ssd_bwd_passes(got, want, dtype):
    return all(_passes(_scaled(g, w), _ssd_bwd_tol(n, dtype))
               for n, g, w in zip(SSD_BWD_NAMES, got, want) if w is not None)


def _ssd_bwd_hi_only(x, dt, A, Bm, Cm, dy, L=64):
    """The SSD backward over chunks of ``L`` steps with the tensor-core
    design's fp32 operands -- exp(acum) dy of C^T dy, dy, the chunk states
    h_c and their gradients G_c, the weights W and K -- rounded to bf16
    before their products, all else fp32 (``ssd_bwd_plain``'s arithmetic):
    the kernel with the lo halves of its split dropped.  A control: the
    ssd_bwd comparison must reject it, or it cannot tell the split from
    plain bf16."""
    def hi(t):
        return t.to(torch.bfloat16).float()
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    nc = -(-S // L)
    pad = nc * L - S
    f = torch.nn.functional.pad
    x, dt, A, Bm, Cm, dy = (t.float() for t in (x, dt, A, Bm, Cm, dy))
    xc = f(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, L, H, P)
    dyc = f(dy, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, L, H, P)
    dtc = f(dt, (0, 0, 0, pad)).reshape(Bsz, nc, L, H)
    Bh, Ch = (f(t, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, L, G, N)
              .repeat_interleave(hpg, dim=3) for t in (Bm, Cm))
    acum = torch.cumsum(dtc * A, dim=2)
    aend = acum[:, :, -1]
    rest = aend[:, :, None] - acum
    R = torch.exp(torch.clamp(rest, min=-60.0))
    dtR = dtc * R
    local = torch.einsum("bjmhn,bjmhp->bjhnp", Bh * dtR[..., None], xc)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    hin = []
    for j in range(nc):
        hin.append(h)
        h = torch.exp(aend[:, j])[..., None, None] * h + local[:, j]
    hin = torch.stack(hin, dim=1)
    u = torch.einsum("bjlhn,bjlhp->bjhnp", Ch,
                     hi(torch.exp(acum)[..., None] * dyc))
    g = torch.zeros_like(h)
    gout = [None] * nc
    for j in reversed(range(nc)):
        gout[j] = g
        g = torch.exp(aend[:, j])[..., None, None] * g + u[:, j]
    gout = torch.stack(gout, dim=1)
    at = acum.permute(0, 1, 3, 2)
    diff = at[..., :, None] - at[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    D = torch.where(causal, torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0)
    live = causal & (diff >= -60.0) & (diff <= 0.0)
    dt_m = dtc.permute(0, 1, 3, 2)[..., None, :]
    CB = torch.einsum("bjlhn,bjmhn->bjhlm", Ch, Bh)
    Q = torch.einsum("bjlhp,bjmhp->bjhlm", hi(dyc), xc)
    W, K, V = CB * D * dt_m, Q * D * dt_m, CB * D * Q
    E = torch.where(live, V * dt_m, 0.0)
    G_, H_, DY = hi(gout), hi(hin), hi(dyc)
    XG = torch.einsum("bjmhp,bjhnp->bjmhn", xc, G_)
    DH = torch.einsum("bjlhp,bjhnp->bjlhn", DY, H_)
    dx = torch.einsum("bjhlm,bjlhp->bjmhp", hi(W), DY) + dtR[..., None] * \
        torch.einsum("bjmhn,bjhnp->bjmhp", Bh, G_)
    dBh = torch.einsum("bjhlm,bjlhn->bjmhn", hi(K), Ch) + dtR[..., None] * XG
    dCh = torch.einsum("bjhlm,bjmhn->bjlhn", hi(K), Bh) + \
        torch.exp(acum)[..., None] * DH
    z = R * (Bh * XG).sum(-1)
    s = torch.where(rest >= -60.0, dtc * z, 0.0)
    gacum = (E.sum(-1) - E.sum(-2)).permute(0, 1, 3, 2) + \
        torch.exp(acum) * (Ch * DH).sum(-1) - s
    last = torch.exp(aend) * (gout * hin).sum((-2, -1)) + s.sum(2)
    gacum = torch.cat([gacum[:, :, :-1], gacum[:, :, -1:] + last[:, :, None]],
                      dim=2)
    ga = torch.flip(torch.cumsum(torch.flip(gacum, [2]), 2), [2])
    ddt = A * ga + V.sum(-2).permute(0, 1, 3, 2) + z
    dA = (dtc * ga).sum((0, 1, 2))
    dB = dBh.reshape(Bsz, nc, L, G, hpg, N).sum(4)
    dC = dCh.reshape(Bsz, nc, L, G, hpg, N).sum(4)
    return (dx.reshape(Bsz, nc * L, H, P)[:, :S],
            ddt.reshape(Bsz, nc * L, H)[:, :S], dA,
            dB.reshape(Bsz, nc * L, G, N)[:, :S],
            dC.reshape(Bsz, nc * L, G, N)[:, :S], None)


def _ssd_bwd_fn(entry, lib=None):
    """The backward's C entry point ``entry`` of the kernels' library (or
    of ``lib``), with its argument types."""
    fn = getattr(lib or build.load(), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    return fn


def _ssd_bwd_entry(entry, ins, dy, states, aend, dh=None, h0=None,
                   nsl=None, lib=None):
    """A closure that launches the backward's C entry point ``entry``
    (``repro_ssd_bwd``) on these inputs, into outputs and scratch of its
    own (``nsl`` dB / dC partials a group; by default one per head;
    ``lib``: another build of the kernels' library); returns (call,
    outputs, scratch), outputs (dx, ddt, dA, dB, dC, dh0 or None).  It
    holds the tensors."""
    fn = _ssd_bwd_fn(entry, lib)
    x, dt, A, Bm, Cm = ins
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = states.shape[1]
    nsl = H // G if nsl is None else nsl
    f32 = dict(dtype=torch.float32, device=DEV)
    outs = [torch.empty_like(x), torch.empty((B, S, H), **f32),
            torch.empty((H,), **f32), torch.empty_like(Bm),
            torch.empty_like(Cm),
            None if h0 is None else torch.empty((B, H, N, P), **f32)]
    scratch = [torch.empty((B, nc, H, N, P), **f32),
               torch.empty((B, S, G * nsl, N), **f32),
               torch.empty((B, S, G * nsl, N), **f32),
               torch.empty((B, nc, H), **f32)]
    tensors = [x, dt, A, Bm, Cm, dy, dh, states, aend, *outs, *scratch]

    def call():
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors),
                nc, B, S, H, P, G, N, 1,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{entry} returned {rc}")
    return call, outs, scratch


def _ssd_bwd_faults(ins, dy, want, dtype, L):
    """Three faults planted in the plain backward's result, each of which
    the comparison must reject: (a) the carry of the reverse state pass
    into the chunk before mid-sequence zeroed (the steps before and after
    it as two sequences, the second from the forward's state there); (b)
    one chunk's dB partial of head 0 dropped from the group sum; (c) dA
    summed over batch row 0 only; and a control, the backward with its
    split fp32 operands in bf16 alone (``_ssd_bwd_hi_only``)."""
    x, dt, A, Bm, Cm = ins
    S = x.shape[1]
    t1 = (S // L // 2) * L
    head = ssd_bwd_plain(*(t[:, :t1] for t in (x, dt)), A,
                         *(t[:, :t1] for t in (Bm, Cm)), dy[:, :t1])
    h_t1 = ssd_plain(*(t[:, :t1] for t in (x, dt)), A,
                     *(t[:, :t1] for t in (Bm, Cm)))[1]
    tail = ssd_bwd_plain(*(t[:, t1:] for t in (x, dt)), A,
                         *(t[:, t1:] for t in (Bm, Cm)), dy[:, t1:],
                         h0=h_t1)
    carry = [torch.cat([a, b], 1) for a, b in zip(head[:2], tail[:2])] + \
        [head[2] + tail[2]] + \
        [torch.cat([a, b], 1) for a, b in zip(head[3:5], tail[3:5])] + [None]
    # head 0's share of dB over the chunk at t1 (a one-head call: its dB is
    # that head's partial), subtracted from the group sum
    one = ssd_bwd_plain(x[:, :, :1], dt[:, :, :1], A[:1], Bm[:, :, :1],
                        Cm[:, :, :1], dy[:, :, :1])[3]
    dropped = list(want)
    dB = want[3].clone()
    dB[:, t1:t1 + L, 0] -= one[:, t1:t1 + L, 0]
    dropped[3] = dB
    one_row = list(want)
    one_row[2] = ssd_bwd_plain(x[:1], dt[:1], A, Bm[:1], Cm[:1], dy[:1])[2]
    faults = {}
    del head, tail, one
    hi_only = _ssd_bwd_hi_only(*ins, dy, L=L)
    for name, bad in (("zeroed_carry", carry), ("dB_partial_dropped",
                                                 dropped),
                      ("dA_one_batch_row", one_row),
                      ("bf16_hi_only", hi_only)):
        faults[name] = {n: s for n, s in _ssd_bwd_scaled(
            bad, want, dtype).items() if s is not None}
        check(not _ssd_bwd_passes(bad, want, dtype),
              f"planted fault ({name}) passes the ssd_bwd comparison "
              f"{faults[name]}: it cannot see it")
    return faults


def _ssd_bwd_least_flops(B, S, H, P, G, N):
    """(chunk, fp32 operations) of the chunked backward at the chunk length
    that needs the least.  At chunk c, per head: the causal dy x^T and W^T
    dy, S(c+1)P each; the causal K^T C and K B, S(c+1)N each; the four
    products with a chunk state (C^T dy, B G, x G^T, dy h^T), 2SNP each;
    the reverse state pass, 2NP per chunk.  Per group the causal C B^T,
    S(c+1)N."""
    def flops(c):
        return B * (S * (H * (2 * (c + 1) * (P + N) + 8 * N * P)
                         + G * (c + 1) * N) + H * -(-S // c) * 2 * N * P)
    return min(((c, flops(c)) for c in range(1, S + 1)), key=lambda t: t[1])


def ssd_bwd_cases(gen):
    """ssd_bwd against ssd_bwd_plain at SSD_BWD_CASES, fp32 and bf16, and
    in fp32 against autograd of ssd_plain, each saved forward (the ssd
    kernel's states) held to ssd_plain first; then the trained shape: the
    forward against ssd_plain, the backward against ssd_bwd_plain, two
    calls bit-identical, planted faults and the hi-only control
    rejected."""
    t0 = time.perf_counter()
    rows = []
    for (B, S, H, P, G, N, served, with_h0, with_dh) in SSD_BWD_CASES:
        for dt_ in (torch.float32, torch.bfloat16):
            ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_, served=served)
            dy = _randn(gen, B, S, H, P, dtype=torch.float32)
            h0 = _randn(gen, B, H, N, P, dtype=torch.float32) \
                if with_h0 else None
            dh = _randn(gen, B, H, N, P, dtype=torch.float32) \
                if with_dh else None
            what = f"ssd_bwd {(B, S, H, P, G, N)} {dt_} h0={with_h0} " \
                   f"dh_final={with_dh}"
            y, h, states, aend = ssd(*ins, h0=h0, keep_states=True)
            got = ssd_bwd(*ins, dy, states=states, aend=aend, dh_final=dh,
                          h0=h0)
            torch.cuda.synchronize()
            fwd = _ssd_check((y, h), ssd_plain(*ins, h0=h0),
                             f"{what} (saved forward)")
            plain = ssd_bwd_plain(*ins, dy, dh_final=dh, h0=h0)
            row = {"shape": [B, S, H, P, G, N], "dtype": str(dt_),
                   "design": ssd_bwd_design(P, N, dt_),
                   "served_dt": served, "h0": with_h0, "dh_final": with_dh,
                   "saved_forward": fwd,
                   "vs_plain": _ssd_bwd_check(got, plain, dt_, what)}
            if dt_ == torch.float32:
                # autograd runs in fp32 on both dtypes' inputs: once a
                # case, where the kernel's outputs are fp32 too
                leaves = [t.clone().requires_grad_()
                          for t in ins + ((h0,) if with_h0 else ())]
                with torch.enable_grad():
                    yo, ho = ssd_plain(*leaves[:5],
                                       h0=leaves[5] if with_h0 else None)
                    loss = (yo * dy).sum() + \
                        ((ho * dh).sum() if with_dh else 0)
                    auto = list(torch.autograd.grad(loss, leaves))
                auto += [None] * (6 - len(auto))
                row["vs_autograd"] = _ssd_bwd_check(got, auto, dt_,
                                                    f"{what} autograd")
            rows.append(row)
    # the trained shape
    t_cases = time.perf_counter()
    B, S, H, P, G, N = SSD_TRAINED
    dt_ = torch.bfloat16
    ins = _ssd_inputs(gen, B, S, H, P, G, N, dt_, served=True)
    dy = _randn(gen, B, S, H, P, dtype=torch.float32)
    y, h, states, aend = ssd(*ins, keep_states=True)
    torch.cuda.synchronize()
    # the forward at the shape the training path gives it (96 launches a
    # step), held to the plain version as the served shape is
    fwd_want = ssd_plain(*ins)
    fwd = _ssd_check((y, h), fwd_want, "ssd trained shape")
    fwd_err = float((y - fwd_want[0]).abs().max())
    del fwd_want
    got = ssd_bwd(*ins, dy, states=states, aend=aend)
    again = ssd_bwd(*ins, dy, states=states, aend=aend)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])),
          "ssd_bwd: two calls on the same inputs differ")
    del again
    want = ssd_bwd_plain(*ins, dy)
    scaled = _ssd_bwd_check(got, want, dt_, "ssd_bwd trained shape")
    worst = max(v / _ssd_bwd_tol(n, dt_)[k] for n, s in scaled.items()
                for k, v in s.items())
    L = kernel_chunk()
    faults = _ssd_bwd_faults(ins, dy, want, dt_, L)
    max_err = float(max((g.float() - w).abs().max()
                        for g, w in zip(got[:5], want[:5])))
    fwd_ms = time_ms([lambda: ssd(*ins)], 10)
    fwd_plain_ms = time_ms([lambda: ssd_plain(*ins)], 2)
    ms = time_ms([lambda: ssd_bwd(*ins, dy, states=states, aend=aend)], 10)
    plain_ms = time_ms([lambda: ssd_bwd_plain(*ins, dy)], 2)
    staged = _profile(lambda: [ssd_bwd(*ins, dy, states=states, aend=aend)
                               for _ in range(10)], "ssd_bwd trained shape")
    stage_ms = {re.search(r"ssd_bwd_\w+", name).group(0): t / 10
                for name, t in staged["top_kernels_ms"] if "ssd_bwd_" in name}
    in_bytes = sum(t.numel() * t.element_size() for t in ins)
    # bf16 x/B/C, fp32 dt/A: as the forward's, on the tensor cores
    chunk_f, flops_f = _ssd_least_flops(B, S, H, P, G, N)
    fwd_row = dict({"shape": [B, S, H, P, G, N], "dtype": "x/B/C bf16, "
                    "dt/A fp32", "tol": SSD_TOL["max_err_over_max_abs"],
                    "design": f"chunk-parallel, {ssd_design(P, N, dt_)}",
                    "max_abs_err": fwd_err, "scaled": fwd,
                    "ms": fwd_ms, "plain_ms": fwd_plain_ms,
                    "library_ms": None, "bound_chunk": chunk_f},
                   **_bound(in_bytes + (y.numel() + h.numel()) * 4,
                            2 * flops_f, torch.bfloat16))
    # bytes: x, dt, A, B, C, dy read once; dx, ddt, dA, dB, dC written
    # once.  The saved chunk states and aend could be recomputed, so the
    # bound leaves them out; with them it is reported beside.  Operations
    # on the tensor cores, as the forward's: bf16 x/B/C, the fp32 operands
    # (dy, the chunk states, the weights) split into bf16 hi + lo, which
    # doubles the products
    out_bytes = sum(t.numel() * t.element_size() for t in got[:5])
    saved = (states.numel() + aend.numel()) * 4
    nbytes = in_bytes + dy.numel() * 4 + out_bytes
    chunk_b, flops_b = _ssd_bwd_least_flops(B, S, H, P, G, N)
    bwd_row = dict({"shape": [B, S, H, P, G, N], "dtype": "x/B/C bf16, "
                    "dt/A/dy fp32", "tol": SSD_TOL, "tol_bf16_outputs":
                    SSD_BWD_TOL_BF16, "worst_ratio_to_tol": worst,
                    "design": f"five launches, "
                              f"{ssd_bwd_design(P, N, dt_)}",
                    "heads_per_block": H // G // ssd_bwd_slices(
                        H // G, P, N, dt_),
                    "kernel_chunk": L, "bound_chunk": chunk_b,
                    "max_abs_err": max_err, "scaled": scaled,
                    "bit_identical_calls": True,
                    "planted_faults_rejected": faults, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": None,
                    "stage_ms_profiled": stage_ms,
                    "bound_ms_with_saved_states": _bound(
                        nbytes + saved, 2 * flops_b,
                        torch.bfloat16)["bound_ms"],
                    "bound_ms_fp32_cuda_cores": _bound(
                        nbytes, flops_b, torch.float32)["bound_ms"],
                    "phase_s": {"cases": t_cases - t0,
                                "trained_shape": time.perf_counter()
                                - t_cases}},
                   **_bound(nbytes, 2 * flops_b, torch.bfloat16))
    return rows, fwd_row, bwd_row


# B, S, H, P, G, N, h0 and dh_final of the guarded SSD backward: the
# trained shape, and a ragged one with both
SSD_BWD_GUARD_SHAPES = [(2, 4096, 48, 64, 1, 128, False),
                        (3, 100, 4, 64, 2, 128, True)]


def ssd_bwd_guards(shapes=SSD_BWD_GUARD_SHAPES, repeats=GUARD_REPEATS):
    """The SSD backward's C entry point on guarded tensors, its scratch
    too, as ``memory_guards`` does for the attention kernels: no guard may
    change and every output must equal the unguarded launch bit for bit,
    ``repeats`` times in a row."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    out = []
    for B, S, H, P, G, N, extra in shapes:
        t0 = time.perf_counter()
        ins = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16, served=True)
        dy = _randn(gen, B, S, H, P, dtype=torch.float32)
        h0 = _randn(gen, B, H, N, P, dtype=torch.float32) if extra else None
        dh = _randn(gen, B, H, N, P, dtype=torch.float32) if extra else None
        _, _, states, aend = ssd(*ins, h0=h0, keep_states=True)
        what = f"ssd_bwd_guards {(B, S, H, P, G, N)} h0/dh_final={extra}"
        plain = [w for w in ssd_bwd_plain(*ins, dy, dh_final=dh, h0=h0)
                 if w is not None]
        entries = [("repro_ssd_bwd",
                    ssd_bwd_slices(H // G, P, N, torch.bfloat16))]
        row = {"shape": [B, S, H, P, G, N], "h0_dh_final": extra,
               "offsets_bytes": list(GUARD_OFFSETS), "repeats": repeats}
        for entry, nsl in entries:
            call, outs, scratch = _ssd_bwd_entry(entry, ins, dy, states,
                                                 aend, dh, h0, nsl)
            call()
            torch.cuda.synchronize()
            wants = [w for w in outs if w is not None]
            row[entry] = {"design": ssd_bwd_design(P, N, torch.bfloat16),
                          "scaled_vs_plain": {
                              n: _scaled_err(g, w, f"{what} {entry} {n}",
                                             _ssd_bwd_tol(n, torch.bfloat16))
                              for n, g, w in zip(SSD_BWD_NAMES, wants,
                                                 plain)},
                          "scratch": [list(t.shape) for t in scratch]}
            fn = _ssd_bwd_fn(entry)
            nc = states.shape[1]
            for offset in GUARD_OFFSETS:
                g_in = [None if t is None else _guarded(t, offset)
                        for t in (*ins, dy, dh, states, aend)]
                g_out = [_guarded(w, offset) for w in wants]
                g_ws = [_guarded(t, offset) for t in scratch]
                # dx, ddt, dA, dB, dC, then dh0 where there is one
                outs_g = [g[0] for g in g_out] + ([None] if h0 is None
                                                  else [])
                ptrs = [None if g is None else g[0] for g in g_in] + \
                    outs_g + [g[0] for g in g_ws]

                def launch():
                    rc = fn(*(None if t is None else t.data_ptr()
                              for t in ptrs), nc, B, S, H, P, G, N, 1,
                            torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"{entry} returned {rc}")
                _guarded_runs(launch, [g for g in g_in if g is not None]
                              + g_ws, g_out, wants,
                              f"{what} {entry} offset {offset} B", repeats)
                del g_in, g_out, g_ws, ptrs
            del call, outs, scratch, wants
        row["phase_s"] = time.perf_counter() - t0
        out.append(row)
        del ins, dy, states, aend, plain
        torch.cuda.empty_cache()
    return out


def _live_pairs(S, T, causal, window):
    """(query, key) pairs the mask leaves live, per batch row and head."""
    i = np.arange(S)[:, None]
    j = np.arange(T)[None, :]
    live = np.ones((S, T), bool)
    if causal:
        live &= j <= i
    if window > 0:
        live &= i - j < window
    return int(live.sum())


def flash_d256_cases(gen):
    rows = []
    for (B, S, T, H, K, D, causal, window, dt) in ATTN_D256_CASES:
        q = _randn(gen, B, S, H, D, dtype=dt)
        k = _randn(gen, B, T, K, D, dtype=dt)
        v = _randn(gen, B, T, K, D, dtype=dt)
        for softcap in (0.0, 30.0):
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_plain(q, k, v, **kw)
            tol = _tol(dt, 2e-5)
            what = f"flash_attention D=256 " \
                   f"{(B, S, T, H, K, D, causal, window)} {dt} " \
                   f"softcap={softcap}"
            row = {"shape": [B, S, T, H, K, D], "causal": causal,
                   "window": window, "softcap": softcap, "dtype": str(dt),
                   "tol": tol, "max_abs_err": _err(got, want, tol, what)}
            if dt == torch.bfloat16:
                row["scaled"] = _scaled_err(got, want, what)
            rows.append(row)
    return rows


def _skipped_tile_fault(q, k, v, want, window, m0, BM=128, BN=64):
    """The output of the ``BM`` query positions from ``m0`` recomputed in
    fp32 without the first key tile that ``live_key_tiles`` gives them
    under the causal ``window`` -- a walk that starts one ``BN``-key tile
    late -- and planted in ``want``; the scaled comparison must reject it.
    The same recomputation with no tile dropped must pass it (a control on
    the recomputation).  Returns both scaled errors."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    n_begin = live_key_tiles(m0, BM, BN, T, True, window)[0]
    rows = slice(m0, m0 + BM)
    i = torch.arange(m0, m0 + BM, device=DEV)[:, None]
    j = torch.arange(T, device=DEV)[None, :]
    kk, vv = (x.float().repeat_interleave(H // K, dim=2) for x in (k, v))
    s = torch.einsum("brhd,bthd->bhrt", q[:, rows].float(), kk) / D ** 0.5
    out = {}
    for name, lo in (("control", n_begin), ("skipped_tile", n_begin + BN)):
        live = (j <= i) & (i - j < window) & (j >= lo)
        p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
        bad = want.float().clone()
        bad[:, rows] = torch.einsum("bhrt,bthd->brhd", p, vv)
        out[name] = _scaled(bad, want)
    check(_passes(out["control"]), f"the skipped-tile recomputation without "
                                   f"a skip fails: {out['control']}")
    check(not _passes(out["skipped_tile"]),
          f"planted fault: key tile {n_begin} of positions {m0}.. skipped, "
          f"passes the scaled comparison {out['skipped_tile']}")
    return {"m0": m0, "n0": n_begin, **out}


def flash_d256_main_shape(gen):
    """recurrentgemma-2b's local attention over a 4096-token prefill: q
    (1,4096,10,256), k/v (1,4096,1,256) bf16, causal, window 2048.  A
    dropped last panel of o and a key tile skipped under the window must be
    rejected."""
    B, S, T, H, K, D, causal, window, dt = ATTN_SERVED
    q = _randn(gen, B, S, H, D, dtype=dt)
    k = _randn(gen, B, T, K, D, dtype=dt)
    v = _randn(gen, B, T, K, D, dtype=dt)
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, **kw)
    what = "flash_attention D=256 served shape"
    err = _err(got, want, 2e-2, what)
    scaled = _scaled_err(got, want, what)
    # the block of 128 positions whose first live tile the window decides
    # (m0 - window + 1 is not a multiple of 64)
    faults = {"planted_fault_tail_panel": _tail_panel_fault(want,
                                                            f"{what} o"),
              "planted_fault_skipped_tile": _skipped_tile_fault(
                  q, k, v, want, window, m0=2944)}
    ms = time_ms([lambda: flash_attention(q, k, v, **kw)], 10)
    plain_ms = time_ms([lambda: attention_plain(q, k, v, **kw)], 2)
    mask = _window_mask(S, T, window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(
        [lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)], 5)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * D * H * B * _live_pairs(S, T, causal, window)
    return dict({"shape": [B, S, T, H, K, D], "window": window,
                 "dtype": str(dt), "tol": 2e-2, "design": design(D, dt),
                 "max_abs_err": err, "scaled": scaled, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms, **faults},
                **_bound(nbytes, flops, dt))


def ptxas_usage(names):
    """Registers and spills that ``nvcc -Xptxas -v`` reported for each
    kernel whose mangled name contains one of ``names``; fails where one of
    them was not compiled or spills."""
    out, cur = {}, None
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            cur = next((n for n in names if n in fn), None)
            if cur is not None:
                cur = f"{cur}:{fn[-40:]}"
        elif cur is not None and "spill stores" in line:
            out.setdefault(cur, {})["spill"] = line.strip()
        elif cur is not None and "Used" in line and "registers" in line:
            out.setdefault(cur, {})["registers"] = int(
                line.split("Used")[1].split("registers")[0])
            cur = None
    for n in names:
        got = [v for k, v in out.items() if k.startswith(n + ":")]
        check(bool(got), f"ptxas reported no kernel named like {n}")
        check(all("0 bytes spill stores, 0 bytes spill loads" in v["spill"]
                  for v in got), f"{n} spills: {got}")
    return out


# ---------------------------------------------------------------------------
# the served path
# ---------------------------------------------------------------------------
def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, n).tolist()


def _latency(rep):
    return {"ttft_p50_s": rep["ttft_s"]["p50"],
            "ttft_p99_s": rep["ttft_s"]["p99"],
            "tpot_p50_s": rep["tpot_s"]["p50"],
            "tpot_p99_s": rep["tpot_s"]["p99"],
            "throughput_tok_s": rep["throughput_tok_s"],
            "iterations": rep["iterations"], "compile_s": rep["compile_s"],
            "graphs": rep["graphs"]}


def _graphs_on(rep, what):
    """The engine served through its CUDA graphs: they were captured."""
    g = rep["graphs"]
    check(g["enabled"] and g["graphs"] > 0,
          f"{what}: the engine captured no step graph: {g}")


PAGED_KW = dict(mode="paged", fused=True, n_slots=8, max_seq=2048,
                page_size=16, prefill_chunk=256)


def serve_paged(cfg, model, policy):
    """Returns the paged launches and the engine (for ``graphs_paged``)."""
    eng = AsyncServeEngine(cfg, model, policy, device=DEV, **PAGED_KW)
    eng.warmup()
    shared = _prompt(999, 256, cfg.vocab_size)
    lens = np.linspace(128, 1024, 16).astype(int).tolist()
    reqs = []
    for i, n in enumerate(lens):
        if i % 5 == 0:                      # 0, 5, 10, 15 share a prefix
            n = max(n, 320)
            prompt = shared + _prompt(i, n - 256, cfg.vocab_size)
        else:
            prompt = _prompt(i, n, cfg.vocab_size)
        reqs.append(ServeRequest(i, prompt, max_new=64))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()               # just before the main path
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"request {r.rid} rejected: {r.why_rejected}")
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()            # just after
    rep = eng.report()
    served = sum(r.done for r in reqs)
    check(served == len(reqs), f"serve_paged served {served}/{len(reqs)}")
    check(all(len(r.out) == 64 and all(0 <= t < cfg.padded_vocab
                                       for t in r.out) for r in reqs),
          "serve_paged: a request's output is malformed")
    n_paged = counts["paged_decode_attention"]
    want = rep["decode_iterations"] * cfg.n_layers
    check(n_paged > 0, "serve_paged launched the paged decode kernel 0 times")
    check(n_paged == want, f"paged decode launches {n_paged} != pure-decode "
                           f"iterations x layers = {want}")
    hit = rep["kv_pages"]["hit_rate"]
    check(hit > 0, "serve_paged: prefix reuse gave hit_rate 0")
    _graphs_on(rep, "serve_paged")
    emit("serve_paged", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         requests=len(reqs), served=served, prompt_lens=lens, max_new=64,
         wall_s=wall, decode_iterations=rep["decode_iterations"],
         paged_kernel_launches=n_paged, hit_rate=hit,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         memory_reserved=torch.cuda.memory_reserved(), **_latency(rep))
    return n_paged, eng


def serve_dense(cfg, model, policy):
    eng = AsyncServeEngine(cfg, model, policy, mode="dense", n_slots=4,
                           max_seq=2048, device=DEV)
    eng.warmup()
    lens = [300, 500, 1100, 1500]           # pow2 buckets 512, 512, 2048, 2048
    reqs = [ServeRequest(i, _prompt(100 + i, n, cfg.vocab_size), max_new=16)
            for i, n in enumerate(lens)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"request {r.rid} rejected: {r.why_rejected}")
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rep = eng.report()
    served = sum(r.done for r in reqs)
    check(served == len(reqs), f"serve_dense served {served}/{len(reqs)}")
    n_flash = counts["flash_attention"]
    check(n_flash > 0, "serve_dense launched the flash kernel 0 times")
    want = WANT_DESIGN["flash_attention"][cfg.head_dim]
    check(design(cfg.head_dim, torch.bfloat16) == want,
          f"serve_dense: the bf16 forward at D = {cfg.head_dim} is not on "
          f"the {want} design")
    check(n_flash == len(reqs) * cfg.n_layers,
          f"flash launches {n_flash} != prefills x layers = "
          f"{len(reqs) * cfg.n_layers}")
    _graphs_on(rep, "serve_dense")
    emit("serve_dense", arch=cfg.name, n_layers=cfg.n_layers,
         requests=len(reqs), served=served,
         prompt_lens=lens, max_new=16, wall_s=wall,
         flash_kernel_launches=n_flash, **_latency(rep))
    return n_flash


def _streams(cfg, model, impl, mode, prompts, dtype="float32"):
    policy = PolicyConfig(compute_dtype=dtype, remat="none", attn_impl=impl)
    eng = AsyncServeEngine(cfg, model, policy, mode=mode, n_slots=4,
                           max_seq=256, page_size=16, prefill_chunk=64,
                           device=DEV)
    reqs = [ServeRequest(i, list(p), max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        check(eng.submit(r), f"parity request {r.rid} rejected")
    eng.run()
    check(all(r.done for r in reqs), "parity: a request was not served")
    return [r.out for r in reqs]


def parity(cfg, model):
    # 2 layers, full-width heads, fp32: greedy streams kernel == oracle
    small = dataclasses.replace(cfg, name=cfg.name + "-2l", n_layers=2,
                                block_pattern=(ATTN,) * 2)
    m2 = LM.init(small, seed=1, dtype=torch.float32, device=DEV)
    prompts = [_prompt(200 + i, 40 + 23 * i, small.vocab_size)
               for i in range(4)]
    before = ops.launch_counts()
    equal = {}
    for mode in ("paged", "dense"):
        a = _streams(small, m2, "kernel", mode, prompts)
        b = _streams(small, m2, "full", mode, prompts)
        equal[mode] = a == b
        check(a == b, f"parity: greedy streams differ in {mode} mode "
                      f"(kernel {a} vs full {b})")
    after = ops.launch_counts()
    check(all(after[k] > before[k]
              for k in ("flash_attention", "paged_decode_attention")),
          "parity: the kernel runs launched no serving kernel")
    del m2

    # full depth, bf16: one decode step's logits, kernel vs plain
    logits = {}
    prompt = _prompt(300, 200, cfg.vocab_size)
    for impl in ("kernel", "full"):
        policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                              attn_impl=impl)
        eng = AsyncServeEngine(cfg, model, policy, mode="paged", n_slots=2,
                               max_seq=512, page_size=16, prefill_chunk=256,
                               device=DEV)
        req = ServeRequest(0, list(prompt), max_new=4)
        eng.submit(req)
        while not (req.state == "decode" and req.out):
            eng.step()
        _, lg = eng._run_paged(
            [req], [[req.out[-1]]], [[req.prompt_len + len(req.out) - 1]],
            [[True]], [0])
        logits[impl] = lg.float()
    scale = float(logits["full"].abs().max())
    err = float((logits["kernel"] - logits["full"]).abs().max())
    check(bool(torch.isfinite(logits["kernel"]).all()),
          "parity: non-finite bf16 logits")
    check(logits["kernel"].shape == (1, cfg.padded_vocab),
          "parity: logits have the wrong shape")
    check(err <= 2e-2 * scale, f"parity: bf16 decode logits differ by {err} "
                               f"(> 2e-2 x max-abs {scale})")
    emit("parity", fp32_streams_equal=equal, bf16_decode_logits_max_abs=scale,
         bf16_decode_logits_max_abs_err=err, tol_rel=2e-2)


# ---------------------------------------------------------------------------
# one program per step: the served engines with and without CUDA graphs
# ---------------------------------------------------------------------------
# (way, prompt set) in the order served: each way serves both sets, in turns
GRAPH_TURNS = (("graphs", 0), ("eager", 0), ("eager", 1), ("graphs", 1))
GRAPH_PAGED_LENS = [128, 192, 256, 320, 384, 448, 512, 576]
GRAPH_MAX_NEW = 24


def _round(eng, prompts, max_new, what):
    """``prompts`` served to the end as fresh requests: the streams, the
    launches counted from zero, wall seconds, TTFT / TPOT p50 / p99 and
    output tokens/s of this round alone."""
    reqs = [ServeRequest(i, list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"{what}: request {r.rid} rejected: "
                             f"{r.why_rejected}")
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(all(r.done and len(r.out) == max_new for r in reqs),
          f"{what}: a request was not served whole")
    ttft = ServingStats._dist([r.ttft_s() for r in reqs])
    tpot = ServingStats._dist([r.tpot_s() for r in reqs])
    return {"streams": [r.out for r in reqs], "launches": counts,
            "wall_s": wall, "ttft_p50_s": ttft["p50"],
            "ttft_p99_s": ttft["p99"], "tpot_p50_s": tpot["p50"],
            "tpot_p99_s": tpot["p99"],
            "throughput_tok_s": sum(len(r.out) for r in reqs) / wall}


def _in_turns(engines, sets, max_new, what):
    """Both prompt sets served by the graph engine and the eager one in
    turns (``GRAPH_TURNS``: host clocks drift between calls, so each way
    gets an early and a late round); per set the greedy streams must be
    identical and the launch counts equal.  Returns each way's rounds."""
    by_set: dict = {}
    rounds = {"graphs": [], "eager": []}
    for way, i in GRAPH_TURNS:
        r = _round(engines[way], sets[i], max_new, f"{what} {way}")
        by_set.setdefault(i, {})[way] = r
        rounds[way].append(dict({k: v for k, v in r.items()
                                 if k != "streams"}, prompt_set=i))
    for i, r in by_set.items():
        check(r["graphs"]["streams"] == r["eager"]["streams"],
              f"{what}: greedy streams differ with and without graphs "
              f"(prompt set {i})")
        check(r["graphs"]["launches"] == r["eager"]["launches"],
              f"{what}: launches {r['graphs']['launches']} with graphs != "
              f"{r['eager']['launches']} without (prompt set {i})")
        check(any(v > 0 for v in r["graphs"]["launches"].values()),
              f"{what}: no kernel launched (prompt set {i})")
    return rounds


STEP_REPS = 3


def _step_ms(eng, fn, key, reps=STEP_REPS):
    """``fn()`` (one engine step) ``reps`` times more without the profiler:
    the median host wall of a call that ends in a synchronize, and where
    ``key`` has a graph the median device time of its replay alone (CUDA
    events around ``replay()``: kernels and the gaps between them)."""
    walls, replays = [], []
    graph = eng.graphs.graph(key)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if graph is not None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            replays.append(a.elapsed_time(b))
    return {"wall_ms_unprofiled": float(np.median(walls)),
            "replay_ms": float(np.median(replays)) if replays else None,
            "key": list(key)}


def _same_logits(got, want, what):
    """One decode step's logits with graphs against without: bit-identical
    (the same kernels on the same inputs), or else within the parity
    phase's 2e-2 of max-abs."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    bit = torch.equal(got, want)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    check(bit or err <= 2e-2 * scale,
          f"{what}: logits with graphs differ by {err} (> 2e-2 x max-abs "
          f"{scale}) from those without")
    return {"bit_identical": bit, "max_abs_err": err, "max_abs": scale,
            "shape": list(got.shape)}


def _profile_paged(eng, prompts, what):
    """Requests of ``prompts`` (one a slot) served until all decode, then
    one decode
    iteration's step over all of them (``_run_paged``, width 1: a graph
    replay where the engine has graphs) under ``torch.profiler``; then the
    requests finish.  Returns the profile and that step's logits."""
    reqs = [ServeRequest(1000 + i, list(p), max_new=16)
            for i, p in enumerate(prompts)]
    for r in reqs:
        check(eng.submit(r), f"{what}: request {r.rid} rejected")
    for _ in range(len(reqs) * 4):
        if all(r.state == "decode" and r.out for r in reqs):
            break
        eng.step()
    check(all(r.state == "decode" and r.out for r in reqs),
          f"{what}: the requests did not all reach decode")
    toks = [[r.out[-1]] for r in reqs]
    pos = [[r.prompt_len + len(r.out) - 1] for r in reqs]
    out = {}

    def step():
        out.update(step=eng._run_paged(reqs, toks, pos, [[True]] * len(reqs),
                                       [0] * len(reqs)))

    prof = _profile(step, what)
    logits = out["step"][1].float().clone()
    key = ("decode", min(bucket_pow2(len(reqs), floor=1), eng.n_slots),
           eng._table_width(reqs, 1), 1)
    prof.update(_step_ms(eng, step, key))    # rewrites the same K/V
    eng.run()                 # the step rewrote what the next one writes
    check(all(r.done for r in reqs), f"{what}: a request was not served")
    return dict(prof, rows=len(reqs)), logits


def _graphs_line(cfg, mode, eng, eager, rounds, prof, same, t0):
    g, e = eng.report(), eager.report()
    _graphs_on(g, f"graphs {cfg.name}")
    check(not e["graphs"]["enabled"] and e["graphs"]["graphs"] == 0,
          f"graphs {cfg.name}: the eager engine captured graphs")
    emit("graphs", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         mode=mode, rounds=rounds, turns=GRAPH_TURNS,
         streams_identical=True, launches_equal=True,
         capture=g["graphs"], graph_compile_s=g["compile_s"],
         eager_compile_s=e["compile_s"], profiled_decode=prof,
         decode_logits=same, memory_reserved=torch.cuda.memory_reserved(),
         phase_s=time.perf_counter() - t0)


def graphs_paged(cfg, model, policy, eng):
    """``eng`` (``serve_paged``'s engine, with its graphs) against a
    ``graphs=False`` engine of the same shape."""
    t0 = time.perf_counter()
    eager = AsyncServeEngine(cfg, model, policy, graphs=False, device=DEV,
                             **PAGED_KW)
    eager.warmup()
    engines = {"graphs": eng, "eager": eager}
    sets = [[_prompt(800 + 10 * k + i, n, cfg.vocab_size)
             for i, n in enumerate(GRAPH_PAGED_LENS)] for k in range(2)]
    rounds = _in_turns(engines, sets, GRAPH_MAX_NEW, f"graphs {cfg.name}")
    short = [_prompt(900 + i, 64, cfg.vocab_size)
             for i in range(eng.n_slots)]
    prof, logits = {}, {}
    for way in ("graphs", "eager"):
        prof[way], logits[way] = _profile_paged(
            engines[way], short, f"graphs {cfg.name} paged decode ({way})")
    same = _same_logits(logits["graphs"], logits["eager"],
                        f"graphs {cfg.name}")
    _graphs_line(cfg, "paged", eng, eager, rounds, prof, same, t0)


def graphs_dense(cfg, model, policy, eng, lens, max_new):
    """``eng`` (the dense serving phase's engine, with its graphs) against a
    ``graphs=False`` engine of the same shape; the profiled decode step's
    logits compared on the slots the last round used; a prefill of
    ``max(lens)`` tokens timed each way without the profiler (the serving
    phase profiled the graph's)."""
    t0 = time.perf_counter()
    eager = AsyncServeEngine(cfg, model, policy, mode="auto",
                             n_slots=eng.n_slots, max_seq=eng.max_seq,
                             graphs=False, device=DEV)
    eager.warmup()
    engines = {"graphs": eng, "eager": eager}
    sets = [[_prompt(820 + 10 * k + i, n, cfg.vocab_size)
             for i, n in enumerate(lens)] for k in range(2)]
    rounds = _in_turns(engines, sets, max_new, f"graphs {cfg.name}")
    prof, logits = {}, {}
    for way in ("graphs", "eager"):
        e, n = engines[way], max(lens)
        S = min(bucket_pow2(n, floor=16), e.max_seq)
        prof[way], lg = _profile_decode(e, n, f"graphs {cfg.name} ({way})")
        prof[way]["prefill"] = _step_ms(e, lambda: e.prefill_once([0] * n),
                                        ("prefill", S))
        logits[way] = lg[:len(lens)]       # slots 0.. of the last round
    same = _same_logits(logits["graphs"], logits["eager"],
                        f"graphs {cfg.name}")
    _graphs_line(cfg, "dense", eng, eager, rounds, prof, same, t0)


# ---------------------------------------------------------------------------
# the trained path
# ---------------------------------------------------------------------------
TRAIN_POLICY = PolicyConfig(compute_dtype="bfloat16", param_dtype="float32",
                            remat="block", attn_impl="kernel")


def _model_flops_per_step(cfg, n_params, shape):
    """6 * N * tokens for the weight products, plus the attention blocks'
    products (QK^T and PV: 4 * D flops per live (query, key) pair and head
    forward, twice that backward; causal, under the window in a local
    block); activation recompute not counted."""
    B, S = shape.global_batch, shape.seq_len
    pairs = sum(B * cfg.n_heads * _live_pairs(
        S, S, True, cfg.local_window if blk == ATTN_LOCAL else 0)
        for blk in cfg.pattern if blk in (ATTN, ATTN_LOCAL))
    return 6 * n_params * B * S + 12 * cfg.head_dim * pairs


KINDS = (("attention_kernels", ("flash_fwd", "flash_bwd", "paged_")),
         ("ssd_bwd_kernels", ("ssd_bwd_",)),
         ("ssd_kernels", ("ssd_state", "ssd_pass", "ssd_output")),
         ("rglru_kernels", ("rglru_",)),
         ("matmul", ("gemm", "xmma", "nvjet", "cutlass")))


def _profile(fn, what):
    """``fn()`` once more under ``torch.profiler``: device time by kind of
    kernel and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    by_name: dict = {}
    n = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name
        n += 1
        by_name[name] = by_name.get(name, 0.0) + us
        kind = next((k for k, keys in KINDS
                     if any(t in name.lower() for t in keys)), "other")
        by_kind[kind] += us
    check(n > 0, f"{what}: the profiler saw no device activity")
    busy = sum(by_kind.values())
    check(busy <= 1.05 * wall_us,
          f"{what}: profiled device time {busy / 1e3} ms exceeds the wall "
          f"time {wall_us / 1e3} ms: kernels counted twice")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "device_events": n,
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


def train(cfg, shape=TRAIN_SHAPE, steps=TRAIN_STEPS,
          cuts=("global batch 256 -> 2 (one card)",), full=True,
          leaves=None):
    """``cfg`` (llama3.2-3b, recurrentgemma-2b or mamba2-780m at full width
    and depth) trained in bf16 compute, fp32 parameters and AdamW state,
    per-block activation checkpointing, ``shape`` tokens per step, random
    weights from seed 0 made on the device.  Every step launches the
    stats-emitting forward twice per attention block (forward and
    recompute) and dK/dV and dQ once, the RG-LRU forward twice per RG-LRU
    block and its backward once, the SSD forward twice per SSM block and
    its backward once.  The first step's loss and the gradients of
    ``leaves`` (by default the attention projections) are held against one
    pass through the plain attention (and RG-LRU), each gradient within
    2e-2 of its max-abs.  With SSM blocks the reference pass is fp32, and
    one pass through the kernels (their fp32 variants) is held to it, loss
    and gradients at 5e-4: at mamba2's 48 layers bf16 alone moves these
    gradients by 9-22 % of their max-abs (PERF.md's mamba2 training
    findings), so no bf16 limit could tell a wrong kernel from rounding.
    That fp32 pass runs the SSD backward's fp32 design (the CUDA cores);
    the bf16 steps run its tensor-core design, which ``ssd_bwd_cases``
    holds at the trained shape, and the first step's bf16 loss within 2e-2
    of the fp32 reference's.  ``full``: the loss must fall, and one more step is profiled;
    else (a depth cut, two steps) only the launches and the first step's
    parity are held."""
    t_start = time.perf_counter()
    L = cfg.n_layers
    leaves = leaves or ATTN_LEAVES
    n_attn = sum(blk in (ATTN, ATTN_LOCAL) for blk in cfg.pattern)
    n_rec = cfg.pattern.count(RGLRU)
    n_ssm = cfg.pattern.count(SSM)
    optcfg = AdamWConfig(lr=3e-4)
    # Adam's first updates move every weight by about lr * sign(g): from
    # this random init the loss rises for two steps at any lr >= 1.5e-4 and
    # falls again as the cosine decays (PERF.md, the training findings); with
    # the one warm-up step at lr 0 it ends below where it started
    sched = ScheduleConfig(kind="cosine", peak_lr=3e-4, warmup_steps=1,
                           total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(cfg, TRAIN_POLICY, optcfg, seed=0, device=DEV)
    n_params = sum(p.numel() for p in state.model.parameters())
    step_fn = trainer.make_train_step(cfg, TRAIN_POLICY, optcfg, sched,
                                      shape=shape)
    ds = SyntheticDataset(cfg, shape, seed=0)
    batches = [ds.batch_at(i) for i in range(steps)]
    want = dict({k: 0 for k in ops.launch_counts()},
                flash_attention_fwd_stats=2 * n_attn,
                flash_attention_bwd_dkv=n_attn,
                flash_attention_bwd_dq=n_attn, rglru=2 * n_rec,
                rglru_bwd=n_rec, ssd=2 * n_ssm, ssd_bwd=n_ssm)
    # the first step's loss and the gradients of ``leaves`` are held
    # against one pass through the plain attention (and RG-LRU, and SSD)
    # from the same weights and batch
    t_init = time.perf_counter()
    plain = dataclasses.replace(TRAIN_POLICY, attn_impl="full")
    tol, ref_dtype, full_attn, attn_err = 2e-2, "bfloat16", None, None
    if n_ssm:
        fp32 = dataclasses.replace(TRAIN_POLICY, compute_dtype="float32")
        tol, ref_dtype = 5e-4, "float32"
        grads, full_loss = _grads(state.model, dataclasses.replace(
            plain, compute_dtype="float32"), batches[0])
        plain32 = _pick(grads, leaves)
        grads, loss32 = _grads(state.model, fp32, batches[0])
        check(abs(loss32 - full_loss) <= tol * abs(full_loss),
              f"train: fp32 first loss {loss32} vs {full_loss} through the "
              f"plain versions (> {tol})")
        attn_err = _leaf_errs(_pick(grads, leaves), plain32, tol,
                              "train: fp32 first step vs the plain versions")
        del grads, plain32
    else:
        grads, full_loss = _grads(state.model, plain, batches[0])
        full_attn = _pick(grads, leaves)
        del grads
    losses, norms, lrs, step_s = [], [], [], []
    torch.cuda.synchronize()
    t_ref = time.perf_counter()
    ops.reset_launch_counts()               # just before the main path
    for i, batch in enumerate(batches):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == want, f"train step {i}: launches {per_step} != "
                                f"{want} (two forwards and one backward per "
                                f"attention, RG-LRU and SSM block)")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i == 0:
            check(abs(losses[0] - full_loss) <= 2e-2 * abs(full_loss),
                  f"train: first loss {losses[0]} vs {full_loss} through "
                  f"the plain versions in {ref_dtype} (> 2e-2)")
            if full_attn is not None:
                attn_err = _leaf_errs(
                    _pick({n: p.grad for n, p in
                           state.model.named_parameters()}, leaves),
                    full_attn, tol, "train: first step vs plain attention")
            del full_attn
            # the peak below is that of the steady steps
            torch.cuda.reset_peak_memory_stats()
    counts = ops.launch_counts()            # just after
    # every launch above was bf16 at the model's head_dim (and its SSM
    # widths): the library's dispatch names the design that served them
    designs, want_design = {}, {}
    if n_attn:
        designs = {"flash_attention_fwd_stats": design(cfg.head_dim,
                                                       torch.bfloat16),
                   "flash_attention_bwd_dkv": design_dkv(cfg.head_dim,
                                                         torch.bfloat16),
                   "flash_attention_bwd_dq": design_dq(cfg.head_dim,
                                                       torch.bfloat16)}
        want_design = {n: WANT_DESIGN[n][cfg.head_dim] for n in designs}
    if n_ssm:
        P, N = cfg.ssm.head_dim, cfg.ssm.d_state
        designs.update(ssd=ssd_design(P, N, torch.bfloat16),
                       ssd_bwd=ssd_bwd_design(P, N, torch.bfloat16))
        want_design.update(ssd="mma.sync", ssd_bwd="mma.sync")
    check(designs == want_design,
          f"train: the kernels are on the designs {designs}, not "
          f"{want_design}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train: non-finite loss or grad norm {losses} {norms}")
    profile = None
    t_steps = time.perf_counter()
    if full:
        profile = _profile(lambda: step_fn(state, batches[-1]), "train")
        # a smoke signal only: whether the gradients are right is checked
        # above
        check(losses[-1] < losses[0],
              f"train: loss did not fall over {steps} steps: {losses}")
    p50 = float(np.median(step_s[1:]))      # the first step is warm-up
    tokens = shape.tokens
    flops = _model_flops_per_step(cfg, n_params, shape)
    emit("train", arch=cfg.name, n_layers=L, params=n_params,
         batch=shape.global_batch, seq=shape.seq_len,
         compute_dtype="bfloat16", param_dtype="float32", remat="block",
         steps=steps, warmup_steps_excluded=1, losses=losses,
         grad_norms=norms, lrs=lrs, step_s=step_s, step_s_p50=p50,
         tokens_per_s=tokens / p50, model_flops_per_step=flops,
         model_flops_per_s=flops / p50,
         model_flops_per_s_over_989_tflops=flops / p50 / 989e12,
         launches=counts, designs=designs,
         first_step_vs_plain_attention={
             "loss": [losses[0], full_loss], "leaves": list(leaves),
             "worst_grad_err_over_max_abs": attn_err,
             "tol_rel": tol, "reference_dtype": ref_dtype},
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         profiled_step=profile, cuts=list(cuts),
         phase_s={"init": t_init - t_start, "reference_passes": t_ref - t_init,
                  "steps": t_steps - t_ref,
                  "profile": time.perf_counter() - t_steps})
    del state, step_fn
    torch.cuda.empty_cache()
    return counts


ATTN_LEAVES = ("wq", "wk", "wv")


def _grads(model, policy, batch):
    """Gradients by parameter name and loss of one forward and backward
    pass; the parameters' ``.grad`` is cleared again."""
    loss_fn = trainer.make_loss_fn(model.cfg, policy)
    grads, loss, _ = trainer._accum_grads(
        loss_fn, model, trainer._device_batch(batch, DEV), 1)
    for p in model.parameters():
        p.grad = None
    return grads, float(loss)


def _pick(grads, leaves=ATTN_LEAVES):
    """The gradients of the parameters named ``leaves`` in every layer (by
    default the attention projections wq, wk, wv)."""
    return {n: g for n, g in grads.items() if n.rsplit(".", 1)[-1] in leaves}


def _leaf_errs(got, want, tol, what):
    """Each gradient of ``want`` against ``got`` within ``tol`` of its
    max-abs; returns the worst error over max-abs."""
    worst = 0.0
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((got[n] - w).abs().max())
        check(err <= tol * scale, f"{what}: gradient {n} differs by {err} "
                                  f"(> {tol} x max-abs {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def train_parity(cfg):
    # 2 layers, full-width heads, fp32: one whole step, kernel vs plain
    small = dataclasses.replace(cfg, name=cfg.name + "-2l", n_layers=2,
                                block_pattern=(ATTN,) * 2)
    shape = ShapeConfig("parity", 1024, 2, "train")
    batch = SyntheticDataset(small, shape, seed=1).batch_at(0)
    fp32 = dataclasses.replace(TRAIN_POLICY, compute_dtype="float32")
    base = LM.init(small, seed=1, dtype=torch.float32, device=DEV)
    out = {}
    for impl in ("kernel", "full"):
        policy = dataclasses.replace(fp32, attn_impl=impl)
        state = trainer.TrainState.create(copy.deepcopy(base), policy)
        step = trainer.make_train_step(small, policy, shape=shape)
        _, m = step(state, batch)
        out[impl] = (float(m["loss"]), float(m["grad_norm"]),
                     {n: p.grad for n, p in state.model.named_parameters()})
    (lk, nk, gk), (lf, nf, gf) = out["kernel"], out["full"]
    check(abs(lk - lf) <= 5e-4 * abs(lf), f"train_parity: loss {lk} vs {lf}")
    check(abs(nk - nf) <= 5e-4 * nf, f"train_parity: grad norm {nk} vs {nf}")
    worst = _leaf_errs(gk, gf, 5e-4, "train_parity")
    del out, gk, gf, base

    # full depth, bf16: the gradients' global norm and the attention
    # gradients of every layer, kernel vs plain
    model = LM.init(cfg, seed=2, dtype=torch.float32, device=DEV)
    shape16 = ShapeConfig("parity_bf16", 2048, 2, "train")
    batch16 = SyntheticDataset(cfg, shape16, seed=2).batch_at(0)
    res = {}
    for impl in ("kernel", "full"):
        policy = dataclasses.replace(TRAIN_POLICY, attn_impl=impl)
        grads, loss = _grads(model, policy, batch16)
        res[impl] = (loss, float(global_norm(grads.values())),
                     _pick(grads))
        del grads
    (l16k, n16k, ak), (l16f, n16f, af) = res["kernel"], res["full"]
    check(np.isfinite(l16k) and np.isfinite(n16k),
          "train_parity: non-finite bf16 loss or grad norm")
    check(abs(n16k - n16f) <= 2e-2 * n16f,
          f"train_parity: bf16 grad norm {n16k} vs {n16f} (> 2e-2)")
    worst16 = _leaf_errs(ak, af, 2e-2, "train_parity: bf16")
    del model, res, ak, af
    torch.cuda.empty_cache()
    emit("train_parity", fp32={"shape": [2, 1024], "n_layers": 2,
                               "loss": [lk, lf], "grad_norm": [nk, nf],
                               "worst_grad_err_over_max_abs": worst,
                               "tol_rel": 5e-4},
         bf16={"shape": [2, 2048], "n_layers": cfg.n_layers,
               "loss": [l16k, l16f], "grad_norm": [n16k, n16f],
               "worst_attention_grad_err_over_max_abs": worst16,
               "tol_rel": 2e-2})


# ---------------------------------------------------------------------------
# the recurrent archs served
# ---------------------------------------------------------------------------
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "recurrentgemma-2b"


def _serve_dense_auto(cfg, model, policy, *, n_slots, max_seq, lens, max_new,
                      seed):
    """``AsyncServeEngine(mode="auto")`` (which must pick ``dense``) over
    requests of the given prompt lengths; launches are counted from zero
    after the warm-up.  Returns (engine report, requests, launch counts,
    the warm-up's launch counts, wall seconds, peak device memory, the
    profiled prefill and decode step, the engine)."""
    eng = AsyncServeEngine(cfg, model, policy, mode="auto", n_slots=n_slots,
                           max_seq=max_seq, device=DEV)
    check(eng.mode == "dense", f"{cfg.name}: auto mode picked {eng.mode}")
    ops.reset_launch_counts()
    eng.warmup()
    warm = ops.launch_counts()
    reqs = [ServeRequest(i, _prompt(seed + i, n, cfg.vocab_size),
                         max_new=max_new) for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()               # just before the main path
    t0 = time.perf_counter()
    for r in reqs:
        check(eng.submit(r), f"request {r.rid} rejected: {r.why_rejected}")
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()            # just after
    served = sum(r.done for r in reqs)
    check(served == len(reqs), f"{cfg.name}: served {served}/{len(reqs)}")
    check(all(len(r.out) == max_new and all(0 <= t < cfg.padded_vocab
                                            for t in r.out) for r in reqs),
          f"{cfg.name}: a request's output is malformed")
    peak = torch.cuda.max_memory_allocated()
    rep = eng.report()
    _graphs_on(rep, cfg.name)
    profiled = {"prefill": _profile_prefill(eng, max(lens),
                                            f"{cfg.name} prefill"),
                "decode_step": _profile_decode(eng, max(lens),
                                               f"{cfg.name} decode")[0]}
    return rep, reqs, counts, warm, wall, peak, profiled, eng


def _profile_prefill(eng, prompt_len, what):
    """One more bucketed prefill of ``prompt_len`` tokens under
    ``torch.profiler``, then timed without it (``_step_ms``), through the
    engine's step: a graph replay where it has graphs."""
    S = min(bucket_pow2(prompt_len, floor=16), eng.max_seq)
    prompt = [0] * prompt_len
    prof = _profile(lambda: eng.prefill_once(prompt), what)
    prof.update(_step_ms(eng, lambda: eng.prefill_once(prompt),
                         ("prefill", S)))
    return dict(prof, tokens=prompt_len, bucket=S)


def _profile_decode(eng, prompt_len, what):
    """One decode step over all slots (token 0 at position ``prompt_len``)
    under ``torch.profiler``, then timed without it, through the engine's
    step.  Returns the profile and the profiled step's logits."""
    B = eng.n_slots
    tok = np.zeros((B, 1), np.int32)
    pos = np.full((B, 1), prompt_len, np.int32)
    out = {}
    prof = _profile(lambda: out.update(step=eng.decode_once(tok, pos)), what)
    logits = out["step"][1][:, -1].float().clone()
    # the repeats advance the recurrent states of every slot once more each
    prof.update(_step_ms(eng, lambda: eng.decode_once(tok, pos),
                         ("decode", B)))
    return dict(prof, rows=B), logits


def _per_prefill(cfg, counts, n_prefills, want_per_prefill):
    """Every kernel's launches against ``want_per_prefill`` (zero for the
    kernels not named) times the prefills."""
    want = {k: want_per_prefill.get(k, 0) * n_prefills for k in counts}
    check(all(counts[k] > 0 for k in want_per_prefill),
          f"{cfg.name}: a kernel of the path was never launched: {counts}")
    check(counts == want, f"{cfg.name}: launches {counts} != {want} "
                          f"({n_prefills} prefills)")


def serve_ssm(cfg, model, policy):
    lens = np.linspace(100, 1500, 12).astype(int).tolist()
    rep, reqs, counts, warm, wall, peak, profiled, eng = _serve_dense_auto(
        cfg, model, policy, n_slots=8, max_seq=2048, lens=lens, max_new=64,
        seed=400)
    _per_prefill(cfg, counts, len(reqs), {"ssd": cfg.pattern.count("ssm")})
    s = cfg.ssm
    ssd_des = ssd_design(s.head_dim, s.d_state, torch.bfloat16)
    check(ssd_des == "mma.sync", f"serve_ssm: the bf16 SSD at P = "
          f"{s.head_dim}, N = {s.d_state} is not on the tensor cores: "
          f"{ssd_des}")
    emit("serve_ssm", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         mode=rep["mode"], slots=8, max_seq=2048, requests=len(reqs),
         served=sum(r.done for r in reqs), prompt_lens=lens, max_new=64,
         wall_s=wall, launches=counts, ssd_design=ssd_des,
         warmup_launches=warm,
         max_memory_allocated=peak, profiled=profiled, **_latency(rep))
    return counts["ssd"], eng


def serve_hybrid(cfg, model, policy):
    lens = [200, 700, 1300, 2100, 2600, 3000]   # three past the window
    rep, reqs, counts, warm, wall, peak, profiled, eng = _serve_dense_auto(
        cfg, model, policy, n_slots=4, max_seq=4096, lens=lens, max_new=32,
        seed=500)
    _per_prefill(cfg, counts, len(reqs),
                 {"rglru": cfg.pattern.count("rglru"),
                  "flash_attention": cfg.pattern.count("attn_local")})
    check(design(cfg.head_dim, torch.bfloat16) == "wgmma",
          f"{cfg.name}: the bf16 forward at D = {cfg.head_dim} is not on "
          f"the wgmma design")
    emit("serve_hybrid", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="bfloat16", mode=rep["mode"], slots=4, max_seq=4096,
         window=cfg.local_window, requests=len(reqs),
         served=sum(r.done for r in reqs), prompt_lens=lens, max_new=32,
         wall_s=wall, launches=counts,
         warmup_launches=warm,
         max_memory_allocated=peak, profiled=profiled, **_latency(rep))
    return counts, eng


def _dense_streams(cfg, model, impl, prompts, max_seq):
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl=impl)
    eng = AsyncServeEngine(cfg, model, policy, mode="auto", n_slots=3,
                           max_seq=max_seq, device=DEV)
    reqs = [ServeRequest(i, list(p), max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        check(eng.submit(r), f"parity request {r.rid} rejected")
    eng.run()
    check(all(r.done for r in reqs), "parity: a request was not served")
    return [r.out for r in reqs]


# bf16 logits at full depth: the plain prefill against the plain prefill of
# all but the last NOISE_DECODE_STEPS tokens followed by that many decode
# steps -- two correct implementations whose spread is bf16 rounding grown
# over the depth; the kernel path may be NOISE_MULTIPLE times as far
NOISE_DECODE_STEPS = 16
NOISE_MULTIPLE = 2.0


def parity_recurrent(cfg, model, n_layers, lens, max_seq, prefill_len):
    """Greedy streams kernels == plain versions at full width in fp32 over
    the first ``n_layers`` of the pattern; then the last-token logits of one
    prefill of the full depth: kernel vs plain within 2e-4 of max-abs in
    fp32, and in bf16 (``model``) within ``NOISE_MULTIPLE`` times the
    spread, measured in this run, between two plain implementations."""
    small = dataclasses.replace(cfg, name=f"{cfg.name}-{n_layers}l",
                                n_layers=n_layers,
                                block_pattern=cfg.pattern[:n_layers])
    m = LM.init(small, seed=1, dtype=torch.float32, device=DEV)
    prompts = [_prompt(600 + i, n, small.vocab_size)
               for i, n in enumerate(lens)]
    ops.reset_launch_counts()
    a = _dense_streams(small, m, "kernel", prompts, max_seq)
    counts = ops.launch_counts()
    b = _dense_streams(small, m, "full", prompts, max_seq)
    check(a == b, f"parity_recurrent {cfg.name}: greedy streams differ "
                  f"(kernel {a} vs plain {b})")
    check(ops.launch_counts() == counts,
          "parity_recurrent: the plain runs launched a kernel")
    for kind, name in (("ssm", "ssd"), ("rglru", "rglru"),
                       ("attn_local", "flash_attention")):
        check(kind not in small.pattern or counts[name] > 0,
              f"parity_recurrent {cfg.name}: the kernel runs launched no "
              f"{name} kernel")
    del m
    # full depth: last-token logits, kernels vs plain versions, in fp32
    # (fresh weights from the same seed) and in bf16
    prompt = torch.tensor([_prompt(700, prefill_len, cfg.vocab_size)],
                          dtype=torch.int32, device=DEV)

    def last_logits(mdl, impl, dtype, decode_steps=0):
        """One prefill of the prompt but its last ``decode_steps`` tokens,
        then one decode step per remaining token."""
        policy = PolicyConfig(compute_dtype=dtype, remat="none",
                              attn_impl=impl)
        n = prefill_len - decode_steps
        lg, caches = make_prefill_step(cfg, policy,
                                       cache_capacity=prefill_len)(
            mdl, prompt[:, :n])
        decode = make_decode_step(cfg, policy, max_seq=prefill_len, batch=1)
        for t in range(n, prefill_len):
            lg, caches = decode(mdl, caches, prompt[:, t:t + 1],
                                torch.full((1, 1), t, dtype=torch.int32,
                                           device=DEV))
        check(lg.shape == (1, 1, cfg.padded_vocab),
              f"parity_recurrent {cfg.name}: logits have the wrong shape "
              f"{tuple(lg.shape)}")
        check(bool(torch.isfinite(lg).all()),
              f"parity_recurrent {cfg.name}: non-finite {dtype} logits")
        return lg.float()

    k16, p16 = (last_logits(model, i, "bfloat16") for i in ("kernel", "full"))
    q16 = last_logits(model, "full", "bfloat16", NOISE_DECODE_STEPS)
    m32 = LM.init(cfg, seed=0, dtype=torch.float32, device=DEV)
    k32, p32 = (last_logits(m32, i, "float32") for i in ("kernel", "full"))
    del m32
    scale = float(p32.abs().max())
    err32 = float((k32 - p32).abs().max())
    check(err32 <= 2e-4 * scale, f"parity_recurrent {cfg.name}: fp32 "
                                 f"prefill logits differ by {err32} (> 2e-4 "
                                 f"x max-abs {scale})")
    err16 = float((k16 - p16).abs().max())
    noise16 = float((q16 - p16).abs().max())
    check(noise16 > 0, f"parity_recurrent {cfg.name}: the two plain bf16 "
                       f"implementations agree exactly: no spread measured")
    check(err16 <= NOISE_MULTIPLE * noise16,
          f"parity_recurrent {cfg.name}: bf16 logits kernel vs plain differ "
          f"by {err16}, more than {NOISE_MULTIPLE} x the {noise16} between "
          f"two plain implementations")
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "fp32_streams_equal": True,
            "fp32_n_layers": n_layers, "fp32_prompt_lens": lens,
            "fp32_kernel_launches": counts, "prefill_len": prefill_len,
            "n_layers": cfg.n_layers, "logits_max_abs_fp32": scale,
            "fp32_kernel_vs_plain_max_abs_err": err32, "fp32_tol_rel": 2e-4,
            "bf16_kernel_vs_plain_max_abs_err": err16,
            "bf16_plain_vs_plain_max_abs_err": noise16,
            "bf16_plain_noise_decode_steps": NOISE_DECODE_STEPS,
            "bf16_tol_noise_multiple": NOISE_MULTIPLE,
            "bf16_kernel_to_fp32_max_abs": float((k16 - p32).abs().max()),
            "bf16_plain_to_fp32_max_abs": float((p16 - p32).abs().max())}


def recurrent(policy):
    """serve_ssm, serve_hybrid, their ``graphs`` phase and their parity;
    returns the launches of the two served runs."""
    out = {}
    parities = []
    for arch, serve in ((SSM_ARCH, serve_ssm), (HYBRID_ARCH, serve_hybrid)):
        cfg = get_config(arch)
        model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
        out[arch], eng = serve(cfg, model, policy)
        if arch == SSM_ARCH:
            graphs_dense(cfg, model, policy, eng, [150, 600, 1200], 12)
            del eng
            parities.append(parity_recurrent(cfg, model, 2, [40, 300, 700],
                                             1024, 1000))
        else:   # one fp32 prompt and the bf16 one past the 2048 window
            graphs_dense(cfg, model, policy, eng, [200, 900, 2300], 12)
            del eng
            parities.append(parity_recurrent(cfg, model, 3,
                                             [40, 700, 2300], 4096, 2500))
        del model
        torch.cuda.empty_cache()
    emit("parity_recurrent", results=parities)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script proves the port on "
              "a GPU and has no CPU fallback", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    smi = nvidia_smi_line()
    build.load()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("env", card=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         python=sys.version.split()[0], kernel_build_s=build.build_seconds,
         kernel_sources=[os.path.relpath(p, ROOT) for p in build.sources()])

    cfg = get_config(ARCH)
    slm = get_config(STABLELM_ARCH)
    hyb = get_config(HYBRID_ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    with torch.no_grad():
        f_cases, p_cases = flash_cases(gen), paged_cases(gen)
        f_cases += flash_d256_cases(gen)
        f_main = [flash_main_shape(gen, cfg, S) for S in (512, 2048)]
        f_d160 = flash_main_shape(gen, slm, 2048)
        f_d256 = flash_d256_main_shape(gen)
        p_main = paged_main_shape(gen, cfg)
        p_d160 = paged_main_shape(gen, slm)
        s_cases, s_main = ssd_cases(gen), ssd_main_shape(gen)
        r_cases, r_main = rglru_cases(gen), rglru_main_shape(gen)
        rb_cases, rb_main = rglru_bwd_cases(gen)
        sb_cases, s_trained, sb_main = ssd_bwd_cases(gen)
    torch.cuda.empty_cache()
    b_cases, b_autograd = bwd_cases(gen)
    with torch.no_grad():
        *b_main, b_faults = bwd_main_shape(gen, cfg, *TRAIN_SHAPE_BS)
        torch.cuda.empty_cache()
        *b_d160, b_faults_d160 = bwd_main_shape(gen, slm, *TRAIN_SHAPE_BS)
        torch.cuda.empty_cache()
        *b_d256, b_faults_d256 = bwd_main_shape(gen, hyb, *TRAIN_SHAPE_BS,
                                                window=hyb.local_window)
    torch.cuda.empty_cache()
    emit("kernel_cases",
         flash_attention={"cases": f_cases, "main_path": f_main,
                          "main_path_d160": [f_d160],
                          "main_path_d256": [f_d256]},
         paged_decode_attention={"cases": p_cases, "main_path": [p_main],
                                 "main_path_d160": [p_d160]},
         ssd={"cases": s_cases, "main_path": [s_main],
              "scaled_tol": SSD_TOL},
         rglru={"cases": r_cases, "main_path": [r_main]},
         rglru_bwd={"cases": rb_cases, "main_path": [rb_main]},
         ssd_trained_shape={"main_path": [s_trained]},
         ssd_bwd={"cases": sb_cases, "main_path": [sb_main],
                  "scaled_tol": SSD_TOL, "scaled_tol_bf16_outputs":
                  SSD_BWD_TOL_BF16},
         flash_attention_bwd={"cases": b_cases,
                              "vjp_vs_autograd": b_autograd,
                              "main_path": dict(zip(TRAIN_KERNELS, b_main)),
                              "main_path_d160": dict(zip(TRAIN_KERNELS,
                                                         b_d160)),
                              "main_path_d256": dict(zip(TRAIN_KERNELS,
                                                         b_d256)),
                              "scaled_tol": SCALED_TOL,
                              "planted_faults_rejected": b_faults,
                              "planted_faults_rejected_d160": b_faults_d160,
                              "planted_faults_rejected_d256": b_faults_d256})
    emit("ptxas", kernels=ptxas_usage(PTXAS_KERNELS))
    with torch.no_grad():
        emit("memory_guards", cases=memory_guards(),
             rglru_bwd=rglru_guards(), ssd_bwd=ssd_bwd_guards())
    torch.cuda.empty_cache()

    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    n_paged, eng = serve_paged(cfg, model, policy)
    graphs_paged(cfg, model, policy, eng)
    del eng
    n_flash = serve_dense(cfg, model, policy)
    parity(cfg, model)
    del model
    torch.cuda.empty_cache()
    n_train = train(cfg)
    train_parity(cfg)
    n_rec = recurrent(policy)
    n_hybrid = n_rec[HYBRID_ARCH]
    # recurrentgemma-2b trained at full width and depth: the D = 256
    # backward under its window and the RG-LRU backward
    n_train_hyb = train(hyb, leaves=HYBRID_TRAIN_LEAVES)
    # mamba2-780m trained at full width and depth: the SSD forward at the
    # trained shape and the SSD backward
    n_train_ssm = train(get_config(SSM_ARCH), leaves=SSM_TRAIN_LEAVES)
    # stablelm-12b (D = 160): served at full width and depth, trained at
    # full width with its depth cut
    model = LM.init(slm, seed=0, dtype=torch.bfloat16, device=DEV)
    n_paged_d160, eng = serve_paged(slm, model, policy)
    del eng
    n_flash_d160 = serve_dense(slm, model, policy)
    del model
    torch.cuda.empty_cache()
    n_train_d160 = train(cut_depth(slm, TRAIN_CUT_LAYERS), TRAIN_CUT_SHAPE,
                         TRAIN_CUT_STEPS, cuts=TRAIN_CUT, full=False)
    torch.cuda.empty_cache()

    def row(name, source, replaces, launches, main, kernel_design):
        head = main[-1]                     # the largest main-path shape
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "design": kernel_design,
               "max_abs_err": max(m["max_abs_err"] for m in main),
               "ms": head["ms"], "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "library_ms": head["library_ms"], "shape": head["shape"],
               "dtype": head["dtype"]}
        for k in ("bound_ms_fp32_cuda_cores", "bound_ms_with_saved_states",
                  "earlier_ms"):
            if k in head:
                out[k] = head[k]
        return out

    bf16 = torch.bfloat16
    bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    fa_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    pa_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    fa_ref = "src/repro/kernels/flash_attention.py:124"
    pa_ref = "src/repro/kernels/paged_attention.py:151"
    bwd_ref = ("src/repro/kernels/flash_attention_bwd.py:238",
               "src/repro/kernels/flash_attention_bwd.py:280",
               "src/repro/kernels/flash_attention_bwd.py:313")
    designs = (design, design_dkv, design_dq)
    rows = [
        # one kernel, three rows: llama's serve_dense launches (D = 128),
        # stablelm's (D = 160) and recurrentgemma's serve_hybrid launches
        # (D = 256, window 2048)
        row("flash_attention", fa_src, fa_ref, n_flash, f_main,
            design(cfg.head_dim, bf16)),
        row("flash_attention_d160", fa_src, fa_ref, n_flash_d160, [f_d160],
            design(slm.head_dim, bf16)),
        row("flash_attention_d256", fa_src, fa_ref,
            n_hybrid["flash_attention"], [f_d256], design(256, bf16)),
        row("paged_decode_attention", pa_src, pa_ref, n_paged, [p_main],
            p_main["design"]),
        row("paged_decode_attention_d160", pa_src, pa_ref, n_paged_d160,
            [p_d160], p_d160["design"])]
    for name, src, ref, des, got, got_d160 in zip(
            TRAIN_KERNELS, (fa_src, bwd_src, bwd_src), bwd_ref, designs,
            b_main, b_d160):
        rows.append(row(name, src, ref, n_train[name], [got],
                        des(cfg.head_dim, bf16)))
        rows.append(row(f"{name}_d160", src, ref, n_train_d160[name],
                        [got_d160], des(slm.head_dim, bf16)))
    for name, src, ref, des, got in zip(
            TRAIN_KERNELS, (fa_src, bwd_src, bwd_src), bwd_ref, designs,
            b_d256):
        rows.append(row(f"{name}_d256", src, ref, n_train_hyb[name], [got],
                        des(hyb.head_dim, bf16)))
    rows += [
        row("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:103", n_rec[SSM_ARCH], [s_main],
            s_main["design"]),
        row("rglru", "src/repro_torch/kernels/csrc/rglru.cu",
            "src/repro/kernels/rglru.py:58", n_hybrid["rglru"], [r_main],
            r_main["design"]),
        # the SSD forward again, at the shape mamba2's training gives it
        row("ssd_trained", "src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:103", n_train_ssm["ssd"], [s_trained],
            s_trained["design"]),
        # no TPU kernel: the reference differentiates its XLA scan
        row("rglru_bwd", "src/repro_torch/kernels/csrc/rglru.cu",
            "src/repro/models/rglru.py:134", n_train_hyb["rglru_bwd"],
            [rb_main], rb_main["design"]),
        row("ssd_bwd", "src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/models/ssm.py:38", n_train_ssm["ssd_bwd"], [sb_main],
            sb_main["design"])]
    emit("summary", elapsed_s=time.perf_counter() - t_start,
         kernel_build_s=build.build_seconds)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
