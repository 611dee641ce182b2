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
                kernels also at bert-base's trained attention (96 x 384, 12
                heads of 64, bidirectional: sub-row (e), with its bound
                and scaled_dot_product_attention's times, where a skipped
                tile must be rejected) and at recurrentgemma-2b's D = 256
                (the reference's
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
  tune          the kernel registry and autotuner (``tune_phase``): the
                sweep of ``autotune.DEFAULT_CASES`` on the card (each cell's
                candidates held to the plain version, then timed; key,
                every candidate's us, default, winner, speedup), llama3.2-3b
                served by an engine built under the swept registry in turns
                with the untuned one (each decode graph's piece length,
                launches, both TPOT p50s, the share of equal greedy
                tokens), and ``CalibratedCost.from_registry``'s
                calibration; the script runs untuned everywhere else (it
                fails at its start if ``$REPRO_TORCH_TUNED_CONFIGS`` names
                a registry, and the line resets its own);
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
  tracking      llama3.2-3b's serve_paged and train ran under one tracking
                ``Run`` in a temporary directory, handed to that engine as
                its ``tracker`` and to that train loop's ``StepTracker``
                (no other phase logs to it), read back with
                ``read_events``: one serve row per ``track_every``
                iterations, one row per train step with rising steps and
                the losses the ``train`` line printed, a finish record;
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
  paper_bench   the paper's five Table II workloads (``PAPER_WORKLOADS``)
                trained at their batch and image or sequence size on one
                card (YOLOv5-L's batch cut, ``PAPER_BATCH_CUT``): random
                weights from seed 0 made on the device, one fixed batch,
                3 steps + one profiled; the CNNs in fp32 (TF32 off in
                cuDNN too), BERT in bf16 through the B2 kernels
                bidirectionally (2 x L stats forwards, L dK/dV, L dQ a
                step); the loss must fall; each CNN on the card against
                the CPU at batch 2 (float64 within 1e-4, float32 outputs
                within 1e-3), BERT's fp32 pass through the kernels against
                the plain attention (5e-4 of each layer's max-abs), its
                bf16 step's loss (2e-2) and its no-grad QA logits through
                B1 (see ``_qa_b1_check``); step p50, images or sequences
                and tokens a second, model flops over the dtype's peak,
                peak memory, device ms by kind, ``phase_s``;
  moe           moonshot-v1-16b-a3b (48 layers, 64 experts top-6 and 2
                shared, 28.9 B parameters) at full size in bf16, random
                weights from seed 0 made on the device: serve_paged and
                serve_dense as above, through the step graphs (the paged
                decode kernel once per layer of every pure-decode
                iteration, flash once per layer of every prefill); one
                decode step and one prefill run eagerly under
                ``_moe_split`` (device ms of routing / sort / dispatch /
                combine, the expert products, the shared experts, the
                attention mixer, the rest); parity: 2-layer fp32 greedy
                streams kernel == plain, the full-depth bf16 decode logits
                reported with the share of (token, layer) routes the two
                paths agree on, and ``parity_moe``: at 16 layers in fp32
                the decode logits kernel vs plain within 2e-4 of max-abs,
                the plain path's own bf16 spread against fp32 reported
                (top-k routing at depth makes bf16 no oracle);
                llama4-scout-17b-a16e cut to 12 of 48 layers, served paged
                and dense; moonshot trained at 4 of 48 layers (``train``:
                3 steps + one profiled + one under ``_moe_split``, lr 1e-4;
                the first step in fp32, kernels against the plain
                attention: every leaf within 5e-4 of its max-abs, the
                routes equal); the ``moe`` line: the splits, peak memory,
                ``phase_s``;
  composable    the composable-system analytics (``repro_torch.core``) on
                the card: (a) its total memory, a 1 GiB device copy (read +
                write) and a bf16 8192^3 ``torch.matmul`` beside the port's
                ``ChipSpec``; (b) pinned 256 MiB host->device and
                device->host copies and a 4-byte copy's latency beside the
                ``HOST`` link (no measured figure may beat its constant by
                more than 5 %); (c) every ``train`` run above priced by the
                cost model (``step_flops`` over the bf16 peak,
                ``analytic_hbm_bytes`` over the HBM rate, 1 x 1 mesh, the
                policy that ran) beside its measured step p50, which the
                prediction may not exceed by more than 5 %;
  elastic       a failure and resume through the kernels: mamba2-780m at
                full width, depth cut to 2 of 48 layers, trained on 2 x
                4096 tokens (bf16 compute, fp32 parameters, AdamW, per-block
                remat); run A takes 6 steps from seed 0 and run A' the same
                again (is the step deterministic?); run B takes 3 steps,
                saves a checkpoint (``train/checkpoint``), its 1 x 1
                composition in a modelled pool of H100s loses its device
                (``train/elastic.handle_failure``: a recompose onto a
                spare), the model, optimizer state and cached allocator
                blocks are dropped, a state from seed 1 is restored from the
                checkpoint onto the card (``elastic.resume``) and B takes
                steps 4-6 on the same batches.  B's losses and final
                parameters and moments must equal A's bit for bit (or, if
                A and A' differ, lie within their spread; the line says
                which held), each resumed step must launch the SSD forward
                4 times and its backward 2, and the run's events must be
                failure, recompose, restore; the checkpoint's bytes, save
                and restore seconds and GB/s are printed beside the rate at
                which the cluster simulator prices a restore
                (``Scheduler.restore_s``: the tranche's per-lessee read
                rate);
  cluster       the cluster control plane (``repro_torch.cluster``) at the
                H100's constants: ``examples/cluster_trace.py``'s trace (24
                jobs, 0.2 Hz, seed 7, a 12-device wave at 120 s repaired
                after 180 s) and the same trace with a ``FaultPlan``, a
                ``RecomposeConfig`` and the ``priority_preempt`` policy,
                each run twice: the reports must be byte-identical, every
                job accounted for, no lease conflict; jobs done, makespan,
                AUU, pool utilisation, recompositions and ``wall_s``;
  ladder        the paper's software ladder (§V-4) as the data-parallel
                layer (``ladder_phase``): qwen2-0.5b at full width on a
                one-rank NCCL ``DeviceMesh`` (``data`` = 1), each distinct
                program of ``policy.ladder()`` trained in turns (DP in fp32,
                DDP+mixed in bf16, ZeRO-3; DDP is DP's program) with B2's
                kernels at its shape (the ``*_qwen`` rows, G = 7 at D = 64),
                step p50, tokens/s, memory, launches and the collectives
                ``hierarchy`` counted, ZeRO-3's parameters bit for bit
                DDP+mixed's; the int8 error-feedback exchange over
                its gradients against ``compress``'s math and the
                ``hierarchy`` prices; the four-rank ``gloo`` rehearsal on
                the host (``launch/rehearse``; started after the build, it
                runs beside ``kernel_cases``, and holds tensor
                parallelism on (data, model) = (2, 2) to DP -- llama3.2-3b
                and recurrentgemma-2b --, expert parallelism with ZeRO-3
                to without, a ServeEngine's streams on (2, 2) and the
                paged engine's on (1, 4) to one process's); each rank's
                state bytes from the specs;
  tp            tensor and expert parallelism (``tp_phase``) on a one-rank
                NCCL mesh (data, model) = (1, 1): nothing crosses cards,
                every collective runs on the one rank; each path held to
                the no-mesh path at the same seed: llama3.2-3b served by
                the dense ``ServeEngine`` in turns with and without the
                mesh (greedy streams equal; TTFT, TPOT p50, flash
                launches), a mamba2-780m prefill batch through
                ``ssd_sharded`` (logits bit for bit; B4 launches), a
                moonshot prefill batch through ``_moe_ep`` at its served
                depth (logits bit for bit; run inside ``moe``, its peak
                memory apart from the ``moe`` line's), the ladder's
                DDP+mixed rung of qwen2-0.5b with the model axis (the first
                loss bit for bit; later losses, gradient norms, step 0's
                gradients and parameters as ``TP_RUNG_*`` say; step p50,
                B2 launches, collectives a step per axis; run inside
                ``ladder_phase``), B1 on K/V repeated to H against GQA
                (what ``sharded_flash``'s repeat costs), the bytes a rank
                holds at ``model`` = 2 / 4 / 8 from the specs
                (arithmetic), and the rehearsal's TP / EP checks; then
                (f) recurrentgemma-2b whole served by the dense
                ``ServeEngine`` in turns with and without the mesh
                (streams equal; TTFT, TPOT p50, B5 and windowed B1
                launches), (g) its DDP+mixed step with the model axis
                (warm-up + 3 steps) bit for bit with the data-only mesh's
                step on K/V repeated to H, and against the data-only
                mesh's own step as ``TP_HYB_*`` say (B5, RG-LRU backward
                and B2 launches), (h) llama3.2-3b
                through the paged ``AsyncServeEngine`` with heads over the
                axis against none (streams equal; B3 launches, TPOT),
                (i) each kernel at the per-rank shapes a wider axis
                launches (against its plain version, timed, with its
                bound; rows ``*_model<tp>`` of the ``kernels`` line, 0
                launches: no path of one card runs them), (j) moonshot's
                4-layer step on a one-rank data-only mesh (MoE in the
                global batch's order, the per-expert counts gathered once
                a layer and forward pass) bit for bit with the no-mesh
                step (run inside ``moe``), and recurrentgemma's bytes a
                rank at ``model`` = 2 / 4 / 8 / 16; ``phase_s``;
  summary       the run's elapsed seconds, the kernels' build included;
  kernels       the per-kernel summary line, launches counted on the served
                and trained runs above (the attention kernels have a row per
                head dim: llama's D = 128, stablelm's D = 160,
                recurrentgemma's D = 256 and, for B2, bert-base's
                bidirectional D = 64, ``*_bert``; moonshot's D = 128 at
                G = 1 and scout's at G = 5, ``*_moonshot`` / ``*_scout``;
                the SSD one for the
                served and one
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

import concurrent.futures
import copy
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.configs.base import (ATTN, ATTN_LOCAL,        # noqa: E402
                                      RGLRU, SSM, PolicyConfig,
                                      ShapeConfig)
from repro_torch.cluster import (ClusterSimulator, FaultPlan,  # noqa: E402
                                 FaultSpec, Job, Scheduler, TraceConfig)
from repro_torch.cluster.recomposer import RecomposeConfig    # noqa: E402
from repro_torch.cluster.simulator import DEFAULT_TEMPLATES   # noqa: E402
from repro_torch.cluster.telemetry import ServingStats        # noqa: E402
from repro_torch import tracking                               # noqa: E402
from repro_torch.core import compose as compose_mod            # noqa: E402
from repro_torch.core import costmodel                         # noqa: E402
from repro_torch.core import hierarchy                         # noqa: E402
from repro_torch.core import policy as policy_mod              # noqa: E402
from repro_torch.core.recommend import recommend               # noqa: E402
from repro_torch.core.topology import (ChipSpec, DEFAULT_LINKS,  # noqa: E402
                                       LinkClass, make_pool)
from repro_torch.data import SyntheticDataset                  # noqa: E402
from repro_torch.kernels import autotune, build, ops           # noqa: E402
from repro_torch.kernels import registry as kernel_registry    # noqa: E402
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
    PIECE_TOKENS, paged_attention_plain, paged_decode_attention,
    split_pieces)
from repro_torch.kernels.rglru import (                        # noqa: E402
    CHUNK as rglru_chunk_len, rglru, rglru_bwd, rglru_bwd_plain, rglru_plain)
from repro_torch.kernels.ssd import (                          # noqa: E402
    CHUNK, KERNEL_CHUNK as SSD_KERNEL_CHUNK, bwd_design as ssd_bwd_design,
    bwd_slices as ssd_bwd_slices,
    design as ssd_design, kernel_chunk, ssd, ssd_bwd, ssd_bwd_plain,
    ssd_plain)
from repro_torch.configs.paper_bench import (                  # noqa: E402
    MOBILENETV2, PAPER_WORKLOADS, RESNET50, YOLOV5L)
from repro_torch.models import attention as attention_mod      # noqa: E402
from repro_torch.models import bert, vision                    # noqa: E402
from repro_torch.models import layers as layers_mod            # noqa: E402
from repro_torch.models import moe as moe_mod                  # noqa: E402
from repro_torch.models.lm import LM                           # noqa: E402
from repro_torch.models.ssm import ssd_decode_step             # noqa: E402
from repro_torch.launch import rehearse                        # noqa: E402
from repro_torch.launch.mesh import (make_mesh,                # noqa: E402
                                     make_production_mesh, one_rank)
from repro_torch.optim import (AdamWConfig, ScheduleConfig,    # noqa: E402
                               compress, global_norm)
from repro_torch.serve import AsyncServeEngine, ServeRequest   # noqa: E402
from repro_torch.serve.engine import (Request, ServeEngine,     # noqa: E402
                                      make_decode_step, make_prefill_step)
from repro_torch.models.transformer import ParallelCtx         # noqa: E402
from repro_torch.train import checkpoint, elastic, trainer    # noqa: E402

# published peaks of one H100 SXM (dense): what the bounds are stated
# against; the HBM rate and the bf16 peak are the port's ``ChipSpec``'s (its
# ``core.topology``: the data sheet's figures), fp32 has no field there
CHIP = ChipSpec()
HBM_BYTES_PER_S = CHIP.hbm_bw
PEAK_FLOPS = {torch.bfloat16: CHIP.peak_flops_bf16, torch.float32: 67e12}

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


# GPU clock cycles (~20 ms) the stream spins (``torch.cuda._sleep``) before
# a timed replay: the host enqueues the start event, the replay and the end
# event while the device is still busy, so a host thread descheduled in
# between (the rehearsal's ranks share the host's cores) adds no idle gap to
# the span the events time
PREROLL_CYCLES = 40_000_000


def time_ms(calls, iters: int) -> float:
    """Mean device milliseconds of one call: ``iters`` rounds over the
    closures in ``calls`` (several closures over different buffers keep a
    bandwidth-bound kernel's inputs out of the L2 cache), timed with CUDA
    events after a warm-up, behind a ``PREROLL_CYCLES`` spin."""
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
    torch.cuda._sleep(PREROLL_CYCLES)
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
    # BERT's bidirectional MHA at D = 64 (bf16, the warpgroup design):
    # ragged S over several 128-row and 128-key tiles, 12 heads of a group
    # of one
    (2, 200, 200, 12, 12, 64, False, 0, torch.bfloat16),
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


# every piece length the autotuner can choose (``autotune.candidates_for``
# at page 16: 1-16 pages); a page above one piece's tokens makes it one page
PIECE_LENGTHS = (16, 32, 64, 128, 256)


def paged_cases(gen):
    """Each case in fp32 and bf16, soft-cap 0 and 30, at every piece length
    of ``PIECE_LENGTHS``: one row each (the largest error over the lengths);
    zero-length rows exactly zero.  Then slots past ``lengths[b]``, poisoned
    with NaN, must change nothing at any piece length."""
    rows = []
    for (B, T, D, G, K, ps, lengths) in PAGED_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, tabs, lens = _paged_inputs(gen, B, T, D, G, K, ps,
                                                  lengths, dt)
            for softcap in (0.0, 30.0):
                want = paged_attention_plain(q, kp, vp, tabs[0], lens,
                                             softcap=softcap)
                tol = _tol(dt, 1e-5)
                err = 0.0
                for tokens in PIECE_LENGTHS:
                    got = paged_decode_attention(q, kp, vp, tabs[0], lens,
                                                 softcap=softcap,
                                                 block_k=tokens)
                    torch.cuda.synchronize()
                    what = f"paged_decode_attention " \
                           f"{(B, T, D, G, K, ps, lengths)} {dt} " \
                           f"softcap={softcap} block_k={tokens}"
                    err = max(err, _err(got, want, tol, what))
                    for b, n in enumerate(lengths):
                        if n == 0:
                            check(bool((got[b] == 0).all()),
                                  f"{what}: zero-length row is not zero")
                rows.append({"shape": [B, T, D, G, K, ps],
                             "lengths": lengths, "softcap": softcap,
                             "dtype": str(dt), "tol": tol,
                             "piece_tokens": list(PIECE_LENGTHS),
                             "max_abs_err": err})
    # slots at or past lengths[b] are never read: poison them with NaN
    B, T, D, G, K, ps, lengths = 3, 512, 160, 4, 2, 16, [300, 17, 0]
    q, kp, vp, tabs, lens = _paged_inputs(gen, B, T, D, G, K, ps, lengths,
                                          torch.float32)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[-1] = vp2[-1] = float("nan")
    tab = tabs[0].cpu()
    for b, n in enumerate(lengths):
        for t in range(n, T):
            kp2[tab[b, t // ps], t % ps] = float("nan")
            vp2[tab[b, t // ps], t % ps] = float("nan")
    for tokens in PIECE_LENGTHS:
        clean = paged_decode_attention(q, kp, vp, tabs[0], lens,
                                       block_k=tokens)
        dirty = paged_decode_attention(q, kp2, vp2, tabs[0], lens,
                                       block_k=tokens)
        check(bool(torch.equal(clean, dirty)),
              f"paged_decode_attention read a slot past lengths[b] at "
              f"block_k={tokens}")
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
    # BERT's bidirectional MHA at D = 64: ragged S (bert-base's 12 heads),
    # and bert-large's 16 heads at its 384 tokens
    (2, 200, 200, 12, 12, 64, False, 0, torch.bfloat16),
    (1, 384, 384, 16, 16, 64, False, 0, torch.bfloat16),
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


def _library_bwd_ms(q, k, v, do, iters, rounds=5, window=0, causal=True):
    """The backward of ``scaled_dot_product_attention`` (dq, dk and dv in
    one call; causal or not, under ``window`` as a boolean mask where it is
    given) through ``torch.autograd.grad``, timed with CUDA events around
    ``iters`` eager calls, in ``rounds`` rounds (autograd's backward is not
    graph-captured here, and one round's time spread 1.2-2.7 ms between
    calls): the median and the minimum of the rounds' means."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    mask = dict(is_causal=causal) if window == 0 else dict(
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


def bwd_main_shape(gen, cfg, B, S, window=0, causal=True):
    """The trained model's attention at B x S tokens: its heads and head_dim,
    bf16, causal under ``window`` (llama3.2-3b: 24 heads over 8 KV heads of
    128; stablelm-12b: 32 over 8 of 160; recurrentgemma-2b: 10 over 1 of
    256, window 2048), or bidirectional (``causal=False``: bert-base, 12
    heads of 64, every (query, key) pair live).  Faults planted in the
    plain backward's result must fail the comparison: a skipped 64- or
    128-key tile; at D = 160 and 256 a dropped tail panel of o, dq, dk and
    dv; at D = 256 a lost column half of dq, dk and dv, tiles skipped under
    the window and a head slice's dK/dV partial dropped or doubled.  At
    D = 256 two calls must also be bit-identical."""
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    q, k, v, do = _bwd_inputs(gen, B, S, S, H, K, D, dt)
    kw = dict(causal=causal, window=window, softcap=0.0)
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
            if H > K:       # a group's heads are walked in slices
                faults["slice_partials"] = _slice_partial_faults(
                    q, k, v, do, stats, grads, window)
        del o2, grads
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * q.element_size()
    row_bytes = m.numel() * 4                  # one fp32 per query row
    # live (query, key) pairs
    pairs = H * B * _live_pairs(S, S, causal, window)
    shape = {"arch": cfg.name, "shape": [B, S, S, H, K, D], "dtype": str(dt),
             "causal": causal, "window": window, "tol": 2e-2}

    fwd = dict(shape, max_abs_err=ef, design=design(D, dt), **_bound(
        qkv_bytes + q.numel() * 2 + 2 * row_bytes, 4 * D * pairs, dt))

    fwd["ms"] = time_ms([lambda: flash_attention_fwd_stats(q, k, v, **kw)],
                        5)
    fwd["plain_ms"] = time_ms(
        [lambda: attention_fwd_stats_plain(q, k, v, **kw)], 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = dict(is_causal=causal) if window == 0 else dict(
        attn_mask=_window_mask(S, S, window))
    fwd["library_ms"] = time_ms(
        [lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask)], 5)

    # backward: q, k, v, dO and three row statistics read; dk, dv or dq
    # written (in the inputs' dtype)
    bwd_in = qkv_bytes + do.numel() * 2 + 3 * row_bytes
    library_ms, library_min = _library_bwd_ms(q, k, v, do, 5, window=window,
                                              causal=causal)
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


def rglru_main_shape(gen, shape=RGLRU_SERVED):
    """The served prefill (or ``shape``: a rank's channels of it); two
    input sets in turn keep a launch's inputs (84 MB served) out of L2."""
    B, S, W = shape
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
    return rows, rglru_bwd_main_shape(gen)


def rglru_bwd_main_shape(gen, shape=RGLRU_TRAINED):
    """rglru_bwd at the trained shape (or ``shape``: a rank's channels of
    it) against its plain reverse scan, the saved forward held to
    rglru_plain first, with a planted fault (the carry into chunk 1
    zeroed) that must fail the same comparison; timed, with its bound."""
    B, S, W = shape
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
                   f"rglru {(B, S, W)} (saved forward)")
    del gated
    got = rglru_bwd(la, hs, dy)
    torch.cuda.synchronize()
    want = rglru_bwd_plain(la, hs, dy)
    errs = _rel_errs(got, want, f"rglru_bwd {(B, S, W)}")
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
    return dict({"shape": [B, S, W], "dtype": "torch.float32",
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


def flash_d256_main_shape(gen, shape=ATTN_SERVED):
    """recurrentgemma-2b's local attention over a 4096-token prefill: q
    (1,4096,10,256), k/v (1,4096,1,256) bf16, causal, window 2048 (or
    ``shape``: a rank's heads of it).  A dropped last panel of o and a key
    tile skipped under the window must be rejected."""
    B, S, T, H, K, D, causal, window, dt = shape
    q = _randn(gen, B, S, H, D, dtype=dt)
    k = _randn(gen, B, T, K, D, dtype=dt)
    v = _randn(gen, B, T, K, D, dtype=dt)
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, **kw)
    what = f"flash_attention D=256 {(B, S, T, H, K, D)}"
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


PAGED_LENS = np.linspace(128, 1024, 16).astype(int).tolist()
PAGED_MAX_NEW = 64


def _paged_prompts(cfg):
    """``serve_paged``'s 16 prompts of ``PAGED_LENS`` tokens; 0, 5, 10 and
    15 share a 256-token prefix."""
    shared = _prompt(999, 256, cfg.vocab_size)
    prompts = []
    for i, n in enumerate(PAGED_LENS):
        if i % 5 == 0:
            prompts.append(shared + _prompt(i, max(n, 320) - 256,
                                            cfg.vocab_size))
        else:
            prompts.append(_prompt(i, n, cfg.vocab_size))
    return prompts


def _warm_splits(eng):
    """``eng.warmup()``, recording after each decode graph's capture the
    paged wrapper's ``last_split`` (pages a piece, pieces): what that graph
    replays.  Returns {decode key: split}."""
    splits = {}
    prepare = eng.graphs.prepare

    def spy(key, fn, arrays, capture=True):
        prepare(key, fn, arrays, capture=capture)
        if key[0] == "decode":
            splits[key] = paged_decode_attention.last_split
    eng.graphs.prepare = spy
    try:
        eng.warmup()
    finally:
        del eng.graphs.prepare
    return splits


def serve_paged(cfg, model, policy, tracker=None):
    """Returns the paged launches, the engine (for ``graphs_paged``) and the
    split of each captured decode graph (for ``tune_phase``)."""
    eng = AsyncServeEngine(cfg, model, policy, device=DEV, tracker=tracker,
                           **PAGED_KW)
    splits = _warm_splits(eng)
    lens = PAGED_LENS
    reqs = [ServeRequest(i, p, max_new=PAGED_MAX_NEW)
            for i, p in enumerate(_paged_prompts(cfg))]
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
    check(all(len(r.out) == PAGED_MAX_NEW
              and all(0 <= t < cfg.padded_vocab for t in r.out)
              for r in reqs),
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
         requests=len(reqs), served=served, prompt_lens=lens,
         max_new=PAGED_MAX_NEW,
         wall_s=wall, decode_iterations=rep["decode_iterations"],
         paged_kernel_launches=n_paged, hit_rate=hit,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         memory_reserved=torch.cuda.memory_reserved(), **_latency(rep))
    return n_paged, eng, splits


def serve_dense(cfg, model, policy):
    """Returns the flash launches and the engine."""
    eng = AsyncServeEngine(cfg, model, policy, mode="dense", n_slots=4,
                           max_seq=2048, device=DEV)
    eng.warmup()
    lens = [300, 500, 1100, 1500]           # pow2 buckets 512, 512, 2048, 2048
    reqs = [ServeRequest(i, _prompt(100 + i, n, cfg.vocab_size), max_new=16)
            for i, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
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
         flash_kernel_launches=n_flash,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         memory_reserved=torch.cuda.memory_reserved(), **_latency(rep))
    return n_flash, eng


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
    logits, routes = {}, {}
    for impl in ("kernel", "full"):
        logits[impl], routes[impl] = _decode_logits(cfg, model, impl,
                                                    "bfloat16")
    scale = float(logits["full"].abs().max())
    err = float((logits["kernel"] - logits["full"]).abs().max())
    check(bool(torch.isfinite(logits["kernel"]).all()),
          "parity: non-finite bf16 logits")
    check(logits["kernel"].shape == (1, cfg.padded_vocab),
          "parity: logits have the wrong shape")
    if cfg.moe is None:
        check(err <= 2e-2 * scale, f"parity: bf16 decode logits differ by "
                                   f"{err} (> 2e-2 x max-abs {scale})")
        extra = {"tol_rel": 2e-2}
    else:
        # top-k routes flip with bf16 rounding and the flips compound over
        # 48 layers: reported only; ``parity_moe`` holds the logits in fp32
        # at a depth cut, and measures the plain path's own bf16 spread
        extra = {"checked": False, "routes_equal_share": _route_share(
            routes["kernel"], routes["full"])}
    emit("parity", arch=cfg.name, fp32_streams_equal=equal,
         bf16_decode_logits_max_abs=scale,
         bf16_decode_logits_max_abs_err=err, **extra)


# moonshot's logits at this depth cut fit one card in fp32 (10.1 B
# parameters, 40 GB)
MOE_PARITY_LAYERS = 16


def parity_moe(cfg, n_layers=MOE_PARITY_LAYERS):
    """One decode step's logits after a 200-token prompt through the paged
    engine, ``cfg`` cut to ``n_layers`` with random fp32 weights: kernels
    against the plain versions in fp32 within 2e-4 of max-abs, and, as
    numbers only, the plain path in bf16 against itself in fp32 (the
    rounding alone) and the kernels against the plain path both in bf16;
    each with the share of (token, layer) routes the two runs agree on."""
    small = cut_depth(cfg, n_layers)
    model = LM.init(small, seed=0, dtype=torch.float32, device=DEV)
    runs = {}
    # the bf16 runs cast the weights in place (the engine's cast_weights_):
    # they come last
    for impl, dt in (("kernel", "float32"), ("full", "float32"),
                     ("full", "bfloat16"), ("kernel", "bfloat16")):
        runs[impl, dt] = _decode_logits(small, model, impl, dt)
    del model

    def compare(a, b):
        (la, ra), (lb, rb) = runs[a], runs[b]
        check(bool(torch.isfinite(la).all()), f"parity_moe: {a} non-finite")
        scale = float(lb.abs().max())
        return {"max_abs": scale, "max_abs_err": float((la - lb).abs().max()),
                "routes_equal_share": _route_share(ra, rb)}

    fp32 = compare(("kernel", "float32"), ("full", "float32"))
    check(fp32["max_abs_err"] <= 2e-4 * fp32["max_abs"],
          f"parity_moe: fp32 decode logits differ {fp32} (> 2e-4 x max-abs)")
    emit("parity_moe", arch=cfg.name, n_layers=n_layers,
         cut=f"depth {cfg.n_layers} -> {n_layers} layers (fp32 at full depth, "
             f"{cfg.param_count() * 4 / 1e9:.1f} GB, does not fit one card)",
         fp32_kernel_vs_plain=dict(fp32, tol_rel=2e-4),
         bf16_plain_vs_fp32_plain=compare(("full", "bfloat16"),
                                          ("full", "float32")),
         bf16_kernel_vs_bf16_plain=compare(("kernel", "bfloat16"),
                                           ("full", "bfloat16")))


def _decode_logits(cfg, model, impl, dtype):
    """(logits of one decode step after a 200-token prompt through the
    paged engine, the routes of every MoE call on the way).  With MoE the
    engine runs eagerly, so that every step calls the router where the
    routes are recorded."""
    policy = PolicyConfig(compute_dtype=dtype, remat="none", attn_impl=impl)
    eng = AsyncServeEngine(cfg, model, policy, mode="paged", n_slots=2,
                           max_seq=512, page_size=16, prefill_chunk=256,
                           graphs=cfg.moe is None, device=DEV)
    req = ServeRequest(0, _prompt(300, 200, cfg.vocab_size), max_new=4)
    eng.submit(req)
    with _RouteLog() as log:
        while not (req.state == "decode" and req.out):
            eng.step()
        _, lg = eng._run_paged(
            [req], [[req.out[-1]]], [[req.prompt_len + len(req.out) - 1]],
            [[True]], [0])
    return lg.float(), log.idx


class _RouteLog:
    """While open, records the experts (sorted per token) that every
    ``moe.route`` call chooses, in call order."""

    def __enter__(self):
        self.idx, self._route = [], moe_mod.route

        def route(x2d, router_w, top_k, dp_group=None):
            out = self._route(x2d, router_w, top_k, dp_group=dp_group)
            self.idx.append(out[1].detach().sort(dim=-1).values)
            return out

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route


def _route_share(a, b):
    """Share of (token, layer) routes that two runs' logs agree on: a
    token's set of experts in one call."""
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)),
          "routes: the two runs made different MoE calls")
    same = sum(int((x == y).all(dim=-1).sum()) for x, y in zip(a, b))
    total = sum(x.shape[0] for x in a)
    return same / total if total else None


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


# ---------------------------------------------------------------------------
# the kernel registry and autotuner on the card
# ---------------------------------------------------------------------------
# (engine, round) in the order served: each engine serves serve_paged's
# prompts twice, in turns
TUNE_TURNS = ("tuned", "default", "default", "tuned")
# the piece length forced where the sweep keeps the default everywhere
TUNE_FORCED_TOKENS = 64
# the row-length sets a swept decode cell of the served engine is timed on:
# up to this many of the replays that serve_paged's prompts make at its key
TUNE_LENGTH_SETS = 8
# recommend's ranking with and without the sweep's calibration
TUNE_RECOMMEND = (("llama3.2-3b", "train_4k"), ("llama3.2-3b", "decode_32k"),
                  ("recurrentgemma-2b", "prefill_32k"))


def _decode_cell(cfg, key):
    """The autotuner's cell of a paged decode step key ("decode", rows,
    table pages, 1) of ``cfg``'s engine."""
    _, B, P, _ = key
    ps = PAGED_KW["page_size"]
    return autotune.decode_case(B=B, T=P * ps, D=cfg.head_dim,
                                G=cfg.n_heads // cfg.n_kv_heads,
                                page_size=ps, dtype="bfloat16",
                                kv_heads=cfg.n_kv_heads)


def _served_lengths(eng, prompts):
    """One untuned round of ``prompts`` on ``eng``, recording each paged
    decode step's row lengths (``_paged_step``'s: position + 1 on a live
    row, 0 on a padding row) by step key.  Returns {key: the lengths of up
    to ``TUNE_LENGTH_SETS`` of its replays, evenly spaced}."""
    seen = {}
    run = eng.graphs.run

    def spy(key, fn, arrays, capture=True):
        if key[0] == "decode":
            live = arrays["valid"][:, 0] != 0
            seen.setdefault(key, []).append(tuple(
                np.where(live, arrays["positions"][:, 0] + 1, 0).tolist()))
        return run(key, fn, arrays, capture=capture)
    eng.graphs.run = spy
    try:
        _round(eng, prompts, PAGED_MAX_NEW, "tune lengths")
    finally:
        del eng.graphs.run
    out = {}
    for key, sets in seen.items():
        n = min(TUNE_LENGTH_SETS, len(sets))
        out[key] = tuple(sets[i * len(sets) // n] for i in range(n))
    return out


def _want_split(cfg, key, registry):
    """(pages a piece, pieces) that the dispatch gives ``key``'s decode step
    under ``registry`` (None: untuned, ``PIECE_TOKENS``)."""
    P, ps = key[2], PAGED_KW["page_size"]
    if registry is None:
        return split_pieces(P, ps)
    kernel_registry.set_registry(registry)
    try:
        tokens = autotune.resolve(_decode_cell(cfg, key))["block_k"]
    finally:
        kernel_registry.reset_registry()
    return split_pieces(P, ps, tokens)


def _tuned_engine(cfg, model, policy, registry, keys, what):
    """A paged engine warmed up under ``registry``: each decode graph must
    have captured the piece length the registry gives its cell."""
    kernel_registry.set_registry(registry)
    try:
        eng = AsyncServeEngine(cfg, model, policy, device=DEV, **PAGED_KW)
        splits = _warm_splits(eng)
    finally:
        kernel_registry.reset_registry()
    check(sorted(splits) == keys, f"{what}: decode graphs {sorted(splits)} "
                                  f"!= the default engine's {keys}")
    for key in keys:
        want = _want_split(cfg, key, registry)
        check(splits[key] == want, f"{what}: the decode graph {key} "
                                   f"launched (pages, pieces) {splits[key]}, "
                                   f"the registry gives {want}")
    return eng, splits


def _tune_round(cfg, eng, registry, prompts, what):
    """``_round`` with ``registry`` installed; the paged launches must equal
    the pure-decode iterations x layers."""
    before = eng.report()["decode_iterations"]
    kernel_registry.set_registry(registry)
    try:
        r = _round(eng, prompts, PAGED_MAX_NEW, what)
    finally:
        kernel_registry.reset_registry()
    iters = eng.report()["decode_iterations"] - before
    n = r["launches"]["paged_decode_attention"]
    check(n > 0 and n == iters * cfg.n_layers,
          f"{what}: paged decode launches {n} != pure-decode iterations x "
          f"layers = {iters} x {cfg.n_layers}")
    return dict(r, decode_iterations=iters, paged_kernel_launches=n)


def _same_share(a, b):
    """Share of greedy tokens of streams ``a`` equal to ``b``'s, position
    by position."""
    n = sum(len(x) for x in a)
    return sum(int(u == v) for x, y in zip(a, b) for u, v in zip(x, y)) / n


def _knob(blocks):
    """The one knob a cell varies: tokens a piece, steps a chunk, the SSD
    chunk, or the flash tile as "BQxBK"."""
    for k in ("block_seq", "chunk"):
        if k in blocks:
            return blocks[k]
    if blocks.get("block_q") == 1:
        return blocks["block_k"]
    return f"{blocks['block_q']}x{blocks['block_k']}"


def tune_phase(cfg, model, policy, eng, splits):
    """The ``tune`` line, while ``cfg``'s full-width model is on the card:
    (a) ``autotune.sweep`` of ``DEFAULT_CASES`` (every candidate held to
    the plain version, then timed), each decode cell of ``eng``'s steps
    timed on the row lengths that an untuned round of ``serve_paged``'s
    prompts replays at its key (``_served_lengths``); every decode graph of
    ``eng``
    (``serve_paged``'s engine, untuned) has its cell and launched 128-token
    pieces, and every cell resolves to its winner at dispatch; (b) a second
    paged engine built under the swept registry, whose decode graphs must
    each launch the registry's piece length, serves ``serve_paged``'s
    prompts once to warm its prefix cache, then in turns with ``eng``
    (``TUNE_TURNS``; both TPOT p50s, launches
    = pure-decode iterations x layers, the share of greedy tokens equal to
    the untuned run's); where the sweep keeps 128 tokens at every cell of
    the engine, a registry forcing ``TUNE_FORCED_TOKENS`` serves once too;
    (c) the sweep's ``CalibratedCost.from_registry`` and ``recommend``'s top
    candidate with and without it.  Every later phase runs untuned."""
    t0 = time.perf_counter()
    ps = PAGED_KW["page_size"]
    check(kernel_chunk() == SSD_KERNEL_CHUNK,
          f"ssd.KERNEL_CHUNK {SSD_KERNEL_CHUNK} != the library's "
          f"{kernel_chunk()}")
    prompts = _paged_prompts(cfg)
    served = {_decode_cell(cfg, k): v
              for k, v in _served_lengths(eng, prompts).items()}
    missing = set(served) - set(autotune.DEFAULT_CASES)
    check(not missing, f"tune: served decode keys without a cell: "
                       f"{sorted(c.label() for c in missing)}")
    cases = [dataclasses.replace(c, lengths=served[c]) if c in served else c
             for c in autotune.DEFAULT_CASES]
    record_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        reg, results = autotune.sweep(
            cases, device=DEV, merge=False,
            path=os.path.join(tmp, "tuned_configs.json"))
    finally:
        kernel_registry.reset_registry()    # the sweep installs its winners
        shutil.rmtree(tmp, ignore_errors=True)
    sweep_s = time.perf_counter() - t0 - record_s
    cells = []
    for r in results:
        js = r.to_json()
        c = r.case
        sets = c.lengths or ((autotune.served_lengths(c.batch, c.dim("t")),)
                             if c.kernel == "decode_attention" else ())
        cells.append({
            "key": js["key"], "batch": c.batch, "kv_heads": c.kv_heads,
            **({"lengths": {"from": "served" if c.lengths else "rule",
                            "sets": len(sets),
                            "live_rows": [sum(n > 0 for n in ls)
                                          for ls in sets],
                            "tokens": [min(min(ls) for ls in sets),
                                       max(max(ls) for ls in sets)]}}
               if sets else {}),
            "candidates_us": [[_knob(c["blocks"]), c["us"]]
                              for c in js["candidates"]],
            "default": _knob(js["default"]), "default_us": js["default_us"],
            "best": _knob(js["best"]), "us": js["us"],
            "speedup": js["speedup"],
            "max_abs_err": max(c["max_abs_err"] for c in js["candidates"]),
            "rel_fro_max": max((e["rel_fro"] for c in js["candidates"]
                                for e in c.get("scaled", ())),
                               default=None)})
    # each cell resolves at dispatch to its key's entry, unfitted (cells of
    # one bucket share a key: T = 16 and 32 tokens, the RG-LRU's batches 1
    # and 2; the last one swept wrote it)
    kernel_registry.set_registry(reg)
    try:
        for c in cases:
            got = autotune.resolve(c)
            check(got == reg.get(c.key).blocks,
                  f"tune: {c.label()} resolves to {got}; the registry holds "
                  f"{reg.get(c.key).blocks}")
    finally:
        kernel_registry.reset_registry()

    keys = sorted(splits)
    check(len(keys) > 0, "tune: serve_paged's engine captured no decode "
                         "graph")
    for key in keys:
        check(reg.get(_decode_cell(cfg, key).key) is not None,
              f"tune: the swept cells miss the decode graph {key}")
        check(splits[key] == _want_split(cfg, key, None)
              and splits[key][0] * ps == PIECE_TOKENS,
              f"tune: the untuned decode graph {key} launched "
              f"{splits[key]}, not {PIECE_TOKENS}-token pieces")
    tuned, tuned_splits = _tuned_engine(cfg, model, policy, reg, keys,
                                        "tune")
    # ``eng`` served these prompts in serve_paged: the tuned engine serves
    # them once too, so that both hold the same prefixes when the turns
    # begin (a cold round's prefills interleave its decode steps: TPOT p50
    # 0.0126 s against 0.0065 s warm on the H100, PERF.md §6)
    warm = _tune_round(cfg, tuned, reg, prompts, "tune tuned warm-up")
    engines = {"tuned": (tuned, reg), "default": (eng, None)}
    rounds = {"tuned": [], "default": []}
    for name in TUNE_TURNS:
        e, r_ = engines[name]
        rounds[name].append(_tune_round(cfg, e, r_, prompts,
                                        f"tune {name}"))
    del tuned, engines
    share = [_same_share(t["streams"], d["streams"])
             for t, d in zip(rounds["tuned"], rounds["default"])]
    share_default = _same_share(rounds["default"][0]["streams"],
                                rounds["default"][1]["streams"])
    # piece lengths other than 128 tokens on tables of 128 tokens or more
    full = PIECE_TOKENS // ps

    def other(sp):
        return {str(k): v for k, v in sp.items()
                if k[2] >= full and v[0] * ps != PIECE_TOKENS}

    shown, forced = other(tuned_splits), None
    if not shown:
        forced_reg = kernel_registry.Registry(dict(reg.entries))
        for key in keys:
            cell = _decode_cell(cfg, key)
            blocks = {"block_q": 1, "block_k": TUNE_FORCED_TOKENS}
            if blocks in autotune.candidates_for(cell):
                forced_reg.put(cell.key, kernel_registry.TunedEntry(
                    blocks, backend="forced by chip_smoke.py"))
        e, forced_splits = _tuned_engine(cfg, model, policy, forced_reg,
                                         keys, "tune forced")
        r = _tune_round(cfg, e, forced_reg, prompts, "tune forced")
        del e
        shown = other(forced_splits)
        forced = {"tokens": TUNE_FORCED_TOKENS,
                  "tpot_p50_s": r["tpot_p50_s"],
                  "decode_iterations": r["decode_iterations"],
                  "paged_kernel_launches": r["paged_kernel_launches"],
                  "same_token_share": _same_share(
                      r["streams"], rounds["default"][0]["streams"])}
    check(len(shown) > 0, "tune: no decode graph launched a piece length "
                          "other than the default")
    torch.cuda.empty_cache()

    cal = costmodel.CalibratedCost.from_registry(reg)
    ranked = {}
    for arch, shape in TUNE_RECOMMEND:
        a = recommend(arch, shape, top=1)[0]
        b = recommend(arch, shape, top=1, calibration=cal)[0]
        ranked[f"{arch}|{shape}"] = {
            "untuned": {"mesh": a.label, "step_s": a.step_s},
            "calibrated": {"mesh": b.label, "step_s": b.step_s}}
    for r_ in rounds["tuned"] + rounds["default"] + [warm]:
        del r_["streams"]
        del r_["launches"]
    emit("tune", arch=cfg.name, card=nvidia_smi_line(),
         cells=cells, n_cells=len(cells),
         n_candidates=sum(len(c["candidates_us"]) for c in cells),
         served_keys=len(served), record_s=record_s, sweep_s=sweep_s,
         served={"turns": TUNE_TURNS, "rounds": rounds, "warm_up": warm,
                 "tpot_p50_s": {n: [r_["tpot_p50_s"] for r_ in rounds[n]]
                                for n in rounds},
                 "same_token_share": share,
                 "same_token_share_default_rounds": share_default,
                 "decode_graphs": len(keys),
                 "tuned_splits": {str(k): tuned_splits[k] for k in keys},
                 "non_default_splits": shown, "forced": forced},
         calibration=cal.kernel_speedup, recommend=ranked,
         phase_s=time.perf_counter() - t0)


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
    """6 * N * tokens for the weight products (``n_params``: the weights
    that take part in products, without the input lookup tables), plus the
    attention blocks' products (QK^T and PV: 4 * D flops per live (query,
    key) pair and head forward, twice that backward; causal unless the model
    is not, under the window in a local block); activation recompute not
    counted."""
    B, S = shape.global_batch, shape.seq_len
    pairs = sum(B * cfg.n_heads * _live_pairs(
        S, S, cfg.causal, cfg.local_window if blk == ATTN_LOCAL else 0)
        for blk in cfg.pattern if blk in (ATTN, ATTN_LOCAL))
    return 6 * n_params * B * S + 12 * cfg.head_dim * pairs


KINDS = (("attention_kernels", ("flash_fwd", "flash_bwd", "paged_")),
         ("ssd_bwd_kernels", ("ssd_bwd_",)),
         ("ssd_kernels", ("ssd_state", "ssd_pass", "ssd_output")),
         ("rglru_kernels", ("rglru_",)),
         # cuDNN's and PyTorch's batch norm, then cuDNN's convolutions, the
         # complex-fp32 (cf32) GEMMs of its FFT convolutions among them (the
         # vision models of ``paper_bench``; no other phase runs either)
         ("batch_norm", ("batch_norm", "bn_fw", "bn_bw")),
         ("conv", ("conv", "fprop", "dgrad", "wgrad", "winograd", "fft",
                   "cf32", "cudnn")),
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


# every ``train`` run's model, shape, step p50 and losses, in order: what
# the ``composable`` phase prices (llama3.2-3b's is the ``tracking`` line's)
TRAINED = []


def train(cfg, shape=TRAIN_SHAPE, steps=TRAIN_STEPS,
          cuts=("global batch 256 -> 2 (one card)",), full=True,
          leaves=None, split=False, lr=3e-4, tracker=None):
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
    of the fp32 reference's.  With MoE blocks the reference pass is fp32
    too (top-k routing flips with bf16 rounding), the gradients compared
    are kept on the host, and the share of (token, layer) routes the two
    fp32 passes agree on is reported.  ``full``: the loss must fall, and
    one more step is profiled; else (a depth cut, two steps) only the
    launches and the first step's parity are held.  ``split``: one more
    step under ``_moe_split``.  ``tracker``: a tracking run that a
    ``StepTracker`` logs each step to."""
    t_start = time.perf_counter()
    L = cfg.n_layers
    leaves = leaves or ATTN_LEAVES
    n_attn = sum(blk in (ATTN, ATTN_LOCAL) for blk in cfg.pattern)
    n_rec = cfg.pattern.count(RGLRU)
    n_ssm = cfg.pattern.count(SSM)
    optcfg = AdamWConfig(lr=lr)
    # Adam's first updates move every weight by about lr * sign(g): from
    # this random init the loss rises for two steps at any lr >= 1.5e-4 and
    # falls again as the cosine decays (PERF.md, the training findings); with
    # the one warm-up step at lr 0 it ends below where it started
    sched = ScheduleConfig(kind="cosine", peak_lr=lr, warmup_steps=1,
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
    routes = None
    if n_ssm or cfg.moe is not None:
        fp32 = dataclasses.replace(TRAIN_POLICY, compute_dtype="float32")
        tol, ref_dtype = 5e-4, "float32"
        with _RouteLog() as plain_routes:
            grads, full_loss = _grads(state.model, dataclasses.replace(
                plain, compute_dtype="float32"), batches[0])
        plain32 = _pick(grads, leaves)
        if cfg.moe is not None:      # every leaf: kept on the host
            plain32 = {n: g.cpu() for n, g in plain32.items()}
        del grads
        with _RouteLog() as kernel_routes:
            grads, loss32 = _grads(state.model, fp32, batches[0])
        check(abs(loss32 - full_loss) <= tol * abs(full_loss),
              f"train: fp32 first loss {loss32} vs {full_loss} through the "
              f"plain versions (> {tol})")
        attn_err = _leaf_errs(_pick(grads, leaves), plain32, tol,
                              "train: fp32 first step vs the plain versions")
        if cfg.moe is not None:
            routes = _route_share(kernel_routes.idx, plain_routes.idx)
            check(routes == 1.0, f"train: the fp32 passes route "
                                 f"{routes} of the tokens alike, not all")
        del grads, plain32, plain_routes, kernel_routes
    else:
        grads, full_loss = _grads(state.model, plain, batches[0])
        full_attn = _pick(grads, leaves)
        del grads
    losses, auxes, norms, lrs, step_s = [], [], [], [], []
    # it reads the metrics after the step's synchronize, outside its time
    stepper = (trainer.StepTracker(shape.tokens, tracker)
               if tracker is not None else None)
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
        auxes.append(float(m["aux"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if stepper is not None:
            stepper.step(i, m)
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
    profile, moe_split = None, None
    t_steps = time.perf_counter()
    if full:
        profile = _profile(lambda: step_fn(state, batches[-1]), "train")
        if split:
            moe_split = _moe_split(lambda: step_fn(state, batches[-1]),
                                   f"train {cfg.name}")
        # a smoke signal only: whether the gradients are right is checked
        # above
        check(losses[-1] < losses[0],
              f"train: loss did not fall over {steps} steps: {losses}")
    p50 = float(np.median(step_s[1:]))      # the first step is warm-up
    if stepper is not None:
        stepper.summary()
    TRAINED.append({"cfg": cfg, "shape": shape, "step_s_p50": p50,
                    "losses": losses})
    tokens = shape.tokens
    # an MoE token passes through its top-k experts, not all of them; the
    # input table's lookup does no products (a tied table is the head's)
    n_active = cfg.active_param_count() if cfg.moe is not None else n_params
    if not cfg.tie_embeddings:
        n_active -= state.model.embed.numel()
    flops = _model_flops_per_step(cfg, n_active, shape)
    emit("train", arch=cfg.name, n_layers=L, params=n_params,
         batch=shape.global_batch, seq=shape.seq_len,
         compute_dtype="bfloat16", param_dtype="float32", remat="block",
         steps=steps, warmup_steps_excluded=1, losses=losses,
         aux_terms=auxes, grad_norms=norms, lrs=lrs, step_s=step_s,
         step_s_p50=p50,
         tokens_per_s=tokens / p50, model_flops_per_step=flops,
         model_flops_per_s=flops / p50,
         model_flops_per_s_over_989_tflops=flops / p50
         / CHIP.peak_flops_bf16,
         launches=counts, designs=designs,
         first_step_vs_plain_attention={
             "loss": [losses[0], full_loss], "leaves": list(leaves),
             "worst_grad_err_over_max_abs": attn_err,
             "tol_rel": tol, "reference_dtype": ref_dtype,
             "routes_equal_share": routes},
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         profiled_step=profile, moe_split=moe_split, cuts=list(cuts),
         phase_s={"init": t_init - t_start, "reference_passes": t_ref - t_init,
                  "steps": t_steps - t_ref,
                  "profile": time.perf_counter() - t_steps})
    del state, step_fn
    torch.cuda.empty_cache()
    return counts


ATTN_LEAVES = ("wq", "wk", "wv")


def _grads(model, policy, batch, loss_fn=None):
    """Gradients by parameter name and loss of one forward and backward
    pass (of ``loss_fn``, by default the LM loss under ``policy``); the
    parameters' ``.grad`` is cleared again."""
    loss_fn = loss_fn or trainer.make_loss_fn(model.cfg, policy)
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
        w = w.to(got[n].device)
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
# the paper's Table II workloads trained
# ---------------------------------------------------------------------------
PAPER_STEPS = 3
VISION_CFGS = {c.name: c for c in (RESNET50, MOBILENETV2, YOLOV5L)}
# bert-base's trained attention (sub-row (e) of the B2 kernels): its batch
# and sequence in PAPER_WORKLOADS, 12 heads of 64, bidirectional
BERT_ARCH = "bert-base"
BERT_TRAINED = next((w.batch_size, w.seq_or_img) for w in PAPER_WORKLOADS
                    if w.name == BERT_ARCH)
# the paper's batch (its global batch over eight GPUs, §V-C-1) on one card,
# but where it does not fit: YOLOv5-L's fp32 step peaks at 75.6 GB with 76
# images of 640 px on the H100 (~0.99 GB an image, PERF.md), so 88 would
# need ~87 GB, more than the card holds; 76 keeps the peak under 90 % of it
PAPER_BATCH_CUT = {"yolov5l": (76, "global batch 88 -> 76 (fp32 "
                                   "activations, ~0.99 GB a 640 px image, "
                                   "do not fit one card at 88)")}
# AdamW as every arch trains (the port's defaults: b2 0.95, weight decay
# 0.1 where ndim >= 2, clip 1.0) at a constant lr: Adam's default 1e-3 for
# the CNNs; BERT's pre-training 1e-4 (arXiv:1810.04805, appendix A.2)
PAPER_LR = {"vision": 1e-3, "nlp": 1e-4}
# the vision models on the card against the same port code on the CPU, at
# batch 2: in float64 both sides within 1e-4 of max-abs (outputs and every
# gradient); the card's float32 outputs within 1e-3 of max-abs of the CPU's
# float64 ones (batch statistics over 8 values a channel: float32 rounding
# alone moves the CPU's own outputs by up to 3.4e-4, YOLOv5-L at 64 px,
# tests/test_torch_vision.py; its gradients by tens of percent,
# tests/test_torch_vision_grads.py, so the float32 gradients are reported,
# not held)
VISION_CHECK_SIZES = {"resnet50": (64, 57), "mobilenetv2": (64, 57),
                      "yolov5l": (64, 96)}
VISION_TOL_FP64 = 1e-4
VISION_TOL_FP32_FWD = 1e-3


def _paper_batch(work, cfg, B, gen):
    """One fixed batch made on the device from ``gen``: images N(0, 1) with
    labels, or YOLO's three N(0, 1) target maps; for BERT tokens, segments
    (a question of 8-63 tokens, then the context), and a span of up to 16
    tokens in the context."""
    n = work.seq_or_img
    if work.domain == "vision":
        out = {"images": torch.randn((B, n, n, 3), generator=gen,
                                     device=DEV)}
        if cfg.arch == "yolov5l":
            out["targets"] = [torch.randn((B, n // s, n // s, 255),
                                          generator=gen, device=DEV)
                              for s in (8, 16, 32)]
        else:
            out["labels"] = torch.randint(0, cfg.num_classes, (B,),
                                          generator=gen, device=DEV)
        return out
    q_len = torch.randint(8, 64, (B, 1), generator=gen, device=DEV)
    start = q_len[:, 0] + (torch.rand((B,), generator=gen, device=DEV)
                           * (n - 16 - q_len[:, 0])).long()
    end = start + torch.randint(0, 16, (B,), generator=gen, device=DEV)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, n),
                                    generator=gen, device=DEV),
            "segments": (torch.arange(n, device=DEV)[None, :]
                         >= q_len).int(), "start": start, "end": end}


def _vision_grads(model, batch):
    """(outputs, gradients by name) of one forward and backward pass; the
    parameters' ``.grad`` is left untouched."""
    out = vision.apply_vision(model, batch["images"])
    loss = vision.vision_loss(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    out = out if isinstance(out, list) else [out]
    return [o.detach() for o in out], dict(zip(names, grads))


def _worst(got, want, floor=0.0):
    """The largest error over max-abs of the tensors of ``want`` against
    ``got`` (on the CPU, float64); a tensor whose max-abs is at most
    ``floor`` is measured against ``floor`` instead."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), floor))
    return worst


def vision_check(model, cfg):
    """``model`` (fp32 on the card) against the same weights on the CPU at
    batch 2 and ``VISION_CHECK_SIZES``: float64 on both sides within
    ``VISION_TOL_FP64`` of max-abs, outputs and gradients (a gradient zero
    by design, at most 1e-9 of the largest, is measured against 1e-9 of the
    largest: MobileNetV2's ``project.bn`` biases); the card's float32
    outputs within ``VISION_TOL_FP32_FWD`` of the CPU's float64 ones."""
    cpu64 = copy.deepcopy(model).to("cpu", torch.float64)
    dev64 = copy.deepcopy(model).double()
    gen = torch.Generator()
    rows = []
    for size in VISION_CHECK_SIZES[cfg.arch]:
        gen.manual_seed(size)
        x = torch.randn((2, size, size, 3), generator=gen,
                        dtype=torch.float64)
        b = {"images": x}
        if cfg.arch == "yolov5l":
            b["targets"] = [torch.randn((2, size // s, size // s, 255),
                                        generator=gen, dtype=torch.float64)
                            for s in (8, 16, 32)]
        else:
            b["labels"] = torch.tensor([1, 2])
        on_dev = {k: [t.to(DEV) for t in v] if isinstance(v, list)
                  else v.to(DEV) for k, v in b.items()}
        on_dev32 = {k: [t.float() for t in v] if isinstance(v, list)
                    else (v.float() if v.is_floating_point() else v)
                    for k, v in on_dev.items()}
        want_out, want_g = _vision_grads(cpu64, b)
        got_out, got_g = _vision_grads(dev64, on_dev)
        out32, g32 = _vision_grads(model, on_dev32)
        floor = 1e-9 * max(float(g.abs().max()) for g in want_g.values())
        names = list(want_g)
        live = [n for n in names if float(want_g[n].abs().max()) > floor]
        row = {"size": size, "batch": 2,
               "fp64_outputs": _worst(got_out, want_out),
               "fp64_grads": _worst([got_g[n] for n in names],
                                    [want_g[n] for n in names], floor),
               "fp32_outputs": _worst(out32, want_out),
               # the leaves that are not zero by design
               "fp32_grads_reported": _worst([g32[n] for n in live],
                                             [want_g[n] for n in live])}
        for key, tol in (("fp64_outputs", VISION_TOL_FP64),
                         ("fp64_grads", VISION_TOL_FP64),
                         ("fp32_outputs", VISION_TOL_FP32_FWD)):
            check(row[key] <= tol, f"paper_bench {cfg.name} at {size} px: "
                                   f"{key} on the card against the CPU "
                                   f"{row[key]} (> {tol} of max-abs)")
        rows.append(row)
    del cpu64, dev64
    return rows


def _vision_flops(model, n, B):
    """3 x the convs' and fc's 2 x MACs of one forward at ``n`` px
    (``FlopCounterMode`` over a forward at batch 2, times ``B / 2``):
    forward, and the backward's two products per layer."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.randn((2, n, n, 3), device=DEV))
    return 3 * B * counter.get_total_flops() // 2


def _qa_logits(model, batch, cfg, dtype, impl):
    """Start and end logits of the no-grad QA forward on 8 sequences
    (``impl="kernel"``: B1's forward-only kernel once a layer)."""
    ctx = trainer.make_run_ctx(cfg, dataclasses.replace(
        TRAIN_POLICY, compute_dtype=dtype, attn_impl=impl))
    before = ops.launch_counts()["flash_attention"]
    with torch.no_grad():
        out = bert.forward_qa(model, batch["tokens"][:8], ctx,
                              segments=batch["segments"][:8])
    n = ops.launch_counts()["flash_attention"] - before
    check(n == (cfg.n_layers if impl == "kernel" else 0),
          f"paper_bench {cfg.name}: {n} forward-only flash launches in the "
          f"{impl} {dtype} QA forward")
    return out


def _qa_b1_check(model, batch, cfg):
    """The no-grad QA forward through B1 against the plain attention: in
    fp32 the start and end logits within ``SCALED_TOL``; in bf16 within
    ``NOISE_MULTIPLE`` times the plain path's own bf16 error against its
    fp32 logits (max error over max-abs), measured here (bf16 rounding
    alone moves bert-base's 12-layer logits by percents)."""
    out = {(dt, impl): _qa_logits(model, batch, cfg, dt, impl)
           for dt in ("float32", "bfloat16") for impl in ("kernel", "full")}
    res = {"fp32": {n: _scaled_err(g, w, f"paper_bench {cfg.name} B1 fp32 "
                                         f"{n} logits")
                    for n, g, w in zip(("start", "end"),
                                       out[("float32", "kernel")],
                                       out[("float32", "full")])}}
    for n, got, plain, ref in zip(("start", "end"),
                                  out[("bfloat16", "kernel")],
                                  out[("bfloat16", "full")],
                                  out[("float32", "full")]):
        err, noise = _scaled(got, plain), _scaled(plain, ref)
        key = "max_err_over_max_abs"
        check(err[key] <= NOISE_MULTIPLE * noise[key],
              f"paper_bench {cfg.name}: bf16 B1 {n} logits kernel vs plain "
              f"{err} past {NOISE_MULTIPLE} x the plain bf16 vs fp32 "
              f"{noise}")
        res[f"bf16_{n}"] = {"kernel_vs_plain": err,
                            "plain_bf16_vs_fp32": noise,
                            "tol_noise_multiple": NOISE_MULTIPLE}
    return res


def _layer_worst(got, want):
    """The largest error over max-abs, each layer's gradients (named
    ``...blocks.{i}.attn.{leaf}``) measured against the largest of that
    layer's; and per leaf, against the leaf's own max-abs."""
    layers: dict = {}
    for n in want:
        layers.setdefault(n.rsplit(".", 1)[0], []).append(n)
    per_layer = per_leaf = 0.0
    for names in layers.values():
        scale = max(float(want[n].abs().max()) for n in names)
        for n in names:
            err = float((got[n].float() - want[n].float()).abs().max())
            per_layer = max(per_layer, err / scale)
            per_leaf = max(per_leaf, err / float(want[n].abs().max()))
    return {"per_layer": per_layer, "per_leaf": per_leaf}


def paper_bench():
    """The paper's five Table II workloads (``PAPER_WORKLOADS``), each
    trained on one card at its batch and image or sequence size (or the cut
    of ``PAPER_BATCH_CUT``): random weights from seed 0 made on the device,
    one fixed batch made from the seed, ``PAPER_STEPS`` steps plus one
    profiled.  The vision models in fp32 (parameters, compute, AdamW), BERT
    as the LMs train (fp32 parameters, bf16 compute, per-block remat, the
    B2 kernels).  Checks: the loss falls over the steps; every BERT step
    launches the stats forward 2 x L times, dK/dV and dQ L times, and a
    vision step no kernel of the port; BERT's first bf16 step's loss within
    2e-2 of one pass through the plain attention, and one fp32 pass through
    the kernels against one through the plain attention (loss, and the wq /
    wk / wv gradients of every layer, within 5e-4 of the layer's max-abs);
    its no-grad QA forward through B1 against the plain path
    (``_qa_b1_check``); each vision model on the card against the CPU
    (``vision_check``).  Returns bert-base's launches over its steps."""
    counts = {}
    for work in PAPER_WORKLOADS:
        t_start = time.perf_counter()
        nlp = work.domain == "nlp"
        cfg = get_config(work.name) if nlp else VISION_CFGS[work.name]
        B, *cuts = PAPER_BATCH_CUT.get(work.name, (work.batch_size,))
        torch.cuda.reset_peak_memory_stats()
        policy = TRAIN_POLICY if nlp else PolicyConfig(
            compute_dtype="float32", param_dtype="float32", remat="none")
        model = (bert.BertQA.init(cfg, seed=0, device=DEV) if nlp
                 else vision.init_vision(cfg, seed=0, device=DEV))
        n_params = sum(p.numel() for p in model.parameters())
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        batch = _paper_batch(work, cfg, B, gen)
        optcfg = AdamWConfig(lr=PAPER_LR[work.domain])
        state = trainer.TrainState.create(model, policy, optcfg)
        loss_fn = trainer.paper_loss_fn(cfg, policy)
        step_fn = trainer.make_step(loss_fn, optcfg)
        t_init = time.perf_counter()
        checks = {}
        if nlp:
            L = cfg.n_layers
            want = dict({k: 0 for k in ops.launch_counts()},
                        flash_attention_fwd_stats=2 * L,
                        flash_attention_bwd_dkv=L, flash_attention_bwd_dq=L)
            checks["b1_no_grad_logits_vs_plain"] = _qa_b1_check(model, batch,
                                                                cfg)
            # the first step's gradients: one pass through the kernels
            # against one through the plain attention, in fp32 (held) and
            # in bf16 (the loss held; bf16 rounding alone moves the deep
            # layers' wq / wk gradients, 50-100x smaller than wv's at this
            # init, by more than their own size: reported)
            ref = {}
            for dt, impl in (("float32", "kernel"), ("float32", "full"),
                             ("bfloat16", "full")):
                pol = dataclasses.replace(policy, compute_dtype=dt,
                                          attn_impl=impl)
                grads, loss = _grads(model, pol, batch,
                                     trainer.paper_loss_fn(cfg, pol))
                ref[(dt, impl)] = (loss, _pick(grads))
                del grads
            (l32, g32), (p32, gp32) = ref[("float32", "kernel")], \
                ref[("float32", "full")]
            check(abs(l32 - p32) <= 5e-4 * abs(p32),
                  f"paper_bench {work.name}: fp32 loss {l32} vs {p32} "
                  f"through the plain attention (> 5e-4)")
            errs32 = _layer_worst(g32, gp32)
            check(errs32["per_layer"] <= 5e-4,
                  f"paper_bench {work.name}: fp32 attention gradients "
                  f"kernel vs plain {errs32} (> 5e-4 of each layer's "
                  f"max-abs)")
            checks["fp32_pass_vs_plain_attention"] = {
                "loss": [l32, p32], "leaves": list(ATTN_LEAVES),
                "tol_rel": 5e-4, "worst_grad_err_over_max_abs": errs32}
            full_loss, full_attn = ref[("bfloat16", "full")]
            del ref, g32, gp32
        else:
            want = {k: 0 for k in ops.launch_counts()}
            checks["card_vs_cpu"] = vision_check(model, cfg)
        torch.cuda.synchronize()
        t_ref = time.perf_counter()
        losses, norms, step_s = [], [], []
        ops.reset_launch_counts()               # just before the main path
        for i in range(PAPER_STEPS):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            after = ops.launch_counts()
            per_step = {k: after[k] - before[k] for k in after}
            check(per_step == want, f"paper_bench {work.name} step {i}: "
                                    f"launches {per_step} != {want}")
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                if nlp:
                    check(abs(losses[0] - full_loss) <= 2e-2 * abs(full_loss),
                          f"paper_bench {work.name}: first loss {losses[0]} "
                          f"vs {full_loss} through the plain attention")
                    checks["first_bf16_step_vs_plain_attention"] = {
                        "loss": [losses[0], full_loss], "loss_tol_rel": 2e-2,
                        "grad_err_over_max_abs_reported": _layer_worst(
                            _pick({n: p.grad for n, p in
                                   model.named_parameters()}), full_attn)}
                    del full_attn
                torch.cuda.reset_peak_memory_stats()
        counts[work.name] = ops.launch_counts()     # just after
        designs = {}
        if nlp:
            designs = {n: f(cfg.head_dim, torch.bfloat16) for n, f in zip(
                TRAIN_KERNELS, (design, design_dkv, design_dq))}
            want_design = {n: WANT_DESIGN[n][cfg.head_dim] for n in designs}
            check(designs == want_design,
                  f"paper_bench {work.name}: designs {designs}, not "
                  f"{want_design}")
        t_steps = time.perf_counter()
        last = []
        profile = _profile(lambda: last.append(step_fn(state, batch)[1]),
                           f"paper_bench {work.name}")
        losses.append(float(last[0]["loss"]))
        norms.append(float(last[0]["grad_norm"]))
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"paper_bench {work.name}: non-finite loss or grad norm "
              f"{losses} {norms}")
        check(losses[-1] < losses[0], f"paper_bench {work.name}: loss did "
                                      f"not fall: {losses}")
        p50 = float(np.median(step_s[1:]))      # the first step is warm-up
        if nlp:
            S = work.seq_or_img
            matmul_params = n_params - sum(
                p.numel() for p in (model.lm.embed, model.lm.pos_embed,
                                    model.segment_embed))
            flops = _model_flops_per_step(
                cfg, matmul_params, ShapeConfig("paper", S, B, "train"))
            peak, dtype = PEAK_FLOPS[torch.bfloat16], "bfloat16"
            rates = {"sequences_per_s": B / p50, "tokens_per_s": B * S / p50}
        else:
            flops = _vision_flops(model, work.seq_or_img, B)
            peak, dtype = PEAK_FLOPS[torch.float32], "float32"
            rates = {"images_per_s": B / p50}
        emit("paper_bench", workload=work.name, domain=work.domain,
             params=n_params, params_paper=work.params_paper, batch=B,
             batch_paper=work.batch_size, seq_or_img=work.seq_or_img,
             compute_dtype=dtype, param_dtype="float32",
             remat=policy.remat, lr=optcfg.lr, steps=PAPER_STEPS,
             warmup_steps_excluded=1, losses=losses, grad_norms=norms,
             step_s=step_s, step_s_p50=p50, **rates,
             model_flops_per_step=flops, model_flops_per_s=flops / p50,
             model_flops_share_of_peak=flops / p50 / peak,
             peak_flops=peak, max_memory_allocated=torch.cuda
             .max_memory_allocated(), launches=counts[work.name],
             designs=designs, checks=checks, profiled_step=profile,
             cuts=cuts, phase_s={
                 "init": t_init - t_start, "checks": t_ref - t_init,
                 "steps": t_steps - t_ref,
                 "profile": time.perf_counter() - t_steps,
                 "all": time.perf_counter() - t_start})
        del state, step_fn, model, batch
        torch.cuda.empty_cache()
    return counts[BERT_ARCH]


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


# ---------------------------------------------------------------------------
# the MoE archs
# ---------------------------------------------------------------------------
MOE_ARCH = "moonshot-v1-16b-a3b"
SCOUT_ARCH = "llama4-scout-17b-a16e"
# llama4-scout: 107.8 B parameters at its 48 layers, 216 GB in bf16
SCOUT_LAYERS = 12
SCOUT_CUT = ("depth 48 -> 12 layers (107.8 B parameters, 216 GB in bf16 at "
             "full depth, do not fit one card)",)
# moonshot trained: 28.9 B fp32 parameters with gradients and AdamW state
# (~462 GB) at full depth
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 3
# at lr 3e-4 the first update multiplies the load-balance term 3.5-fold (the
# routes crowd onto few experts) and the loss, aux included, rises over 3
# steps though the cross entropy falls; at 1e-4 both the loss and the cross
# entropy fall (PERF.md, the MoE findings)
MOE_TRAIN_LR = 1e-4
MOE_TRAIN_CUT = ("depth 48 -> 4 layers (28.9 B fp32 parameters with "
                 "gradients and AdamW state, ~462 GB, do not fit one card)",
                 "global batch 256 -> 2 (one card)", "5 steps -> 3")
# every leaf of a moonshot block (norm scales, attention, router, routed
# and shared experts) and the tables
MOE_TRAIN_LEAVES = ("embed", "head", "scale", "wq", "wk", "wv", "wo",
                    "router", "wi", "wg")

# the device time of one step by part: kernels are attributed to the
# innermost range or autograd node on their launching op's stack
# (``record_function`` ranges that ``_moe_split`` opens around the MoE's
# parts and the attention mixer; in a backward, the node that launched
# them; elementwise backward nodes fall to "rest")
MOE_SPLIT = (("expert_products", ("moe.experts", "BmmBackward")),
             ("moe_dispatch", ("moe.sorted", "IndexSelectBackward",
                               "IndexCopyBackward", "TopkBackward",
                               "SoftmaxBackward")),
             ("shared_experts", ("moe.shared",)),
             ("attention", ("attn.mixer", "FlashAttentionFn")))


def _moe_profile(fn):
    """``fn()`` once under ``torch.profiler`` with ranges around
    ``moe_sorted`` (routing, sort, dispatch, combine), ``_expert_ffn`` (the
    expert products), the shared experts' MLP and the attention mixer
    (projections, RoPE, the kernel); returns the profiler's events and the
    call's wall ms.  ``fn`` must run eagerly: a graph replay calls none of
    the ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def run(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return run

    patches = [(moe_mod, "moe_sorted", "moe.sorted"),
               (moe_mod, "_expert_ffn", "moe.experts"),
               (layers_mod, "apply_mlp", "moe.shared"),
               (attention_mod, "apply_attention", "attn.mixer")]
    saved = [getattr(m, n) for m, n, _ in patches]
    for (m, n, r), f in zip(patches, saved):
        setattr(m, n, ranged(r, f))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, n, _), f in zip(patches, saved):
            setattr(m, n, f)
    return prof.events(), wall_ms


def _split_ms(events):
    """Device ms of each part (``MOE_SPLIT``) and the rest, each kernel
    counted once.  The profiler hangs a correlation id's kernels on every
    CPU event with that id: the op that launched them, and also events
    such as CUPTI's "Command Buffer Full" or ``cudaStreamIsCapturing`` that
    share its id.  So the kernels are counted once an id, for the first
    part any of its events falls under."""
    by_id = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.kernels:
            by_id.setdefault(ev.id, []).append(ev)
    ms = dict({k: 0.0 for k, _ in MOE_SPLIT}, rest=0.0)
    for group in by_id.values():
        kinds = []
        for node in group:
            kind = "rest"
            while node is not None and kind == "rest":
                kind = next((k for k, keys in MOE_SPLIT
                             if any(t in node.name for t in keys)), "rest")
                node = node.cpu_parent
            kinds.append(kind)
        kind = next((k for k in kinds if k != "rest"), "rest")
        ms[kind] += sum(k.duration for k in group[0].kernels) / 1e3
    return ms


def _moe_split(fn, what):
    """``fn()`` under ``_moe_profile``: device ms of each part
    (``MOE_SPLIT``) and the rest, and the device's idle share."""
    events, wall_ms = _moe_profile(fn)
    ms = _split_ms(events)
    busy = sum(ms.values())
    check(busy > 0, f"{what}: the profiler saw no device activity")
    check(busy <= 1.05 * wall_ms,
          f"{what}: device time {busy} ms exceeds the wall {wall_ms} ms")
    return {"device_ms": ms, "device_busy_ms": busy, "wall_ms": wall_ms,
            "device_idle_share": 1.0 - busy / wall_ms}


def _moe_decode_split(eng, cfg):
    """One paged decode iteration of ``eng.n_slots`` rows (64-token
    prompts), run eagerly on the inputs its graph was staged with, under
    ``_moe_split``."""
    prompts = [_prompt(950 + i, 64, cfg.vocab_size)
               for i in range(eng.n_slots)]
    reqs = [ServeRequest(2000 + i, p, max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        check(eng.submit(r), f"moe split: request {r.rid} rejected")
    while not all(r.state == "decode" and r.out for r in reqs):
        eng.step()
    toks = [[r.out[-1]] for r in reqs]
    pos = [[r.prompt_len + len(r.out) - 1] for r in reqs]
    n = len(reqs)
    eng._run_paged(reqs, toks, pos, [[True]] * n, [0] * n)
    key = ("decode", n, eng._table_width(reqs, 1), 1)
    inputs = eng.graphs._steps[key].inputs     # as that step staged them
    out = _moe_split(lambda: eng._decode_rows_step(*inputs),
                     f"{cfg.name} decode")      # rewrites the same K/V
    eng.run()
    check(all(r.done for r in reqs), "moe split: a request was not served")
    return dict(out, rows=n)


def _moe_prefill_split(eng, cfg, n):
    """One dense prefill of ``n`` tokens (padded to its bucket), run eagerly
    on the inputs its graph was staged with, under ``_moe_split``."""
    S = min(bucket_pow2(n, floor=16), eng.max_seq)
    eng.prefill_once(_prompt(960, n, cfg.vocab_size))
    inputs = eng.graphs._steps[("prefill", S)].inputs
    return dict(_moe_split(lambda: eng._prefill_step(*inputs),
                           f"{cfg.name} prefill"), tokens=n, bucket=S)


def moe_kernel_cases(gen):
    """The attention kernels at the MoE archs' shapes: B1 at moonshot's
    and scout's dense prefill, B3 at their paged decode, B2 at moonshot's
    trained shape."""
    moon = get_config(MOE_ARCH)
    scout = cut_depth(get_config(SCOUT_ARCH), SCOUT_LAYERS)
    with torch.no_grad():
        out = {"flash_moonshot": flash_main_shape(gen, moon, 2048),
               "flash_scout": flash_main_shape(gen, scout, 2048),
               "paged_moonshot": paged_main_shape(gen, moon),
               "paged_scout": paged_main_shape(gen, scout)}
        torch.cuda.empty_cache()
        *out["bwd_moonshot"], out["bwd_faults_moonshot"] = bwd_main_shape(
            gen, moon, *TRAIN_SHAPE_BS)
    torch.cuda.empty_cache()
    return out


def moe(policy):
    """moonshot-v1-16b-a3b served at full size (paged and dense, through
    the step graphs) with its parity, llama4-scout-17b-a16e served at its
    depth cut, moonshot trained at its depth cut; returns the launches of
    each run.  The ``moe`` line: where a moonshot decode step and a
    prefill spend their device time, peak memory, ``phase_s``."""
    t0 = time.perf_counter()
    out, phase_s = {}, {}
    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    n_params = sum(p.numel() for p in model.parameters())
    phase_s["init"] = time.perf_counter() - t0
    out["paged_moonshot"], eng, _ = serve_paged(cfg, model, policy)
    decode_split = _moe_decode_split(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    out["flash_moonshot"], eng = serve_dense(cfg, model, policy)
    prefill_split = _moe_prefill_split(eng, cfg, 1500)
    del eng
    torch.cuda.empty_cache()
    phase_s["serve"] = time.perf_counter() - t0 - sum(phase_s.values())
    parity(cfg, model)
    peak_serve = torch.cuda.max_memory_allocated()
    # the ``tp`` line's part (c): one prefill batch through ``_moe_ep``,
    # its peak read apart
    torch.cuda.reset_peak_memory_stats()
    out["tp_moe"] = _tp_moe(cfg, model)
    out["tp_moe"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    phase_s["tp_moe"] = time.perf_counter() - t0 - sum(phase_s.values())
    del model
    torch.cuda.empty_cache()
    parity_moe(cfg)
    torch.cuda.empty_cache()
    phase_s["parity"] = time.perf_counter() - t0 - sum(phase_s.values())

    scout = cut_depth(get_config(SCOUT_ARCH), SCOUT_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = LM.init(scout, seed=0, dtype=torch.bfloat16, device=DEV)
    n_scout = sum(p.numel() for p in model.parameters())
    out["paged_scout"], eng, _ = serve_paged(scout, model, policy)
    scout_split = _moe_decode_split(eng, scout)
    del eng
    torch.cuda.empty_cache()
    out["flash_scout"] = serve_dense(scout, model, policy)[0]
    del model
    torch.cuda.empty_cache()
    peak_scout = torch.cuda.max_memory_allocated()
    phase_s["scout"] = time.perf_counter() - t0 - sum(phase_s.values())

    out["train_moonshot"] = train(
        cut_depth(cfg, MOE_TRAIN_LAYERS), TRAIN_SHAPE, MOE_TRAIN_STEPS,
        cuts=MOE_TRAIN_CUT, leaves=MOE_TRAIN_LEAVES, split=True,
        lr=MOE_TRAIN_LR)
    torch.cuda.empty_cache()
    phase_s["train"] = time.perf_counter() - t0 - sum(phase_s.values())
    # the ``tp`` line's part (j): the step on a one-rank data-only mesh
    out["tp_moe_data_only"] = _moe_data_only_step(cfg)
    phase_s["tp_moe_data_only"] = (time.perf_counter() - t0
                                   - sum(phase_s.values()))
    m = cfg.moe
    # a decode step's routed experts read whole: E * 3 * d * f bf16 a layer
    expert_bytes = cfg.n_layers * m.n_experts * 3 * cfg.d_model \
        * m.d_ff_expert * 2
    emit("moe", arch=cfg.name, params=n_params, scout_params=n_scout,
         scout_cuts=list(SCOUT_CUT), decode_split=decode_split,
         prefill_split=prefill_split, scout_decode_split=scout_split,
         decode_expert_bytes=expert_bytes,
         decode_expert_bytes_ms_at_hbm_rate=expert_bytes / HBM_BYTES_PER_S
         * 1e3,
         max_memory_allocated={"moonshot_serve": peak_serve,
                               "scout_serve": peak_scout},
         phase_s=dict(phase_s, total=time.perf_counter() - t0))
    return out


# ---------------------------------------------------------------------------
# the composable-system analytics on the card
# ---------------------------------------------------------------------------
BEATS = 1.05        # no measured figure may beat its constant by more
HBM_COPY_BYTES = 2 ** 30
MATMUL_N = 8192
HOST_COPY_BYTES = 256 * 2 ** 20
FIGURE_REPS = 7
LATENCY_REPS = 200


def _event_ms(fn, reps):
    """Median device milliseconds of ``fn()`` over ``reps`` calls, each
    between its own pair of CUDA events (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def _beside(measured, constant):
    return {"measured": measured, "constant": constant,
            "ratio": measured / constant}


def chip_figures(chip):
    """(a) the card against ``chip`` (the port's ``ChipSpec``): its memory,
    a device-to-device copy of 1 GiB (read + write counted) and a bf16
    ``torch.matmul`` at 8192^3 (a library call: it measures the card and
    ports no kernel), medians of ``FIGURE_REPS`` by CUDA events."""
    total = torch.cuda.get_device_properties(0).total_memory
    src = torch.empty(HBM_COPY_BYTES, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    copy_ms = _event_ms(lambda: dst.copy_(src), FIGURE_REPS)
    del src, dst
    n = MATMUL_N
    gen = torch.Generator(device=DEV).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=DEV, dtype=torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device=DEV, dtype=torch.bfloat16)
    mm_ms = _event_ms(lambda: torch.matmul(a, b), FIGURE_REPS)
    del a, b
    torch.cuda.empty_cache()
    out = {"total_memory_bytes": _beside(total, chip.hbm_bytes),
           "hbm_bytes_per_s": _beside(2 * HBM_COPY_BYTES / (copy_ms / 1e3),
                                      chip.hbm_bw),
           "bf16_matmul_flops_per_s": _beside(
               2 * n ** 3 / (mm_ms / 1e3), chip.peak_flops_bf16),
           "hbm_copy_ms": copy_ms, "matmul_ms": mm_ms,
           "reps": FIGURE_REPS}
    for k in ("total_memory_bytes", "hbm_bytes_per_s",
              "bf16_matmul_flops_per_s"):
        check(out[k]["ratio"] <= BEATS,
              f"composable: the card's {k} {out[k]['measured']} beats the "
              f"ChipSpec figure {out[k]['constant']} by more than 5 %")
    return out


def host_link(link):
    """(b) the card's host link against ``link`` (the port's ``HOST``
    ``LinkSpec``): pinned host->device and device->host copies of 256 MiB
    (medians of ``FIGURE_REPS`` by CUDA events) and a 4-byte copy plus
    synchronize (median of ``LATENCY_REPS`` by the host clock)."""
    host = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(HOST_COPY_BYTES, dtype=torch.uint8, device=DEV)
    h2d = _event_ms(lambda: dev.copy_(host, non_blocking=True), FIGURE_REPS)
    d2h = _event_ms(lambda: host.copy_(dev, non_blocking=True), FIGURE_REPS)
    del host, dev
    small_h = torch.zeros(1, dtype=torch.float32, pin_memory=True)
    small_d = torch.zeros(1, dtype=torch.float32, device=DEV)
    lat = []
    for _ in range(LATENCY_REPS):
        t0 = time.perf_counter()
        small_d.copy_(small_h, non_blocking=True)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    out = {"h2d_bytes_per_s": _beside(HOST_COPY_BYTES / (h2d / 1e3),
                                      link.bandwidth),
           "d2h_bytes_per_s": _beside(HOST_COPY_BYTES / (d2h / 1e3),
                                      link.bandwidth),
           "copy_4_bytes_s": _beside(float(np.median(lat)), link.latency),
           "copy_bytes": HOST_COPY_BYTES, "reps": FIGURE_REPS,
           "latency_reps": LATENCY_REPS}
    for k in ("h2d_bytes_per_s", "d2h_bytes_per_s"):
        check(out[k]["ratio"] <= BEATS,
              f"composable: the host link's {k} {out[k]['measured']} beats "
              f"HOST's {link.bandwidth} by more than 5 %")
    return out


ONE_CHIP = {"data": 1, "model": 1}


def cost_vs_measured(chip):
    """(c) each ``train`` run (``TRAINED``) priced by the port's cost model
    on one card: ``compute_s`` = ``step_flops`` over the bf16 peak and
    ``memory_s`` = ``analytic_hbm_bytes`` over the HBM rate, at the shape
    and policy (per-block remat) that ran, on a 1 x 1 mesh; the prediction
    is their max, beside the measured step p50.  A roofline the card beats
    is a wrong count or a wrong constant."""
    rows = []
    for t in TRAINED:
        cfg, shape = t["cfg"], t["shape"]
        flops = costmodel.step_flops(cfg, shape, TRAIN_POLICY)
        nbytes = costmodel.analytic_hbm_bytes(cfg, shape, TRAIN_POLICY,
                                              ONE_CHIP)
        compute_s = flops / chip.peak_flops_bf16
        memory_s = nbytes / chip.hbm_bw
        pred = max(compute_s, memory_s)
        got = t["step_s_p50"]
        figs = (flops, nbytes, compute_s, memory_s, pred, got)
        check(all(np.isfinite(figs)) and min(figs) > 0,
              f"composable: {cfg.name}: a figure is not finite and "
              f"positive: {figs}")
        check(pred <= BEATS * got,
              f"composable: {cfg.name}: the cost model's {pred} s beats "
              f"the measured step {got} s by more than 5 %")
        rows.append({"arch": cfg.name, "shape": [shape.global_batch,
                                                 shape.seq_len],
                     "step_flops": flops, "analytic_hbm_bytes": nbytes,
                     "compute_s": compute_s, "memory_s": memory_s,
                     "predicted_s": pred, "measured_p50_s": got,
                     "measured_over_predicted": got / pred})
    return rows


def _metric_rows(path, key):
    return [e for e in tracking.read_events(path)
            if e["kind"] == "metrics" and key in e["metrics"]]


def tracked_serve(run, eng, what):
    """``eng``'s tracker ``run``: one windowed row per ``track_every``
    iterations of ``eng`` so far, at those iterations."""
    rows = _metric_rows(run.path, "iter")
    every = eng.track_every
    want = [every * (i + 1) for i in range(eng._iters // every)]
    got = [r["metrics"]["iter"] for r in rows]
    check(want and got == want,
          f"{what}: the tracked serve rows are at iterations {got}, not "
          f"one per {every} of {eng._iters}: {want}")
    return {"rows": len(rows), "iterations": eng._iters,
            "track_every": every}


def tracked_train(run, serve, trained):
    """The finished run read back: ``serve``'s rows (``tracked_serve``) and
    no other, one ``metrics`` row per train step of ``trained`` with rising
    steps and the losses the ``train`` line printed, and a ``finish``
    record at its end."""
    events = tracking.read_events(run.path)
    rows = _metric_rows(run.path, "loss")
    steps = [r["step"] for r in rows]
    losses = [r["metrics"]["loss"] for r in rows]
    check(len(_metric_rows(run.path, "iter")) == serve["rows"],
          "tracking: serve rows other than serve_paged's are in the run")
    check(len(rows) == len(trained["losses"])
          and all(a < b for a, b in zip(steps, steps[1:])),
          f"tracking: tracked train steps {steps} are not one a step, "
          f"rising")
    check(losses == trained["losses"],
          f"tracking: tracked losses {losses} != the train line's "
          f"{trained['losses']}")
    finish = [e for e in events if e["kind"] == "finish"]
    check(len(finish) == 1 and finish[0]["status"] == "ok"
          and events[-1] is finish[0],
          "tracking: the tracked run has no finish record at its end")
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    emit("tracking", arch=trained["cfg"].name, run_id=run.id, events=kinds,
         serve_paged=serve, train_rows=len(rows), train_steps=steps,
         train_losses=losses)


def composable():
    """The ``composable`` line: (a) the card against ``ChipSpec``, (b) its
    host link against ``HOST``, (c) the cost model against the measured
    steps."""
    t0 = time.perf_counter()
    chip = ChipSpec()
    out = {"chip_spec": dataclasses.asdict(chip),
           "chip": chip_figures(chip),
           "host_link": host_link(DEFAULT_LINKS[LinkClass.HOST]),
           "links": {c.value: {"bandwidth": l.bandwidth,
                               "latency": l.latency}
                     for c, l in DEFAULT_LINKS.items()}}
    torch.cuda.empty_cache()
    out["cost_model"] = cost_vs_measured(chip)
    emit("composable", **out, phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# elastic training: a failure and resume through the kernels
# ---------------------------------------------------------------------------
ELASTIC_LAYERS = 2
ELASTIC_STEPS = 6
ELASTIC_SAVE_AT = 3          # steps before the failure
ELASTIC_POOL = (4, 4)        # modelled H100s: local, switch-attached
ELASTIC_LR = 3e-4
ELASTIC_CUT = ("depth 48 -> 2 layers (the checkpoint of fp32 parameters "
               "and both AdamW moments stays ~1.3 GB)",
               "global batch 256 -> 2 (one card)")


def _elastic_steps(state, step_fn, batches, first, want):
    """Steps ``first`` .. ``len(batches) - 1`` of ``state``, each holding
    its launches to ``want``; returns (state, losses)."""
    losses = []
    for i in range(first, len(batches)):
        before = ops.launch_counts()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        per_step = {k: after[k] - before[k] for k in after}
        check(per_step == want, f"elastic step {i + 1}: launches {per_step} "
                                f"!= {want}")
        losses.append(float(m["loss"]))
    return state, losses


def _state_diff(a, b):
    """Largest |a - b| over the parameters, over each moment, and whether
    every leaf (the optimizer step too) is bit-identical."""
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    check(sorted(la) == sorted(lb), "elastic: the states' leaves differ")
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    same = True
    for k, x in la.items():
        if not torch.is_tensor(x):
            same = same and x == lb[k]
            continue
        same = same and torch.equal(x, lb[k])
        group = k.split("/")[0] if k.startswith("params/") \
            else k.split("/")[1]
        if group in ("params", "m", "v"):
            worst[group] = max(worst[group], float(
                (x.detach().float() - lb[k].detach().float()).abs().max()))
    return worst, same


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def elastic_phase():
    """The ``elastic`` line: mamba2-780m at full width, depth cut to
    ``ELASTIC_LAYERS``, trained on ``TRAIN_SHAPE`` (bf16 compute, fp32
    parameters, AdamW, per-block remat) through the SSD kernels.  Run A
    takes ``ELASTIC_STEPS`` steps from seed 0, run A' the same again (is
    the step deterministic?).  Run B takes ``ELASTIC_SAVE_AT`` steps, saves
    a checkpoint (``train/checkpoint``), and its 1 x 1 composition in a
    modelled pool of H100s loses its device (``elastic.handle_failure``:
    recompose onto a spare); the model, the optimizer state and the cached
    allocator blocks are dropped, a state from another seed is restored
    from the checkpoint onto the card (``elastic.resume``), and B takes the
    remaining steps on the same batches.  B's losses after the resume and
    its final parameters and moments must equal A's bit for bit or, if A
    and A' differ, lie within their spread; each resumed step launches the
    SSD forward twice and its backward once per layer."""
    t0 = time.perf_counter()
    cfg = cut_depth(get_config(SSM_ARCH), ELASTIC_LAYERS)
    n_ssm = cfg.pattern.count(SSM)
    optcfg = AdamWConfig(lr=ELASTIC_LR)
    sched = ScheduleConfig(kind="cosine", peak_lr=ELASTIC_LR,
                           warmup_steps=1, total_steps=ELASTIC_STEPS)
    step_fn = trainer.make_train_step(cfg, TRAIN_POLICY, optcfg, sched,
                                      shape=TRAIN_SHAPE)
    ds = SyntheticDataset(cfg, TRAIN_SHAPE, seed=0)
    batches = [ds.batch_at(i) for i in range(ELASTIC_STEPS)]
    want = dict({k: 0 for k in ops.launch_counts()}, ssd=2 * n_ssm,
                ssd_bwd=n_ssm)

    def fresh(seed):
        return trainer.init_state(cfg, TRAIN_POLICY, optcfg, seed=seed,
                                  device=DEV)

    a, losses_a = _elastic_steps(fresh(0), step_fn, batches, 0, want)
    a2, losses_a2 = _elastic_steps(fresh(0), step_fn, batches, 0, want)
    spread, deterministic = _state_diff(a, a2)
    deterministic = deterministic and losses_a == losses_a2
    del a2
    t_ab = time.perf_counter()

    b, losses_b = _elastic_steps(fresh(0), step_fn,
                                 batches[:ELASTIC_SAVE_AT], 0, want)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        checkpoint.save(ckpt_dir, ELASTIC_SAVE_AT, b)
        save_s = time.perf_counter() - ts
        nbytes = _dir_bytes(ckpt_dir)
        pool = make_pool(*ELASTIC_POOL, pods=1)
        system = compose_mod.compose(
            pool, "elastic-job", ("data", "model"), (1, 1),
            {"data": LinkClass.LOCAL, "model": LinkClass.LOCAL})
        run = elastic.ElasticRun(system, ckpt_dir=ckpt_dir)
        new = elastic.handle_failure(run, pool, system.device_uids,
                                     step=ELASTIC_SAVE_AT)
        check(new.axis_sizes == (1, 1)
              and set(new.device_uids).isdisjoint(system.device_uids),
              f"elastic: the job was not recomposed onto a spare: {new}")
        del b                       # the model and the optimizer state
        torch.cuda.empty_cache()    # and the cached allocator blocks
        b = fresh(1)
        torch.cuda.synchronize()
        tr = time.perf_counter()
        b, step = elastic.resume(run, b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - tr
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(step == ELASTIC_SAVE_AT and b.opt.step == ELASTIC_SAVE_AT
          and b.device.type == "cuda",
          f"elastic: resumed at step {step} (optimizer {b.opt.step}) on "
          f"{b.device}, not at {ELASTIC_SAVE_AT} on the card")
    ops.reset_launch_counts()               # just before the main path
    b, resumed = _elastic_steps(b, step_fn, batches, step, want)
    counts = ops.launch_counts()            # just after
    losses_b += resumed
    diff, equal = _state_diff(a, b)
    equal = equal and losses_b == losses_a
    loss_diff = max(abs(x - y) for x, y in zip(losses_b, losses_a))
    loss_spread = max(abs(x - y) for x, y in zip(losses_a2, losses_a))
    within = (all(diff[k] <= spread[k] for k in diff)
              and loss_diff <= loss_spread)
    held = "bit_identical" if equal else "within_spread"
    check(equal or (not deterministic and within),
          f"elastic: the resumed run differs from the uninterrupted one "
          f"(losses {losses_b} vs {losses_a}, largest differences {diff}) "
          f"beyond A vs A' ({spread}, deterministic={deterministic})")
    kinds = [e.kind for e in run.events]
    check(kinds == ["failure", "recompose", "restore"],
          f"elastic: events {kinds}")
    check(counts["ssd"] == 2 * n_ssm * len(resumed)
          and counts["ssd_bwd"] == n_ssm * len(resumed),
          f"elastic: resumed steps launched {counts}")
    # what the cluster simulator prices this job's restore at: its
    # tranche's per-lessee read rate (``Scheduler.restore_s``), for the
    # full-depth job it would run
    sched_pool = make_pool(*ELASTIC_POOL, pods=1)
    sim_sched = Scheduler(sched_pool)
    job = Job("elastic-job", SSM_ARCH, "train_4k", 1, steps=ELASTIC_STEPS)
    sim_sched.submit(job, 0.0)
    check(sim_sched.poll(0.0) == [job], "elastic: the scheduler did not "
                                        "start the modelled job")
    job.steps_done = float(ELASTIC_SAVE_AT)
    priced_s = sim_sched.restore_s(job)
    priced_bw = sim_sched.storage.read_bw(job.system.tranche)
    n_params = sum(p.numel() for p in b.model.parameters())
    emit("elastic", arch=cfg.name, n_layers=ELASTIC_LAYERS, params=n_params,
         batch=TRAIN_SHAPE.global_batch, seq=TRAIN_SHAPE.seq_len,
         compute_dtype="bfloat16", param_dtype="float32", remat="block",
         steps=ELASTIC_STEPS, failure_after_step=ELASTIC_SAVE_AT,
         losses_uninterrupted=losses_a, losses_again=losses_a2,
         losses_resumed=losses_b, held=held,
         deterministic_a_vs_a_again=deterministic,
         a_vs_a_again_max_abs=spread, resumed_vs_a_max_abs=diff,
         events=[dataclasses.asdict(e) for e in run.events],
         launches_resumed_steps=counts,
         launches_per_resumed_step={"ssd": 2 * n_ssm, "ssd_bwd": n_ssm},
         checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s,
         save_gb_per_s=nbytes / save_s / 1e9,
         restore_gb_per_s=nbytes / restore_s / 1e9,
         simulator_restore={
             "arch": SSM_ARCH, "tranche": job.system.tranche,
             "priced_read_gb_per_s": priced_bw / 1e9,
             "priced_restore_s_full_depth_fp32_params": priced_s,
             "priced_s_for_this_checkpoint": nbytes / priced_bw},
         cuts=list(ELASTIC_CUT),
         phase_s={"runs_a": t_ab - t0,
                  "total": time.perf_counter() - t0})
    del a, b, step_fn
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the cluster control plane at the H100's constants
# ---------------------------------------------------------------------------
# ``examples/cluster_trace.py``'s trace: 24 jobs at 0.2 Hz, seed 7, a
# 12-device failure wave at 120 s repaired after 180 s
CLUSTER_TRACE = TraceConfig(n_jobs=24, arrival_rate_hz=0.2, seed=7,
                            failures=((120.0, 12),), repair_after_s=180.0)
# the same trace with every template elastic, under priority_preempt, with
# a fault plan (a drawer out, the switch fabric at half its rate, a tranche
# at a quarter) and the live recomposition plane
CLUSTER_CHAOS = dataclasses.replace(
    CLUSTER_TRACE, policy="priority_preempt",
    templates=tuple(dataclasses.replace(t, elastic=True)
                    for t in DEFAULT_TEMPLATES),
    faults=FaultPlan(faults=(
        FaultSpec("domain_outage", t=90.0, domain=1, t_clear=150.0,
                  detect_s=2.0),
        FaultSpec("link_degrade", t=60.0, link="switch", frac=0.5,
                  t_clear=200.0),
        FaultSpec("tranche_brownout", t=100.0, tranche="local-nvme-0",
                  frac=0.25, t_clear=240.0)), retry_backoff_s=5.0),
    recompose=RecomposeConfig(interval_s=10.0, cooldown_s=20.0))


def cluster_phase():
    """The ``cluster`` line: the simulator at the port's (the H100's)
    constants, each configuration run twice; the two reports must be
    byte-identical, every job accounted for, no lease conflict."""
    t0 = time.perf_counter()
    out = {}
    for name, cfg in (("cluster_trace", CLUSTER_TRACE),
                      ("faults_recompose_priority_preempt", CLUSTER_CHAOS)):
        reps, walls = [], []
        for _ in range(2):
            sim = ClusterSimulator(cfg)
            reps.append(sim.run())
            walls.append(sim.wall_s)
        texts = [json.dumps(r, sort_keys=True, default=str) for r in reps]
        check(texts[0] == texts[1],
              f"cluster: {name}: two runs' reports differ")
        rep = reps[0]
        jobs = rep["jobs"]
        check(jobs["completed"] + jobs["rejected"] + jobs["failed"]
              + jobs["stranded"] == jobs["submitted"] > 0
              and rep["lease_conflicts"] == 0,
              f"cluster: {name}: jobs {jobs}, lease conflicts "
              f"{rep['lease_conflicts']}")
        out[name] = {"jobs": jobs, "makespan_s": rep["makespan_s"],
                     "auu": rep["auu"],
                     "pool_utilization": rep["pool_utilization"],
                     "recompositions": rep["recomposition"]["count"],
                     "recompose": rep.get("recompose"),
                     "faults_injected": rep["faults"]["injected"],
                     "policy": rep["policy"],
                     "pool_devices": rep["config"]["pool_devices"],
                     "report_bytes": len(texts[0]),
                     "reports_identical": True, "wall_s": walls}
    emit("cluster", chip=ChipSpec().name, **out,
         phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the paper's software ladder (§V-4) as the data-parallel layer
# ---------------------------------------------------------------------------
LADDER_ARCH = "qwen2-0.5b"
# the distinct programs of ``policy.ladder()``: DDP differs from DP only in
# ``hierarchical_allreduce``, which changes nothing in the step (as in the
# reference), so it is DP's program and is not timed twice
LADDER_RUNGS = ("DP", "DDP+mixed", "DDP+mixed+sharded")
LADDER_TIMED = 3                # after one warm-up step each, in turns
LADDER_LR = 3e-4
EF_REPS = 3
EF_WORLDS = (4, 8)              # cards priced for the int8 exchange
STATE_ARCHS = ("stablelm-12b", "moonshot-v1-16b-a3b",
               "llama4-scout-17b-a16e")
STATE_WORLDS = (1, 2, 4, 8, 16)


def _tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def _ladder_steps(cfg, mesh):
    """(a): each program of ``LADDER_RUNGS`` on ``mesh`` from seed 0, one
    warm-up step each, then ``LADDER_TIMED`` rounds in turns; every step
    launches B2's kernels as llama's steps do (two stats-emitting forwards,
    one dK/dV and one dQ per layer) and each rung's first loss is held to
    the same step without a mesh (2e-2, the ``train`` check), which is held
    to the plain attention's (2e-2).  Returns (the line's fields, the
    bf16 rungs' launches, the DP rung's last gradients, the DDP+mixed
    rung's parameters after its steps and its gradients of step 0)."""
    base = PolicyConfig(param_dtype="float32", remat="block",
                        attn_impl="kernel", dp_axes=("data",))
    rungs = policy_mod.ladder(base)
    check(dataclasses.replace(rungs["DDP"], hierarchical_allreduce=False)
          == rungs["DP"], "ladder: DDP is not DP's program")
    optcfg = AdamWConfig(lr=LADDER_LR)
    sched = ScheduleConfig(kind="cosine", peak_lr=LADDER_LR, warmup_steps=1,
                           total_steps=1 + LADDER_TIMED)
    ds = SyntheticDataset(cfg, TRAIN_SHAPE, seed=0)
    batches = [ds.batch_at(i) for i in range(1 + LADDER_TIMED)]
    n = cfg.n_layers
    want = dict({k: 0 for k in ops.launch_counts()},
                flash_attention_fwd_stats=2 * n, flash_attention_bwd_dkv=n,
                flash_attention_bwd_dq=n)
    # the same first step without a mesh, through the kernels and through
    # the plain attention, in each compute dtype
    no_mesh = {}
    model = LM.init(cfg, seed=0, device=DEV)
    for dt in ("float32", "bfloat16"):
        pol = dataclasses.replace(base, compute_dtype=dt)
        got = _grads(model, pol, batches[0])[1]
        plain = _grads(model, dataclasses.replace(pol, attn_impl="full"),
                       batches[0])[1]
        check(abs(got - plain) <= 2e-2 * abs(plain),
              f"ladder: {dt} first loss {got} vs {plain} through the plain "
              f"attention (> 2e-2)")
        no_mesh[dt] = {"kernels": got, "plain_attention": plain}
    del model
    torch.cuda.empty_cache()

    states, steps, rows = {}, {}, {}
    for name in LADDER_RUNGS:
        pol = rungs[name]
        states[name] = trainer.init_state(cfg, pol, optcfg, seed=0,
                                          device=DEV, mesh=mesh)
        steps[name] = trainer.make_train_step(cfg, pol, optcfg, sched,
                                              mesh=mesh, shape=TRAIN_SHAPE)
        rows[name] = {"zero_stage": pol.zero_stage,
                      "compute_dtype": pol.compute_dtype,
                      "state_bytes": _tensor_bytes(checkpoint._leaves(
                          states[name]).values()),
                      "losses": [], "grad_norms": [], "step_s": [],
                      "step_peak_extra_bytes": []}
    launches = {name: {k: 0 for k in want} for name in LADDER_RUNGS}

    def step(name, i):
        fn = steps[name]
        fn.traffic.reset()
        before = ops.launch_counts()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        states[name], m = fn(states[name], batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == want, f"ladder {name} step {i}: launches {per} != "
                           f"{want}")
        r = rows[name]
        r["losses"].append(float(m["loss"]))
        r["grad_norms"].append(float(m["grad_norm"]))
        r["step_s"].append(dt)
        r["step_peak_extra_bytes"].append(
            torch.cuda.max_memory_allocated() - start)
        r["collectives_per_step"] = fn.traffic.report()
        return per

    for name in LADDER_RUNGS:               # warm-up
        step(name, 0)
        if name == "DDP+mixed":
            first_grads = {n: p.grad.detach().clone() for n, p in
                           states[name].model.named_parameters()
                           if p.grad is not None}
        dt = rows[name]["compute_dtype"]
        first, ref = rows[name]["losses"][0], no_mesh[dt]["kernels"]
        check(abs(first - ref) <= 2e-2 * abs(ref),
              f"ladder {name}: first loss {first} vs {ref} without a mesh")
    ops.reset_launch_counts()               # just before the main path
    for i in range(1, 1 + LADDER_TIMED):
        for name in LADDER_RUNGS:
            per = step(name, i)
            for k in per:
                launches[name][k] += per[k]
    counts = ops.launch_counts()            # just after
    check(counts == {k: sum(launches[r][k] for r in LADDER_RUNGS)
                     for k in counts}, f"ladder: launches {counts}")
    for name, r in rows.items():
        check(all(np.isfinite(r["losses"])), f"ladder {name}: losses "
                                             f"{r['losses']}")
        p50 = float(np.median(r["step_s"][1:]))
        r.update(step_s_p50=p50, tokens_per_s=TRAIN_SHAPE.tokens / p50,
                 step_peak_extra_bytes=max(r["step_peak_extra_bytes"][1:]),
                 launches_per_step={k: v for k, v in want.items() if v},
                 launches_timed=launches[name])
    # ZeRO-3 against DDP+mixed after the same steps: on one rank every
    # gather and reduce-scatter is a copy and the norm is summed in the
    # same order, so the two programs compute the same numbers
    z3 = dict(states["DDP+mixed+sharded"].model.named_parameters())
    errs = {}
    for name, p in states["DDP+mixed"].model.named_parameters():
        scale = float(p.detach().abs().max()) or 1.0
        err = float((z3[name].detach() - p.detach()).abs().max())
        errs[name] = (err / scale, err, scale)
    worst = max(v[0] for v in errs.values())
    top = sorted(errs.items(), key=lambda kv: -kv[1][0])[:5]
    check(worst == 0.0, f"ladder: ZeRO-3's parameters differ from "
                        f"DDP+mixed's on one rank, by up to {worst} of a "
                        f"leaf's max-abs; largest {top}")
    grads = {n: p.grad for n, p in states["DP"].model.named_parameters()}
    ddp_params = {n: p.detach() for n, p in
                  states["DDP+mixed"].model.named_parameters()}
    bf16_launches = {k: launches["DDP+mixed"][k]
                     + launches["DDP+mixed+sharded"][k] for k in want}
    fields = {"rungs": rows,
              "DDP": "DP's program (hierarchical_allreduce only names the "
                     "rung; the step is the same), not timed twice",
              "first_step_without_mesh": no_mesh,
              "zero3_vs_ddp_mixed": {"worst_over_max_abs": worst,
                                     "bit_identical": worst == 0.0,
                                     "largest": top},
              "max_memory_allocated_all_states":
                  torch.cuda.max_memory_allocated()}
    del states, steps, z3
    return fields, bf16_launches, grads, (ddp_params, first_grads)


def _ladder_int8(mesh, grads):
    """(b): ``allreduce_int8_ef`` over the gradient tree on the one-rank
    group, bit for bit ``compress``'s math at world size 1, timed with CUDA
    events (encode, gather and decode of every leaf, host launch gaps
    included), beside ``hierarchy``'s prices of the exchange it stands for
    on each link class of the port's table."""
    traffic = hierarchy.Traffic()
    group = hierarchy.axis_group(mesh, ("data",), traffic)
    zeros = hierarchy.init_residual(grads)
    out, res = hierarchy.allreduce_int8_ef(grads, zeros, group)
    for n, g in grads.items():
        q, scale, new_r = compress.ef_compress_leaf(g, zeros[n])
        check(torch.equal(out[n], compress.int8_decode(q, scale))
              and torch.equal(res[n], new_r),
              f"ladder int8: {n} differs from compress's math")
    del out, res
    ms = []
    for _ in range(EF_REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        hierarchy.allreduce_int8_ef(grads, zeros, group)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    codec_ms = float(np.median(ms))
    nbytes = _tensor_bytes(grads.values())
    fast = DEFAULT_LINKS[LinkClass.LOCAL].bandwidth
    prices = {}
    for cls, link in DEFAULT_LINKS.items():
        for n in EF_WORLDS:
            # two pods of n / 2 cards on NVLink, joined by ``cls``; the int8
            # hop carries 1 / (n / 2) of the gradient, so of the codec too
            f = n // 2
            fp32 = hierarchy.hierarchical_time(nbytes, f, 2, fast,
                                               link.bandwidth) * 1e3
            int8 = hierarchy.hierarchical_time(
                nbytes, f, 2, fast, link.bandwidth,
                compress=1 / compress.compression_ratio()) * 1e3
            codec = codec_ms / f
            prices[f"{cls.value}/n{n}"] = {
                "slow_link_gb_per_s": link.bandwidth / 1e9,
                "flat_fp32_ms": hierarchy.flat_time(
                    nbytes, n, link.bandwidth) * 1e3,
                "hierarchical_fp32_ms": fp32,
                "hierarchical_int8_ms": int8,
                "codec_ms_on_the_slow_hop_share": codec,
                "int8_pays": fp32 - int8 > codec}
    return {"leaves": len(grads), "grad_bytes": nbytes,
            "bit_identical_to_compress": True, "codec_ms": ms,
            "codec_ms_p50": codec_ms,
            "codec_gb_per_s": nbytes / (codec_ms / 1e3) / 1e9,
            "collectives": traffic.report(), "prices": prices}


def _state_bytes_by_world():
    """(d): the bytes of parameters, gradients and both AdamW moments (fp32,
    ``TRAIN_POLICY``) each rank holds under ZeRO 0 / 1 / 3 at ``data`` =
    ``STATE_WORLDS``, from the specs (activations not counted), and the
    smallest world where they fit the card."""
    out = {}
    for arch in STATE_ARCHS:
        cfg = get_config(arch)
        meta = LM(cfg, device="meta")
        shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        full = sum(int(np.prod(s)) for s in shapes.values()) * 4
        rows = {}
        for zero in (0, 1, 3):
            pol = PolicyConfig(zero_stage=zero)
            per = {}
            for n in STATE_WORLDS:
                axes = {"data": n}
                ps = policy_mod.param_specs(meta, cfg, pol, axes)
                ms = policy_mod.opt_state_specs(meta, cfg, pol, axes)

                def local(specs):
                    return 4 * sum(int(np.prod(policy_mod.local_shape(
                        s, specs[k], axes))) for k, s in shapes.items())

                params = local(ps)
                per[n] = params + (params if zero >= 3 else full) \
                    + 2 * local(ms)
            fits = [n for n in STATE_WORLDS if per[n] <= CHIP.hbm_bytes]
            rows[f"zero{zero}"] = {"bytes_per_rank": per,
                                   "smallest_world_fitting": min(fits)
                                   if fits else None}
        out[arch] = {"params": full // 4, "n_layers": cfg.n_layers,
                     "hbm_bytes": CHIP.hbm_bytes, **rows}
    return out


def ladder_phase(rehearsal=None):
    """The ``ladder`` line: (a) ``_ladder_steps`` and the (q) rows, B2 at
    qwen2-0.5b's trained shape (2 x 4096 tokens, 14 heads over 2 of 64:
    G = 7) against its plain versions with the bound and
    ``scaled_dot_product_attention``'s time; (b) ``_ladder_int8``; (c) the
    four-rank ``gloo`` rehearsal on the host's CPU
    (``rehearse.rehearse``: ZeRO-3 against DP on ``data`` = 4, the int8
    exchange on ``(pod, data) = (2, 2)``, a checkpoint saved on four ranks
    and resumed on two: ``rehearsal``, a future of it that ``main``
    starts after the build, else run here); (d) ``_state_bytes_by_world``.
    Returns the (q) rows, the bf16 rungs' launches, the ``tp`` line's
    rung (``_tp_rung``, timed inside the ladder's one-rank group) and the
    rehearsal's result."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    cfg = get_config(LADDER_ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    with torch.no_grad():
        *q_rows, q_faults = bwd_main_shape(gen, cfg, *TRAIN_SHAPE_BS)
    torch.cuda.empty_cache()
    t_rows = time.perf_counter()
    # one rank: NCCL still runs every collective, shard and gather
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device="cuda")
        try:
            make_production_mesh()
            check(False, "ladder: a production mesh of 256 on one rank")
        except RuntimeError as e:
            check("need 256 devices" in str(e), f"ladder: {e}")
        fields, launches, grads, ddp = _ladder_steps(cfg, mesh)
        t_steps = time.perf_counter()
        int8 = _ladder_int8(mesh, grads)
        del grads
        torch.cuda.empty_cache()
        t_int8 = time.perf_counter()
        # the same rung with the model axis: the ``tp`` line's part (d)
        tp_rung = _tp_rung(cfg, make_mesh((1, 1), ("data", "model"),
                                          device="cuda"), fields, *ddp)
    finally:
        dist.destroy_process_group()
    del ddp
    torch.cuda.empty_cache()
    t_tp = time.perf_counter()
    rehearsal = (rehearse.rehearse() if rehearsal is None
                 else rehearsal.result())
    check(rehearsal["ok"], f"ladder: the four-rank rehearsal failed "
                           f"{rehearsal}")
    t_rehearsal = time.perf_counter()
    states = _state_bytes_by_world()
    emit("ladder", arch=cfg.name, n_layers=cfg.n_layers,
         params=cfg.param_count(), batch=TRAIN_SHAPE.global_batch,
         seq=TRAIN_SHAPE.seq_len, mesh={"data": 1}, backend="nccl",
         param_dtype="float32", remat="block", **fields,
         launches_bf16_rungs_timed=launches,
         b2_at_this_shape={"planted_faults_rejected": q_faults},
         int8_ef=int8, rehearsal_four_gloo_ranks=rehearsal,
         state_bytes_per_rank=states,
         phase_s={"b2_rows": t_rows - t0, "steps": t_steps - t_rows,
                  "int8": t_int8 - t_steps, "tp_rung": t_tp - t_int8,
                  "rehearsal_wait": t_rehearsal - t_tp,
                  "total": time.perf_counter() - t0})
    return q_rows, launches, tp_rung, rehearsal


# ---------------------------------------------------------------------------
# tensor and expert parallelism on a one-rank (data, model) mesh
# ---------------------------------------------------------------------------
TP_LENS = (128, 256, 384, 512)      # llama3.2-3b's prompts, dense serving
TP_MAX_NEW = 32
TP_MAX_SEQ = 640
TP_SSM_BATCH = (4, 1024)            # mamba2-780m's prefill batch
TP_MOE_BATCH = (2, 512)             # moonshot's prefill batch
TP_WORLDS = (2, 4, 8)               # model axis sizes priced from the specs
TP_SERVE_ARCHS = ("command-r-35b", "llama4-scout-17b-a16e")
TP_SERVE_SLOTS = (8, 4096)          # slots x cache length priced
TP_TRAIN_ARCHS = ("stablelm-12b", "moonshot-v1-16b-a3b")
# (d) against the ladder's DDP+mixed rung.  On one rank the forward keeps
# its order (the first loss bit for bit) and the backward does not: B2 on
# K/V repeated to H (G = 1) writes each head's dK / dV in bf16 and the
# repeat's backward sums the group, where the G = 7 kernel sums the group's
# heads in fp32 registers.  So step 0's gradients (the same parameters and
# batch) are held leaf by leaf, relative Frobenius, at a few bf16 roundings
# (0.0036 read, on wk): a zeroed, sign-flipped or rescaled leaf is 1 or more
# off.  ``rehearse.NOISE_LEAVES`` are not held there: a key bias cancels in
# the softmax, its gradient is rounding noise.  The later losses and every
# step's gradient norm are held at about 5x what was read (2.1e-5, 1.7e-4);
# the parameters only within 2 lr a step, as AdamW divides each element's
# gradient by its own RMS and moves an element whose gradient is of the
# order of the rounding by up to lr.
TP_RUNG_LOSS_TOL = 1e-4             # relative
TP_RUNG_NORM_TOL = 1e-3             # relative
TP_RUNG_GRAD_TOL = 1e-2             # relative Frobenius, each leaf


def _tp_ctx(mesh):
    return ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")


def _tp_logits_cmp(got, want):
    """Bit identity, else the largest difference over the largest value."""
    same = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max()) or 1.0
    return {"bit_identical": same, "max_abs_err": err,
            "max_abs_err_over_max": err / scale,
            "tokens_equal": bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1)))}


def _tp_prefill(cfg, model, policy, tokens, mesh):
    """One prefill batch without a mesh and on ``mesh`` (the same model:
    on one rank every piece is the whole leaf), the launches of the mesh
    run, its collectives."""
    S = tokens.shape[1]
    plain = make_prefill_step(cfg, policy, cache_capacity=S)
    pctx = _tp_ctx(mesh)
    tp = make_prefill_step(cfg, policy, cache_capacity=S, mesh=mesh,
                           pctx=pctx)
    with torch.no_grad():
        want = plain(model, tokens)[0]
        torch.cuda.synchronize()
        ops.reset_launch_counts()           # just before the mesh path
        got = tp(model, tokens)[0]
        torch.cuda.synchronize()
        counts = ops.launch_counts()        # just after
    return dict(_tp_logits_cmp(got, want),
                launches={k: v for k, v in counts.items() if v},
                collectives=pctx.traffic.report())


def _tp_moe(cfg, model):
    """(c) moonshot at its served depth: one prefill batch through
    ``_moe_ep`` (``make_run_ctx`` picks ``"ep"`` on the mesh) against the
    sorted path without a mesh; the next tokens must be equal."""
    t0 = time.perf_counter()
    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    B, S = TP_MOE_BATCH
    tokens = torch.tensor(np.random.RandomState(31).randint(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    with one_rank(device=DEV) as mesh:
        check(trainer.make_run_ctx(cfg, policy, mesh).moe_impl == "ep",
              "tp moe: the mesh run context is not expert-parallel")
        out = _tp_prefill(cfg, model, policy, tokens, mesh)
    check(out["tokens_equal"], f"tp moe: _moe_ep's next tokens differ from "
                               f"moe_sorted's: {out}")
    # one rank keeps the no-mesh path's order: the same bits
    check(out["bit_identical"], f"tp moe: _moe_ep's logits differ from "
                                f"moe_sorted's: {out}")
    check(out["launches"].get("flash_attention") == cfg.n_layers,
          f"tp moe: flash launches {out['launches']}")
    return dict(out, arch=cfg.name, n_layers=cfg.n_layers, batch=[B, S],
                phase_s=time.perf_counter() - t0)


def _tp_rung(cfg, mesh, ladder, ddp_params, first_grads):
    """(d) qwen2-0.5b whole, the ladder's DDP+mixed rung on ``mesh``
    ((data, model) = (1, 1)): one warm-up and ``LADDER_TIMED`` steps on the
    ladder's batches, held to that rung's losses, gradient norms, step 0's
    gradients ``first_grads`` and parameters as ``TP_RUNG_*`` say."""
    t0 = time.perf_counter()
    base = PolicyConfig(param_dtype="float32", remat="block",
                        attn_impl="kernel", dp_axes=("data",))
    pol = policy_mod.ladder(base)["DDP+mixed"]
    optcfg = AdamWConfig(lr=LADDER_LR)
    sched = ScheduleConfig(kind="cosine", peak_lr=LADDER_LR, warmup_steps=1,
                           total_steps=1 + LADDER_TIMED)
    ds = SyntheticDataset(cfg, TRAIN_SHAPE, seed=0)
    state = trainer.init_state(cfg, pol, optcfg, seed=0, device=DEV,
                               mesh=mesh)
    step = trainer.make_train_step(cfg, pol, optcfg, sched, mesh=mesh,
                                   shape=TRAIN_SHAPE)
    losses, norms, step_s, traffic = [], [], [], None
    n = cfg.n_layers
    want_launches = dict({k: 0 for k in ops.launch_counts()},
                         flash_attention_fwd_stats=2 * n,
                         flash_attention_bwd_dkv=n,
                         flash_attention_bwd_dq=n)
    for i in range(1 + LADDER_TIMED):
        if i == 1:
            ops.reset_launch_counts()       # just before the timed steps
        step.traffic.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, ds.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        traffic = step.traffic.report()
        if i == 0:
            # the same parameters and batch: each leaf's gradient against
            # DDP+mixed's, relative Frobenius
            grad_err = {
                name: float((p.grad - first_grads[name]).norm()
                            / first_grads[name].norm().clamp_min(1e-30))
                for name, p in state.model.named_parameters()
                if not any(name.endswith(leaf)
                           for leaf in rehearse.NOISE_LEAVES)}
    counts = ops.launch_counts()            # just after
    check(counts == {k: LADDER_TIMED * v for k, v in want_launches.items()},
          f"tp rung: launches {counts}")
    rung = ladder["rungs"]["DDP+mixed"]
    want, want_norms = rung["losses"], rung["grad_norms"]
    bound = 2 * LADDER_LR * (1 + LADDER_TIMED)
    params_worst = max(float((p.detach() - ddp_params[name]).abs().max())
                       for name, p in state.model.named_parameters())
    grad_worst = max(grad_err.values())
    top = dict(sorted(grad_err.items(), key=lambda kv: -kv[1])[:5])
    check(losses[0] == want[0],
          f"tp rung: first loss {losses[0]} vs the ladder's {want[0]}")
    check(all(abs(a - b) <= TP_RUNG_LOSS_TOL * abs(b)
              for a, b in zip(losses, want)),
          f"tp rung: losses {losses} vs the ladder's {want} "
          f"(> {TP_RUNG_LOSS_TOL})")
    norm_err = max(abs(a - b) / b for a, b in zip(norms, want_norms))
    check(norm_err <= TP_RUNG_NORM_TOL,
          f"tp rung: grad norms {norms} vs the ladder's {want_norms} "
          f"(> {TP_RUNG_NORM_TOL})")
    check(grad_worst <= TP_RUNG_GRAD_TOL,
          f"tp rung: step 0's gradients differ from the ladder's DDP+mixed "
          f"by {grad_worst} (relative Frobenius, > {TP_RUNG_GRAD_TOL}); "
          f"largest {top}")
    check(params_worst <= bound,
          f"tp rung: parameters differ from the ladder's DDP+mixed by "
          f"{params_worst} > {bound}")
    p50 = float(np.median(step_s[1:]))
    return {"arch": cfg.name, "n_layers": n, "rung": "DDP+mixed",
            "mesh": {"data": 1, "model": 1}, "losses": losses,
            "ladder_losses": want,
            "losses_bit_identical": [a == b for a, b in zip(losses, want)],
            "grad_norms": norms, "ladder_grad_norms": want_norms,
            "grad_norm_err_rel": norm_err,
            "grad_norm_tol_rel": TP_RUNG_NORM_TOL,
            "step0_grads_vs_ladder": {
                "worst_rel_fro": grad_worst, "tol": TP_RUNG_GRAD_TOL,
                "noise_leaves_not_held": list(rehearse.NOISE_LEAVES),
                "largest": top},
            "params_vs_ladder_max_abs": params_worst,
            "params_bound_2_lr_a_step": bound,
            "loss_tol_rel": TP_RUNG_LOSS_TOL,
            "step_s": step_s, "step_s_p50": p50,
            "tokens_per_s": TRAIN_SHAPE.tokens / p50,
            "launches_timed": {k: v for k, v in counts.items() if v},
            "collectives_per_step": traffic,
            "phase_s": time.perf_counter() - t0}


def _tp_serve_round(cfg, model, policy, mesh, prompts, max_new=TP_MAX_NEW):
    """``ServeEngine`` (dense slots) on ``mesh`` or none: every prompt
    prefilled (TTFT: the prefill and its token read back), then decode
    steps until every request has ``max_new`` tokens (TPOT: a step)."""
    eng = ServeEngine(cfg, model, policy, n_slots=len(prompts),
                      max_seq=TP_MAX_SEQ, mesh=mesh, device=DEV)
    reqs = [Request(i, torch.tensor(p, dtype=torch.int32, device=DEV),
                    max_new=max_new) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()               # just before the path
    ttft, tpot = [], []
    for r in reqs:
        t = time.perf_counter()
        check(eng.add_request(r), "tp serve: no free slot")
        ttft.append(time.perf_counter() - t)
    while any(not r.done for r in reqs):
        t = time.perf_counter()
        eng.step()
        tpot.append(time.perf_counter() - t)
    counts = ops.launch_counts()            # just after
    return {"mesh": mesh is not None, "streams": [r.out for r in reqs],
            "ttft_s": ttft, "ttft_p50_s": float(np.median(ttft)),
            "tpot_p50_s": float(np.median(tpot)), "decode_steps": len(tpot),
            "flash_attention_launches": counts["flash_attention"],
            "launches": {k: v for k, v in counts.items() if v},
            "collectives": (eng.place.traffic.report()
                            if eng.place is not None else None)}


def _tp_serve(mesh):
    """(a) llama3.2-3b at full width, dense ``ServeEngine`` on ``mesh``
    against ``mesh=None`` in turns (mesh, none, none, mesh) from one
    model: greedy streams equal, TTFT / TPOT p50 and flash launches of
    each; then (h), ``_tp_paged``, on the same model."""
    cfg = get_config(ARCH)
    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    prompts = [_prompt(300 + i, n, cfg.vocab_size)
               for i, n in enumerate(TP_LENS)]
    rounds = [_tp_serve_round(cfg, model, policy, m, prompts)
              for m in (mesh, None, None, mesh)]
    t_dense = time.perf_counter()
    paged = _tp_paged(mesh, cfg, model, policy)
    paged["phase_s"] = time.perf_counter() - t_dense
    del model
    torch.cuda.empty_cache()
    want = rounds[1]["streams"]
    for r in rounds:
        check(r.pop("streams") == want,
              "tp serve: greedy streams on the mesh differ from those "
              "without")
        check(r["flash_attention_launches"] == len(TP_LENS) * cfg.n_layers,
              f"tp serve: flash launches {r['flash_attention_launches']}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "prompt_lens": list(TP_LENS), "max_new": TP_MAX_NEW,
            "streams_equal": True, "rounds_mesh_none_none_mesh": rounds}, \
        paged


def _tp_ssm(mesh):
    """(b) mamba2-780m: one prefill batch through ``ssd_sharded``."""
    cfg = get_config(SSM_ARCH)
    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    B, S = TP_SSM_BATCH
    tokens = torch.tensor(np.random.RandomState(32).randint(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    out = _tp_prefill(cfg, model, policy, tokens, mesh)
    del model
    torch.cuda.empty_cache()
    check(out["launches"].get("ssd") == cfg.n_layers,
          f"tp ssm: ssd launches {out['launches']}")
    # one rank keeps the no-mesh path's order: the same bits
    check(out["bit_identical"], f"tp ssm: logits {out}")
    return dict(out, arch=cfg.name, n_layers=cfg.n_layers, batch=[B, S])


def _tp_host_us(mesh, reps=200):
    """Host microseconds of what every tensor-parallel block repeats on the
    one-rank group: one all-reduce of a decode step's (4, 1, 3072) bf16
    activation, a *copy* and a *reduce* of it (autograd functions), and a
    ``ParallelCtx.cut`` of a whole leaf (perf_counter over ``reps`` calls,
    one synchronize at the end)."""
    pctx = _tp_ctx(mesh)
    x = torch.zeros(4, 1, get_config(ARCH).d_model, dtype=torch.bfloat16,
                    device=DEV)
    w = torch.zeros(64, 8, 128, device=DEV)
    calls = {"all_reduce": lambda: hierarchy.all_reduce(x, pctx.tp_group),
             "copy_then_reduce": lambda: pctx.reduce(pctx.copy(x)),
             "cut": lambda: pctx.cut(w, 1, 8)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_us"] = (time.perf_counter() - t) / reps * 1e6
    return out


def _tp_repeat_cost():
    """B1 at llama3.2-3b's prefill shapes (S = 512, 2048): GQA's 8 K/V heads
    (G = 3) against the 24 that ``sharded_flash`` repeats them to (G = 1),
    timed in turns, and the bytes each reads."""
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    for S in (512, 2048):
        q = _randn(gen, 1, S, H, D, dtype=torch.bfloat16)
        k, v = (_randn(gen, 1, S, K, D, dtype=torch.bfloat16)
                for _ in range(2))
        kr, vr = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
        gqa = lambda: flash_attention(q, k, v, causal=True)     # noqa: E731
        rep = lambda: flash_attention(q, kr, vr, causal=True)   # noqa: E731
        same = _tp_logits_cmp(rep(), gqa())
        check(same["max_abs_err_over_max"] <= 2e-2,
              f"tp: B1 at G = 1 on the repeated K/V against G = 3 (S={S}): "
              f"{same}")
        ms_rep, ms_gqa = time_in_turns(rep, gqa, 20)
        kv = 2 * S * D * 2
        out[f"S{S}"] = {"gqa_ms": ms_gqa, "repeated_ms": ms_rep,
                        "kv_bytes_gqa": K * kv, "kv_bytes_repeated": H * kv,
                        "ratio": ms_rep / ms_gqa,
                        "bit_identical": same["bit_identical"],
                        "max_abs_err": same["max_abs_err"]}
    return out


def _tp_bytes():
    """(e) arithmetic: the bytes a rank holds at ``model`` = 2 / 4 / 8 from
    the specs -- serving: bf16 parameters (``sharding.Layout.use_specs``:
    the pieces a rank computes with) and its piece of the bf16 caches
    (``cache_specs``) of ``TP_SERVE_SLOTS``; training: fp32 parameters,
    gradients and both AdamW moments (ZeRO 0 at ``data`` = 1, ZeRO-3 at
    ``data`` = 8)."""
    from repro_torch.models import transformer as transformer_mod
    from repro_torch.train import sharding
    out = {"serving_bf16": {}, "training_fp32": {}}
    for arch in TP_SERVE_ARCHS:
        cfg = get_config(arch)
        meta = LM(cfg, device="meta")
        shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        caches = transformer_mod.init_stack_cache(cfg, *TP_SERVE_SLOTS,
                                                  device="meta")
        row = {"params_whole_bytes": 2 * sum(int(np.prod(s))
                                             for s in shapes.values())}
        for m in TP_WORLDS:
            axes = {"data": 1, "model": m}
            pol = PolicyConfig(zero_stage=0)
            specs = sharding.specs(meta, cfg, pol, axes)[0]
            params = 2 * sum(int(np.prod(policy_mod.local_shape(
                s, specs[n], axes))) for n, s in shapes.items())
            cspecs = policy_mod.stack_cache_specs(cfg, caches, pol, axes)
            cache = sum(int(np.prod(policy_mod.local_shape(
                t.shape, cspecs[i][n], axes))) * 2
                for i, layer in enumerate(caches) for n, t in layer.items())
            row[f"model{m}"] = {"params_bytes": params, "cache_bytes": cache,
                                "fits": params + cache <= CHIP.hbm_bytes}
        out["serving_bf16"][arch] = row
    for arch in TP_TRAIN_ARCHS:
        cfg = get_config(arch)
        meta = LM(cfg, device="meta")
        shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        row = {}
        for m in TP_WORLDS:
            for data, zero in ((1, 0), (8, 3)):
                axes = {"data": data, "model": m}
                pol = PolicyConfig(zero_stage=zero)
                ps, ms = sharding.specs(meta, cfg, pol, axes)

                def local(specs):
                    return 4 * sum(int(np.prod(policy_mod.local_shape(
                        s, specs[n], axes))) for n, s in shapes.items())
                total = 2 * local(ps) + 2 * local(ms)
                row[f"data{data}_model{m}_zero{zero}"] = {
                    "bytes_per_rank": total,
                    "fits": total <= CHIP.hbm_bytes}
        out["training_fp32"][arch] = row
    out["hbm_bytes"] = CHIP.hbm_bytes
    out["what"] = ("arithmetic from the specs, not measured: activations "
                   "and workspace not counted")
    return out


# ---------------------------------------------------------------------------
# the rest of tensor parallelism: the ``tp`` line's (f) - (j)
# ---------------------------------------------------------------------------
# (g): recurrentgemma-2b's DDP+mixed rung on a one-rank data mesh, the same
# with B1 / B2 on K/V repeated to its 10 heads (``_repeat_kv_attend``: the
# order in which the model axis sums a KV head's dK / dV, each head's in
# bf16 and the group by the repeat's backward, where the G = 10 kernel sums
# the group in fp32 registers), and on a one-rank (data, model) mesh.  The
# model axis must equal the repeated K/V bit for bit through every update:
# then the whole of its drift from the data mesh is that order's.  On the
# H100 (scripts/probe_variant.py tp_hybrid_drift, warm-up + 3 steps) the
# model axis equalled the repeated K/V bit for bit, both drifted from the
# data mesh by 3.8e-4 and 9.8e-4 in the losses after the first and second
# update and by up to 6.0e-3 in the norms, and in fp32 the two meshes
# agreed within 2.0e-7 (losses) and 1.0e-6 (norms).  So the model axis is
# held to the data mesh at about 3x those bf16 readings (TP_RUNG_*'s 1e-4 /
# 1e-3 hold qwen2, whose drift is 2.1e-5 / 1.7e-4), step 0's gradients at
# TP_RUNG_GRAD_TOL (7.4e-3 read) and the parameters within 2 lr a step
# (3.1 lr after 3 steps read), as ``_tp_rung`` holds qwen2's.
TP_HYB_LOSS_TOL = 3e-3              # relative
TP_HYB_NORM_TOL = 2e-2              # relative
TP_HYB_MAX_NEW = 16                 # (f): eager decode steps on the mesh
TP_PAGED_MAX_NEW = 16               # (h): eager steps on both sides
TP_HYB_WORLDS = (2, 4, 8, 16)       # recurrentgemma's model axes priced
# (i): the per-rank shapes a wider model axis launches -- recurrentgemma's
# RG-LRU channels (W = 2560 over 2, 4) and its 10 query heads at G = 1,
# padded to 10 and 12 and split over 2 and 4; the paged decode on a rank's
# heads (llama3.2-3b: 24 / 8 over 2, 4; stablelm-12b: 32 / 8 over 2)
TP_RGLRU_RANK = ((2, (1, 4096, 1280)), (4, (1, 4096, 640)))
TP_RGLRU_BWD_RANK = ((2, (2, 4096, 1280)),)
TP_ATTN_RANK = ((2, 5), (4, 3))
TP_PAGED_RANK = ((ARCH, 2, 12, 4, 128), (ARCH, 4, 6, 2, 128),
                 (STABLELM_ARCH, 2, 16, 4, 160))


def _counts(cfg):
    """The RG-LRU and windowed-attention layers of ``cfg``."""
    return (sum(b == RGLRU for b in cfg.pattern),
            sum(b == ATTN_LOCAL for b in cfg.pattern))


def _tp_hybrid(mesh):
    """(f) recurrentgemma-2b whole (26 layers, W = 2560, bf16 serving):
    dense ``ServeEngine`` on ``mesh`` against ``mesh=None`` in turns (mesh,
    none, none, mesh) from one model: greedy streams equal, TTFT / TPOT p50
    of each, the RG-LRU (B5) and windowed flash (B1 at D = 256, window
    2048; G = 1 on K/V repeated to 10 heads on the mesh) launches a
    round."""
    cfg = get_config(HYBRID_ARCH)
    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    prompts = [_prompt(400 + i, n, cfg.vocab_size)
               for i, n in enumerate(TP_LENS)]
    rounds = [_tp_serve_round(cfg, model, policy, m, prompts,
                              max_new=TP_HYB_MAX_NEW)
              for m in (mesh, None, None, mesh)]
    del model
    torch.cuda.empty_cache()
    n_rg, n_at = _counts(cfg)
    want = rounds[1]["streams"]
    for r in rounds:
        check(r.pop("streams") == want,
              "tp hybrid: greedy streams on the mesh differ from those "
              "without")
        check(r["launches"].get("rglru") == len(TP_LENS) * n_rg
              and r["flash_attention_launches"] == len(TP_LENS) * n_at,
              f"tp hybrid: launches {r['launches']}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "window": cfg.local_window, "prompt_lens": list(TP_LENS),
            "max_new": TP_HYB_MAX_NEW, "streams_equal": True,
            "rounds_mesh_none_none_mesh": rounds}


def _digest(t):
    """A position-weighted sum of a float32 tensor's bits: equal digests
    are, but for a 2^-64 chance, equal tensors."""
    bits = t.detach().contiguous().view(torch.int32).flatten().long()
    return int((bits * (torch.arange(bits.numel(), device=t.device)
                        % 1000003 + 1)).sum())


def _repeat_kv_attend(attend):
    """``attention._attend`` with GQA K/V repeated to H first (G = 1):
    ``sharded_flash``'s order of summing a KV head's dK / dV, without a
    mesh."""
    def repeated(q, k, v, **kw):
        G = q.shape[2] // k.shape[2]
        return attend(q, attention_mod._repeat_heads(k, G),
                      attention_mod._repeat_heads(v, G), **kw)
    return repeated


def _tp_hybrid_rung():
    """(g) recurrentgemma-2b whole, the ladder's DDP+mixed rung at 2 x 4096
    tokens, a warm-up at lr 0 and ``LADDER_TIMED`` steps on each of: a
    one-rank ``data`` mesh, the same with K/V repeated to H
    (``_repeat_kv_attend``) and a one-rank ``(data, model)`` mesh, from the
    same seed, one after the other (two states do not fit).  The model axis against the repeated K/V
    bit for bit (losses, norms, step 0's gradients, the last parameters);
    against the data mesh the first two losses (the initial parameters)
    bit for bit, the rest and the norms within ``TP_HYB_*``, step 0's
    gradients leaf by leaf (the RG-LRU leaves among them) within
    ``TP_RUNG_GRAD_TOL`` and the parameters within 2 lr a step; the B5,
    ``rglru_bwd`` and B2 launches of each run's timed steps."""
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    base = PolicyConfig(param_dtype="float32", remat="block",
                        attn_impl="kernel", dp_axes=("data",))
    pol = policy_mod.ladder(base)["DDP+mixed"]
    optcfg = AdamWConfig(lr=LADDER_LR)
    sched = ScheduleConfig(kind="cosine", peak_lr=LADDER_LR, warmup_steps=1,
                           total_steps=1 + LADDER_TIMED)
    ds = SyntheticDataset(cfg, TRAIN_SHAPE, seed=0)
    n_rg, n_at = _counts(cfg)
    # per step: the forward twice (remat), the backward once
    per_step = {"rglru": 2 * n_rg, "rglru_bwd": n_rg,
                "flash_attention_fwd_stats": 2 * n_at,
                "flash_attention_bwd_dkv": n_at,
                "flash_attention_bwd_dq": n_at}
    runs, ref, attend = {}, None, attention_mod._attend
    for name, shape, axes in (("data", (1,), ("data",)),
                              ("data_repeat", (1,), ("data",)),
                              ("data_model", (1, 1), ("data", "model"))):
        if name == "data_repeat":
            attention_mod._attend = _repeat_kv_attend(attend)
        try:
            with one_rank(shape, axes, device=DEV) as mesh:
                state = trainer.init_state(cfg, pol, optcfg, seed=0,
                                           device=DEV, mesh=mesh)
                step = trainer.make_train_step(cfg, pol, optcfg, sched,
                                               mesh=mesh, shape=TRAIN_SHAPE)
                losses, norms, step_s = [], [], []
                for i in range(1 + LADDER_TIMED):
                    if i == 1:
                        ops.reset_launch_counts()   # just before the timed
                    step.traffic.reset()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    state, m = step(state, ds.batch_at(i))
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    if i == 0:
                        grads = {n: p.grad for n, p in
                                 state.model.named_parameters()}
                        digests = {n: _digest(g) for n, g in grads.items()}
                        if ref is None:
                            ref = {"grads": {n: g.to("cpu", copy=True)
                                             for n, g in grads.items()}}
                        elif name == "data_model":
                            grad_err = {
                                n: float((g - ref["grads"][n].to(DEV)).norm()
                                         / ref["grads"][n].norm()
                                         .clamp_min(1e-30))
                                for n, g in grads.items()
                                if not any(n.endswith(leaf) for leaf
                                           in rehearse.NOISE_LEAVES)}
                        del grads
                counts = ops.launch_counts()        # just after
                traffic = step.traffic.report()
                params = dict(state.model.named_parameters())
                run = {"mesh": dict(zip(axes, shape)), "losses": losses,
                       "grad_norms": norms, "step_s": step_s,
                       "step0_grad_digests": digests,
                       "param_digests": {n: _digest(p)
                                         for n, p in params.items()}}
                if name == "data":
                    ref["params"] = {n: p.detach().to("cpu", copy=True)
                                     for n, p in params.items()}
                elif name == "data_model":
                    params_worst = max(
                        float((p.detach() - ref["params"][n].to(DEV))
                              .abs().max()) for n, p in params.items())
                del state, step, params
                torch.cuda.empty_cache()
        finally:
            attention_mod._attend = attend
        check(counts == {k: LADDER_TIMED * per_step.get(k, 0)
                         for k in counts},
              f"tp hybrid rung ({name}): launches {counts}")
        p50 = float(np.median(step_s[1:]))
        runs[name] = dict(run, step_s_p50=p50,
                          tokens_per_s=TRAIN_SHAPE.tokens / p50,
                          launches_timed={k: v for k, v in counts.items()
                                          if v},
                          collectives_per_step=traffic)
    del ref
    got, rep, want = runs["data_model"], runs["data_repeat"], runs["data"]
    for key in ("losses", "grad_norms", "step0_grad_digests",
                "param_digests"):
        a, b = got[key], rep[key]
        differ = ([n for n in b if a[n] != b[n]][:5] if isinstance(b, dict)
                  else (a, b) if a != b else None)
        check(not differ, f"tp hybrid rung: the model axis's {key} differ "
                          f"from the data mesh's with K/V repeated: {differ}")
    check(got["losses"][:2] == want["losses"][:2],
          f"tp hybrid rung: first losses {got['losses'][:2]} vs "
          f"{want['losses'][:2]}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       want["losses"]))
    check(loss_err <= TP_HYB_LOSS_TOL,
          f"tp hybrid rung: losses {got['losses']} vs {want['losses']} "
          f"(> {TP_HYB_LOSS_TOL})")
    norm_err = max(abs(a - b) / b for a, b in zip(got["grad_norms"],
                                                  want["grad_norms"]))
    check(norm_err <= TP_HYB_NORM_TOL,
          f"tp hybrid rung: grad norms {got['grad_norms']} vs "
          f"{want['grad_norms']} (> {TP_HYB_NORM_TOL})")
    worst = max(grad_err.values())
    top = dict(sorted(grad_err.items(), key=lambda kv: -kv[1])[:5])
    check(worst <= TP_RUNG_GRAD_TOL,
          f"tp hybrid rung: step 0's gradients differ by {worst} (relative "
          f"Frobenius, > {TP_RUNG_GRAD_TOL}); largest {top}")
    bound = 2 * LADDER_LR * (1 + LADDER_TIMED)
    check(params_worst <= bound,
          f"tp hybrid rung: parameters differ from the data mesh's by "
          f"{params_worst} > {bound}")
    rg_leaves = {n: e for n, e in grad_err.items() if ".rglru." in n}
    for r in runs.values():
        for key in ("step0_grad_digests", "param_digests"):
            r.pop(key)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "rung": "DDP+mixed",
            "tokens_a_step": TRAIN_SHAPE.tokens, "runs": runs,
            "model_vs_repeat_bit_identical": True,
            "losses_bit_identical": [a == b for a, b in zip(
                got["losses"], want["losses"])],
            "loss_err_rel": loss_err, "loss_tol_rel": TP_HYB_LOSS_TOL,
            "grad_norm_err_rel": norm_err,
            "grad_norm_tol_rel": TP_HYB_NORM_TOL,
            "step0_grads": {"worst_rel_fro": worst, "tol": TP_RUNG_GRAD_TOL,
                            "largest": top,
                            "rglru_leaves_worst": max(rg_leaves.values()),
                            "rglru_leaves_held": len(rg_leaves)},
            "params_vs_data_max_abs": params_worst,
            "params_bound_2_lr_a_step": bound,
            "phase_s": time.perf_counter() - t0}


def _tp_paged(mesh, cfg, model, policy):
    """(h) llama3.2-3b whole: ``AsyncServeEngine(mode="paged")`` on
    ``mesh`` (heads and each rank's pool over ``model``) against no mesh,
    both eager, on ``serve_paged``'s prompts with ``TP_PAGED_MAX_NEW`` new
    tokens: streams equal, the paged decode (B3) launches, TTFT / TPOT."""
    prompts = _paged_prompts(cfg)
    rounds = []
    for m in (mesh, None):
        eng = AsyncServeEngine(cfg, model, policy, device=DEV, mesh=m,
                               graphs=False, **PAGED_KW)
        eng.warmup()
        reqs = [ServeRequest(i, p, max_new=TP_PAGED_MAX_NEW)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()           # just before the path
        t0 = time.perf_counter()
        for r in reqs:
            check(eng.submit(r), f"tp paged: request {r.rid} rejected")
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()        # just after
        rep = eng.report()
        check(all(r.done for r in reqs), "tp paged: a request is not served")
        n = counts["paged_decode_attention"]
        check(n > 0 and n == rep["decode_iterations"] * cfg.n_layers,
              f"tp paged: paged launches {n}, decode iterations "
              f"{rep['decode_iterations']}")
        rounds.append({"mesh": m is not None,
                       "streams": [list(r.out) for r in reqs],
                       "wall_s": wall, "ttft_p50_s": rep["ttft_s"]["p50"],
                       "tpot_p50_s": rep["tpot_s"]["p50"],
                       "decode_iterations": rep["decode_iterations"],
                       "paged_decode_attention_launches": n,
                       "launches": {k: v for k, v in counts.items() if v},
                       "pool_kv_heads": eng.pool.pages[0]["k"].shape[2],
                       "collectives": (eng.place.traffic.report()
                                       if eng.place is not None else None)})
        del eng
        torch.cuda.empty_cache()
    want = rounds[1].pop("streams")
    check(rounds[0].pop("streams") == want,
          "tp paged: greedy streams on the mesh differ from those without")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "requests": len(prompts), "max_new": TP_PAGED_MAX_NEW,
            "graphs": False, "streams_equal": True, "rounds_mesh_none":
            rounds}


def tp_rank_kernel_cases(gen):
    """(i) each kernel at the per-rank shapes a wider ``model`` axis would
    launch (``TP_*_RANK``), held to its plain version on the card, timed
    with CUDA events over a graph of launches, beside its bound and the
    library call where one computes the same.  Keyed
    ``<kernel>_model<tp>``."""
    rows = {}
    for tp, shape in TP_RGLRU_RANK:
        rows[f"rglru_model{tp}"] = rglru_main_shape(gen, shape)
    for tp, shape in TP_RGLRU_BWD_RANK:
        rows[f"rglru_bwd_model{tp}"] = rglru_bwd_main_shape(gen, shape)
    torch.cuda.empty_cache()
    B, S, T, _, _, D, causal, window, dt = ATTN_SERVED
    for tp, H in TP_ATTN_RANK:
        # G = 1: K/V repeated to the rank's heads
        rows[f"flash_attention_d256_model{tp}"] = flash_d256_main_shape(
            gen, (B, S, T, H, H, D, causal, window, dt))
        heads = types.SimpleNamespace(name=f"{HYBRID_ARCH} model={tp}",
                                      n_heads=H, n_kv_heads=H, head_dim=D)
        *got, _ = bwd_main_shape(gen, heads, *TRAIN_SHAPE_BS, window=window)
        for name, row in zip(TRAIN_KERNELS, got):
            rows[f"{name}_d256_model{tp}"] = row
        torch.cuda.empty_cache()
    for arch, tp, H, K, D in TP_PAGED_RANK:
        row = paged_main_shape(gen, types.SimpleNamespace(
            name=f"{arch} model={tp}", n_heads=H, n_kv_heads=K,
            head_dim=D))
        rows[f"paged_decode_attention{'_d160' if D == 160 else ''}"
             f"_model{tp}"] = row
    return rows


def _moe_data_only_step(cfg):
    """(j) moonshot at its training cut, one ZeRO-3 step of 2 x 4096 tokens
    on a one-rank ``data`` mesh (the experts gathered as any other leaf;
    MoE sorted in the global batch's order: the per-expert counts gathered
    over ``data``) against the same step without
    a mesh, one after the other (two states do not fit): the loss, aux and
    gradient norm equal, and each parameter after the step equal, bit for
    bit (a position-weighted sum of its bits)."""
    t0 = time.perf_counter()
    cfg = cut_depth(cfg, MOE_TRAIN_LAYERS)
    pol = PolicyConfig(compute_dtype="bfloat16", param_dtype="float32",
                       remat="block", attn_impl="kernel", dp_axes=("data",),
                       zero_stage=3)
    optcfg = AdamWConfig(lr=MOE_TRAIN_LR)
    batch = SyntheticDataset(cfg, TRAIN_SHAPE, seed=0).batch_at(0)

    def run(mesh):
        state = trainer.init_state(cfg, pol, optcfg, seed=0, device=DEV,
                                   mesh=mesh)
        step = trainer.make_train_step(cfg, pol, optcfg, mesh=mesh,
                                       shape=TRAIN_SHAPE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out = {"step_s": time.perf_counter() - t,
               "metrics": {k: float(m[k]) for k in ("loss", "aux",
                                                    "grad_norm")},
               "digests": {n: _digest(p)
                           for n, p in state.model.named_parameters()},
               "collectives": (step.traffic.report() if mesh is not None
                               else None)}
        del state, step
        torch.cuda.empty_cache()
        return out

    # the per-expert counts are the one integer all-gather: one a MoE layer
    # and forward pass (remat recomputes each), beside ZeRO-3's gathers of
    # the float parameters on the same axis
    counts, all_gather = [], hierarchy.all_gather

    def counted(x, group, dim=0):
        if not x.is_floating_point():
            counts.append(tuple(x.shape))
        return all_gather(x, group, dim)

    with one_rank((1,), ("data",), device=DEV) as mesh:
        check(trainer.moe_impl(cfg, pol, mesh) == "sorted",
              "tp moe data-only: the step is not the sorted MoE")
        hierarchy.all_gather = counted
        try:
            got = run(mesh)
        finally:
            hierarchy.all_gather = all_gather
    want = run(None)
    check(got["metrics"] == want["metrics"],
          f"tp moe data-only: {got['metrics']} vs {want['metrics']}")
    differ = [n for n in want["digests"]
              if got["digests"][n] != want["digests"][n]]
    check(not differ, f"tp moe data-only: parameters differ after the "
                      f"step: {differ[:5]}")
    # every block of a MoE arch is a MoE block
    check(counts == [(1, cfg.moe.n_experts)] * 2 * cfg.n_layers,
          f"tp moe data-only: per-expert counts gathered {counts}, not once "
          f"a MoE layer ({cfg.n_layers}) and forward pass (2)")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "tokens": TRAIN_SHAPE.tokens, "bit_identical": True,
            "metrics": got["metrics"], "step_s_mesh": got["step_s"],
            "step_s_none": want["step_s"],
            "collectives": got["collectives"],
            "expert_count_gathers": len(counts),
            "params_held": len(want["digests"]),
            "phase_s": time.perf_counter() - t0}


def _tp_hybrid_bytes():
    """The bytes a rank holds of recurrentgemma-2b at ``model`` = 2 / 4 /
    8 / 16 (arithmetic from the specs): serving, bf16 parameters
    (``Layout.use_specs``) and the caches of ``TP_SERVE_SLOTS`` as the
    engine places them (``placed_cache_specs``: the RG-LRU states by
    channel); training, fp32 parameters, gradients and both AdamW moments
    at ``data`` = 1 (ZeRO 0)."""
    from repro_torch.models import transformer as transformer_mod
    from repro_torch.train import sharding
    cfg = get_config(HYBRID_ARCH)
    meta = LM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    caches = transformer_mod.init_stack_cache(cfg, *TP_SERVE_SLOTS,
                                              device="meta")
    out = {"params_whole_bytes": 2 * sum(int(np.prod(s))
                                         for s in shapes.values())}
    for m in TP_HYB_WORLDS:
        axes = {"data": 1, "model": m}
        pol = PolicyConfig(zero_stage=0)
        layout = sharding.Layout(cfg, pol, _SpecMesh(axes))
        use = sum(int(np.prod(policy_mod.local_shape(s, layout.use_specs[n],
                                                     axes)))
                  for n, s in shapes.items())
        ps, ms = sharding.specs(meta, cfg, pol, axes)

        def local(specs):
            return sum(int(np.prod(policy_mod.local_shape(s, specs[n], axes)))
                       for n, s in shapes.items())
        cspecs = policy_mod.placed_cache_specs(caches, pol, axes)
        cache = sum(int(np.prod(policy_mod.local_shape(
            t.shape, cspecs[i][n], axes))) * 2
            for i, layer in enumerate(caches) for n, t in layer.items())
        train_bytes = 4 * (2 * local(ps) + 2 * local(ms))
        out[f"model{m}"] = {
            "serving_params_bytes": 2 * use, "serving_cache_bytes": cache,
            "training_fp32_bytes": train_bytes,
            "gates_local": m <= 8 and 8 % m == 0,
            "fits_serving": 2 * use + cache <= CHIP.hbm_bytes,
            "fits_training": train_bytes <= CHIP.hbm_bytes}
    out["what"] = ("arithmetic from the specs, not measured: activations "
                   "and workspace not counted")
    return out


class _SpecMesh:
    """A mesh's names and sizes, for a layout's specs without a group."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))

    def get_local_rank(self, axis):
        return 0


def tp_phase(moe_part, moe_data_only, rung, rehearsal):
    """The ``tp`` line: the tensor- and expert-parallel paths on a one-rank
    NCCL mesh (data, model) = (1, 1) -- nothing crosses cards; every copy,
    reduce, gather and all-reduce of a wider mesh runs on the one rank --
    each held to the no-mesh path at the same seed: (a) ``_tp_serve``, (b)
    ``_tp_ssm``, (c) ``_tp_moe`` (run inside ``moe``, where moonshot is
    built whole), (d) ``_tp_rung`` (inside ``ladder_phase``'s group), (e)
    ``_tp_bytes``; (f) ``_tp_hybrid``, (g) ``_tp_hybrid_rung``, (h)
    ``_tp_paged`` (inside ``_tp_serve``), (i) ``tp_rank_kernel_cases``, (j)
    ``_moe_data_only_step`` (inside ``moe``) and recurrentgemma's bytes a
    rank (``_tp_hybrid_bytes``); B1 on repeated K/V against GQA
    (``_tp_repeat_cost``); the host's cost of a collective and a cut
    (``_tp_host_us``); the four-rank ``gloo`` rehearsal's TP / EP checks.
    Returns (f), (g), (h) and (i) for the ``kernels`` line."""
    t0 = time.perf_counter()
    with one_rank(device=DEV) as mesh:
        serve, paged = _tp_serve(mesh)
        t_serve = time.perf_counter()
        ssm_part = _tp_ssm(mesh)
        host_us = _tp_host_us(mesh)
        t_ssm = time.perf_counter()
        hybrid = _tp_hybrid(mesh)
    t_hybrid = time.perf_counter()
    hybrid_rung = _tp_hybrid_rung()
    t_rung = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(21)
    with torch.no_grad():
        repeat = _tp_repeat_cost()
        t_repeat = time.perf_counter()
        rank_rows = tp_rank_kernel_cases(gen)
    torch.cuda.empty_cache()
    t_rank = time.perf_counter()
    nbytes = _tp_bytes()
    hybrid_bytes = _tp_hybrid_bytes()
    emit("tp", mesh={"data": 1, "model": 1}, backend="nccl",
         crosses_cards=False,
         note="one card: the tensor- and expert-parallel collectives run "
              "on a one-rank group; their time between cards is not "
              "measured",
         serve_dense=serve, ssm_prefill=ssm_part, moe_ep_prefill=moe_part,
         ddp_mixed_rung=rung, hybrid_serve=hybrid,
         hybrid_ddp_mixed_rung=hybrid_rung, paged_serve=paged,
         moe_data_only_step=moe_data_only, rank_kernel_cases=rank_rows,
         b1_repeated_kv=repeat, host_us_one_rank=host_us,
         bytes_per_rank=nbytes, hybrid_bytes_per_rank=hybrid_bytes,
         rehearsal_four_gloo_ranks={
             k: rehearsal[k] for k in ("tensor_parallel", "expert_parallel",
                                       "tensor_parallel_hybrid")},
         phase_s={"serve": t_serve - t0 - paged["phase_s"],
                  "paged": paged["phase_s"], "ssm": t_ssm - t_serve,
                  "hybrid": t_hybrid - t_ssm,
                  "hybrid_rung": t_rung - t_hybrid,
                  "b1_repeat": t_repeat - t_rung,
                  "rank_kernels": t_rank - t_repeat,
                  "bytes": time.perf_counter() - t_rank,
                  "moe_in_moe_line": moe_part["phase_s"],
                  "moe_data_only_in_moe_line": moe_data_only["phase_s"],
                  "rung_in_ladder_line": rung["phase_s"],
                  "total": time.perf_counter() - t0 + moe_part["phase_s"]
                  + moe_data_only["phase_s"] + rung["phase_s"]})
    return hybrid, hybrid_rung, paged, rank_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script proves the port on "
              "a GPU and has no CPU fallback", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # untuned: only the ``tune`` line installs a registry, for its own
    # engine, and resets it after
    check(kernel_registry.get_registry() is None,
          f"${kernel_registry.ENV_VAR} names a tuned-config registry: "
          f"chip_smoke.py runs untuned, unset it")
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False          # in convolutions too
    smi = nvidia_smi_line()
    build.load()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    emit("env", card=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         python=sys.version.split()[0], kernel_build_s=build.build_seconds,
         kernel_sources=[os.path.relpath(p, ROOT) for p in build.sources()])
    # the ``ladder`` line's four-rank rehearsal needs only the host's CPU:
    # it runs from here on, while ``kernel_cases`` times the kernels on the
    # card (CUDA events around graph replays), and the line reads it
    host = concurrent.futures.ThreadPoolExecutor(1)
    rehearsal = host.submit(rehearse.rehearse)
    host.shutdown(wait=False)

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
        *b_bert, b_faults_bert = bwd_main_shape(gen, get_config(BERT_ARCH),
                                                *BERT_TRAINED, causal=False)
    torch.cuda.empty_cache()
    mc = moe_kernel_cases(gen)
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
                              "main_path_bert": dict(zip(TRAIN_KERNELS,
                                                         b_bert)),
                              "scaled_tol": SCALED_TOL,
                              "planted_faults_rejected": b_faults,
                              "planted_faults_rejected_d160": b_faults_d160,
                              "planted_faults_rejected_d256": b_faults_d256,
                              "planted_faults_rejected_bert": b_faults_bert},
         moe_archs=mc)
    emit("ptxas", kernels=ptxas_usage(PTXAS_KERNELS))
    with torch.no_grad():
        emit("memory_guards", cases=memory_guards(),
             rglru_bwd=rglru_guards(), ssd_bwd=ssd_bwd_guards())
    torch.cuda.empty_cache()

    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    # llama3.2-3b's paged serve and its training under one tracking run,
    # handed to that engine and that train loop and to nothing else
    track_dir = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    run = tracking.Run(f"chip_smoke-{ARCH}", config={"arch": ARCH},
                       tags=("chip_smoke",), dir=track_dir)
    n_paged, eng, splits = serve_paged(cfg, model, policy, tracker=run)
    tracked = tracked_serve(run, eng, "serve_paged")
    eng.tracker = None                      # the tracked serve ends here
    graphs_paged(cfg, model, policy, eng)
    # the registry and autotuner: a sweep of the main path's cells, llama
    # served under it in turns with ``eng``; every later phase untuned
    tune_phase(cfg, model, policy, eng, splits)
    del eng
    n_flash = serve_dense(cfg, model, policy)[0]
    parity(cfg, model)
    del model
    torch.cuda.empty_cache()
    n_train = train(cfg, tracker=run)
    run.finish()
    tracked_train(run, tracked, TRAINED[-1])
    shutil.rmtree(track_dir, ignore_errors=True)
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
    n_paged_d160, eng, _ = serve_paged(slm, model, policy)
    del eng
    n_flash_d160 = serve_dense(slm, model, policy)[0]
    del model
    torch.cuda.empty_cache()
    n_train_d160 = train(cut_depth(slm, TRAIN_CUT_LAYERS), TRAIN_CUT_SHAPE,
                         TRAIN_CUT_STEPS, cuts=TRAIN_CUT, full=False)
    torch.cuda.empty_cache()
    # the paper's Table II workloads: bert-base's steps launch sub-row (e)
    n_bert = paper_bench()
    torch.cuda.empty_cache()
    # the MoE archs: sub-rows (m) and (s)
    n_moe = moe(policy)
    # the composable-system analytics on the card, over the runs above
    composable()
    # a failure and resume through the trainer's kernels, and the cluster
    # control plane at the card's constants
    elastic_phase()
    cluster_phase()
    # the paper's ladder on a one-rank NCCL mesh: sub-row (q)
    q_rows, n_ladder, tp_rung, rehearsed = ladder_phase(rehearsal)
    # tensor and expert parallelism on a one-rank (data, model) mesh
    tp_hyb, tp_hyb_rung, tp_paged, tp_rows = tp_phase(
        n_moe["tp_moe"], n_moe["tp_moe_data_only"], tp_rung, rehearsed)

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
    for name, src, ref, des, got in zip(
            TRAIN_KERNELS, (fa_src, bwd_src, bwd_src), bwd_ref, designs,
            b_bert):
        rows.append(row(f"{name}_bert", src, ref, n_bert[name], [got],
                        des(got["shape"][-1], bf16)))
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
    # moonshot's (G = 1) and scout's (G = 5) attention at D = 128
    for tag in ("moonshot", "scout"):
        fl, pg = mc[f"flash_{tag}"], mc[f"paged_{tag}"]
        rows += [row(f"flash_attention_{tag}", fa_src, fa_ref,
                     n_moe[f"flash_{tag}"], [fl], fl["design"]),
                 row(f"paged_decode_attention_{tag}", pa_src, pa_ref,
                     n_moe[f"paged_{tag}"], [pg], pg["design"])]
    for name, src, ref, got in zip(TRAIN_KERNELS, (fa_src, bwd_src, bwd_src),
                                   bwd_ref, mc["bwd_moonshot"]):
        rows.append(row(f"{name}_moonshot", src, ref,
                        n_moe["train_moonshot"][name], [got], got["design"]))
    # qwen2-0.5b's trained attention (G = 7 at D = 64) on the ladder's
    # bf16 rungs
    for name, src, ref, des, got in zip(
            TRAIN_KERNELS, (fa_src, bwd_src, bwd_src), bwd_ref, designs,
            q_rows):
        rows.append(row(f"{name}_qwen", src, ref, n_ladder[name], [got],
                        des(got["shape"][-1], bf16)))
    # the per-rank shapes of a wider model axis (the tp line's (i)): no path
    # of this run launches them (one card holds a one-rank axis), so their
    # launches are 0; ``launches_full_width`` is the kernel's count at the
    # whole model's shape on the path named by ``launches_full_width_on``:
    # (f)'s first mesh round, (g)'s timed steps with the model axis, (h)'s
    # mesh round, and stablelm's serve_paged
    mesh_round = tp_hyb["rounds_mesh_none_none_mesh"][0]["launches"]
    rung_counts = tp_hyb_rung["runs"]["data_model"]["launches_timed"]
    paged_mesh = tp_paged["rounds_mesh_none"][0]
    on = {"rglru": (mesh_round["rglru"], "tp (f) mesh round"),
          "flash_attention": (mesh_round["flash_attention"],
                              "tp (f) mesh round"),
          "paged_decode_attention": (
              paged_mesh["paged_decode_attention_launches"],
              "tp (h) mesh round"),
          "paged_decode_attention_d160": (n_paged_d160,
                                          "serve_paged stablelm-12b")}
    for name in ("rglru_bwd",) + TRAIN_KERNELS:
        on[name] = (rung_counts[name], "tp (g) timed steps, model axis")
    sources = {"rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
                         "src/repro/kernels/rglru.py:58"),
               "rglru_bwd": ("src/repro_torch/kernels/csrc/rglru.cu",
                             "src/repro/models/rglru.py:134"),
               "flash_attention": (fa_src, fa_ref),
               "paged_decode_attention": (pa_src, pa_ref),
               "paged_decode_attention_d160": (pa_src, pa_ref)}
    sources.update(zip(TRAIN_KERNELS, zip((fa_src, bwd_src, bwd_src),
                                          bwd_ref)))
    for key, got in tp_rows.items():
        kernel = key.rsplit("_model", 1)[0].replace("_d256", "")
        full, where = on[kernel]
        rows.append(dict(row(key, *sources[kernel], 0, [got], got["design"]),
                         launches_full_width=full,
                         launches_full_width_on=where))
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
