#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts and
computes the right thing on an NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and the checkout's sources -- no network,
no CPU fallback.  Any failure (no GPU, a kernel that does not build or
launch, a comparison out of tolerance, an unserved request) ends the run with
a non-zero exit code.  Phases, one JSON object per line:

  env           card name and power limit (``nvidia-smi``), torch / CUDA
                versions, seconds spent building the kernels;
  kernel_cases  each CUDA kernel against its plain PyTorch version on the
                card: the reference's test cases (fp32 at 2e-5 / 1e-5, bf16
                at 2e-2) and the shapes the served llama3.2-3b gives them,
                with times (CUDA events), the plain version's time, one
                PyTorch library call's time where there is one, and the
                bound (least time the card could take);
  serve_paged   llama3.2-3b at full width in bf16, random weights from seed
                0 made on the device, 16 requests through
                ``AsyncServeEngine(mode="paged")``; pure-decode iterations
                must go through the paged decode kernel;
  serve_dense   the same model, ``mode="dense"``, 4 requests; every prefill
                must go through the flash-attention kernel;
  parity        greedy streams with the kernels equal those with the plain
                oracle (2 layers, full-width heads, fp32); one bf16 decode
                step's logits kernel vs plain at full depth;
  kernels       the per-kernel summary line, launches counted on the served
                runs above.

Then the card's name and power limit as ``nvidia-smi`` prints them, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.configs.base import ATTN, PolicyConfig        # noqa: E402
from repro_torch.kernels import build, ops                     # noqa: E402
from repro_torch.kernels.flash_attention import (              # noqa: E402
    attention_plain, flash_attention)
from repro_torch.kernels.paged_attention import (              # noqa: E402
    paged_attention_plain, paged_decode_attention)
from repro_torch.models.lm import LM                           # noqa: E402
from repro_torch.serve import AsyncServeEngine, ServeRequest   # noqa: E402

# published peaks of one H100 SXM (dense): what the bounds are stated against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ARCH = "llama3.2-3b"
DEV = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
]


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=DEV,
                       dtype=torch.float32).to(dtype)


def _tol(dtype, fp32_tol):
    return 2e-2 if dtype == torch.bfloat16 else fp32_tol


def _err(got, want, tol, what):
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= tol + tol * want.abs()).all())
    check(ok, f"{what}: max abs err {err} exceeds atol=rtol={tol}")
    return err


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


def flash_main_shape(gen, cfg, S):
    """Prefill of one ``S``-token bucket of the served model: bf16, causal."""
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    q = _randn(gen, 1, S, H, D, dtype=dt)
    k = _randn(gen, 1, S, K, D, dtype=dt)
    v = _randn(gen, 1, S, K, D, dtype=dt)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = _err(got, attention_plain(q, k, v, causal=True), 2e-2,
               f"flash_attention main shape S={S}")
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
    return {"shape": [1, S, S, H, K, D], "dtype": str(dt), "tol": 2e-2,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


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
                            2e-2, "paged_decode_attention main shape"))
    ms = time_ms([lambda tab=tab: paged_decode_attention(q, kp, vp, tab, lens)
                  for tab in tabs], 10)
    plain_ms = time_ms(
        [lambda tab=tab: paged_attention_plain(q, kp, vp, tab, lens)
         for tab in tabs], 3)
    live = sum(lengths)
    # live K and V rows read once, q read and out written once, plus the
    # table entries and lengths the kernel follows
    nbytes = (2 * live * K * D + 2 * q.numel()) * q.element_size() \
        + 4 * (sum(-(-n // 16) for n in lengths) + len(lengths))
    flops = 4 * live * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {"shape": [8, 2048, D, H // K, K, 16], "lengths": lengths,
            "dtype": str(dt), "tol": 2e-2, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


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
            "iterations": rep["iterations"], "compile_s": rep["compile_s"]}


def serve_paged(cfg, model, policy):
    eng = AsyncServeEngine(cfg, model, policy, mode="paged", fused=True,
                           n_slots=8, max_seq=2048, page_size=16,
                           prefill_chunk=256, device=DEV)
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
    emit("serve_paged", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         requests=len(reqs), served=served, prompt_lens=lens, max_new=64,
         wall_s=wall, decode_iterations=rep["decode_iterations"],
         paged_kernel_launches=n_paged, hit_rate=hit,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         **_latency(rep))
    return n_paged


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
    check(n_flash == len(reqs) * cfg.n_layers,
          f"flash launches {n_flash} != prefills x layers = "
          f"{len(reqs) * cfg.n_layers}")
    emit("serve_dense", arch=cfg.name, requests=len(reqs), served=served,
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
    check(all(after[k] > before[k] for k in after),
          "parity: the kernel runs launched no kernel")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script proves the port on "
              "a GPU and has no CPU fallback", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    smi = nvidia_smi_line()
    build.load()
    emit("env", card=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kernel_build_s=build.build_seconds,
         kernel_sources=[os.path.relpath(p, ROOT) for p in build.sources()])

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    with torch.no_grad():
        f_cases, p_cases = flash_cases(gen), paged_cases(gen)
        f_main = [flash_main_shape(gen, cfg, S) for S in (512, 2048)]
        p_main = paged_main_shape(gen, cfg)
    emit("kernel_cases",
         flash_attention={"cases": f_cases, "main_path": f_main},
         paged_decode_attention={"cases": p_cases, "main_path": [p_main]})

    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    policy = PolicyConfig(compute_dtype="bfloat16", remat="none",
                          attn_impl="kernel")
    n_paged = serve_paged(cfg, model, policy)
    n_flash = serve_dense(cfg, model, policy)
    parity(cfg, model)

    def row(name, source, replaces, launches, main):
        head = main[-1]                     # the largest main-path shape
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(m["max_abs_err"] for m in main),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "dtype": head["dtype"]}

    print(json.dumps({"kernels": [
        row("flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:124", n_flash, f_main),
        row("paged_decode_attention",
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:151", n_paged, [p_main]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
