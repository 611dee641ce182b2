#!/usr/bin/env python3
"""Hold a shipped CUDA kernel against a variant of it, built from a patched
scratch copy of its source, on one CUDA device: both are checked against the
plain version on the same inputs and timed in turns (shipped, variant,
variant, shipped), twice.  ``variant_library`` copies a ``.cu`` with the
headers it includes into ``build/probe_variant/<probe>/``, replaces one line
or block that must occur exactly once, and builds it with the package's nvcc
flags.  The probes:

  fwd_d256_pv     the bf16 D = 256 warpgroup forward's O += P V as shipped
                  (one m64n256k16 per 16 keys over the four 64-column
                  panels, ``csrc/hopper.cuh`` ``wgmma_rs_n256_tb``) and as
                  one m64n64k16 per panel; on ``chip_smoke.ATTN_D256_CASES``'
                  bf16 cases and recurrentgemma-2b's served shape, timed at
                  the served shape;
  ssd_bwd_heads   the bf16 SSD backward at mamba2-780m's trained shape with
                  each block of stage (c') walking up to 48 heads of a
                  group (shipped: one slice at H = 48, G = 1, no group sum
                  of partials), 8, 16 or 24, each held to
                  ``ssd_bwd_plain``, timed in turns with the shipped build;
  ssd_bwd_parts   the same shape: the shipped build against variants of
                  stage (c') that each leave one part of a head's work out
                  (``SSD_BWD_PARTS``), timed in turns: what each part costs;
  dkv_d256_parts  the bf16 D = 256 dK/dV at recurrentgemma-2b's trained
                  shape against variants that each leave one part out
                  (``DKV_D256_PARTS``: the q / dO loads, the score
                  products, the gradient products, the elementwise pass,
                  the exchange, the slices' sum, the head slices), timed
                  in turns;
  dq_d256_parts   the same for the bf16 D = 256 dQ (``DQ_D256_PARTS``:
                  the K / V loads, the score products, the gradient
                  product, the elementwise pass);

and two model-level alternatives, each a train step of ``chip_smoke``'s
``paper_bench`` at its workload's batch (p50 of steps 2-5), timed in turns:

  bert_gather     bert-base's and bert-large's step with the learned
                  positions and the segments gathered by ``F.embedding``
                  (shipped) and by indexing (``table.to(dtype)[ids]``,
                  whose backward summed each row's repeats one by one);
  vision_layout   the CNNs' step with NCHW activations (shipped) and with
                  channels_last activations and weights;

and the learning rate of ``chip_smoke``'s MoE training:

  moe_train_lr    moonshot-v1-16b-a3b's 4-layer cut, four steps at peak
                  lr 3e-4 and 1e-4, on new batches and on one batch: the
                  loss, cross entropy and load-balance term a step;

how ``chip_smoke._moe_split`` counts a train step's device time:

  moe_split_count moonshot-v1-16b-a3b's 4-layer train step profiled
                  ``SPLIT_ROUNDS`` times: each kernel event once, against
                  ``_split_ms`` (each correlation id once) and the sum of
                  every CPU event's kernels;

and the card's own figures against the port's constants:

  card_figures    ``chip_smoke``'s ``composable`` parts (a) and (b) alone
                  on an idle card, ``CARD_ROUNDS`` rounds: total memory,
                  the 1 GiB copy and the bf16 8192^3 matmul beside
                  ``ChipSpec``, the pinned host link beside ``HOST`` (with
                  the phase's checks: the card beats no constant by more
                  than 5 %).

and one phase of ``chip_smoke`` alone:

  ladder          ``chip_smoke.ladder_phase`` (its ``ladder`` line: the
                  paper's ladder on a one-rank NCCL mesh, the int8
                  exchange, the four-rank rehearsal, per-rank bytes);

and where a tensor-parallel step's drift comes from:

  tp_hybrid_drift recurrentgemma-2b's DDP+mixed step, warm-up + 3 steps,
                  on a one-rank data mesh, the same with B1 / B2 on K/V
                  repeated to H, and on a one-rank (data, model) mesh, in
                  bf16; the data and (data, model) meshes in fp32: each
                  pair's losses, norms, step 0's gradients and parameters.

Run from the repository root (no name runs every probe):

    python3 scripts/probe_variant.py [fwd_d256_pv] [ssd_bwd_heads]
        [ssd_bwd_parts] [dkv_d256_parts] [dq_d256_parts] [bert_gather]
        [vision_layout] [moe_train_lr] [moe_split_count] [card_figures]
        [ladder] [tp_hybrid_drift]

Prints the card's name and power limit, then one JSON object per case,
draw and round of turns, and exits non-zero without a CUDA device or on a
mismatch of the forward probe.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch                                                   # noqa: E402

import chip_smoke as cs                                        # noqa: E402
from repro_torch.kernels import build                          # noqa: E402


def variant_library(probe: str, source: str, patched: str, old,
                    new) -> ctypes.CDLL:
    """``source`` (a ``.cu`` of ``csrc/``) built from a scratch copy in which
    the one occurrence of ``old`` in ``patched`` (that file or a header it
    includes) is replaced by ``new`` (or of each of a list of ``old`` by
    the ``new`` beside it)."""
    out = os.path.join(ROOT, "build", "probe_variant", probe)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for name in ("common.cuh", "hopper.cuh", source):
        shutil.copy(build.CSRC / name, out)
    path = os.path.join(out, patched)
    text = open(path).read()
    pairs = zip(old, new) if isinstance(old, (list, tuple)) else \
        [(old, new)]
    for o, n in pairs:
        cs.check(text.count(o) == 1, f"{patched}: the text to replace for "
                                     f"{probe} does not occur exactly once")
        text = text.replace(o, n)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(out, f"lib{probe}.so")
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
         os.path.join(out, source)], capture_output=True, text=True)
    cs.check(done.returncode == 0, "nvcc failed:\n" + done.stdout
             + done.stderr)
    return ctypes.CDLL(lib)


def fwd_d256_pv(gen) -> None:
    libs = {"shipped": build.load(), "per_panel": variant_library(
        "fwd_d256_pv", "flash_attention.cu", "hopper.cuh",
        "  } else if constexpr (NP == 4) {\n"
        "    wgmma_rs_n256_tb(acc, a, panel_desc<PW>(b_addr, panel));\n", "")}
    cases = [c for c in cs.ATTN_D256_CASES if c[-1] == torch.bfloat16]
    for B, S, T, H, K, D, causal, window, dt in cases + [cs.ATTN_SERVED]:
        q, k, v = (cs._randn(gen, B, n, h, D, dtype=dt)
                   for n, h in ((S, H), (T, K), (T, K)))
        want = cs.attention_plain(q, k, v, causal=causal, window=window)
        outs = {n: torch.empty_like(q) for n in libs}
        calls = {n: cs._entry(lib, "repro_flash_attention_fwd",
                              (q, k, v, outs[n]), causal, window)
                 for n, lib in libs.items()}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        row = {"probe": "fwd_d256_pv", "shape": [B, S, T, H, K, D],
               "causal": causal, "window": window,
               "bit_identical": torch.equal(*outs.values())}
        for n, o in outs.items():
            row[n] = {"max_abs_err": cs._err(o, want, 2e-2, n),
                      "scaled": cs._scaled_err(o, want, n)}
        print(json.dumps(row), flush=True)
        if (B, S, T, H, K, D) == cs.ATTN_SERVED[:6]:
            for _ in range(2):
                ms, ms_per_panel = cs.time_in_turns(
                    calls["shipped"], calls["per_panel"], 10)
                print(json.dumps({"served_ms": {
                    "shipped": ms, "per_panel": ms_per_panel,
                    "gain": 1 - ms / ms_per_panel}}), flush=True)


def ssd_bwd_heads(gen, heads=(8, 16, 24)) -> None:
    """The bf16 SSD backward's stage (c') at mamba2-780m's trained shape
    with each block walking ``BW_HEADS`` heads of its group (the largest
    divisor of H / G up to it; shipped 48) against the shipped build: each
    held to ssd_bwd_plain with chip_smoke.py's limits, the shipped build
    repeating bit for bit, then timed in turns (shipped, variant, variant,
    shipped), twice."""
    shipped = "constexpr int BW_HEADS = 48;"
    libs = {"shipped_48": build.load()}
    for k in heads:
        libs[f"heads_{k}"] = variant_library(
            f"ssd_bwd_heads_{k}", "ssd.cu", "ssd.cu", shipped,
            shipped.replace("48", str(k)))
    B, S, H, P, G, N = cs.SSD_TRAINED
    dt_ = torch.bfloat16
    ins = cs._ssd_inputs(gen, B, S, H, P, G, N, dt_, served=True)
    dy = cs._randn(gen, B, S, H, P, dtype=torch.float32)
    _, _, states, aend = cs.ssd(*ins, keep_states=True)
    want = cs.ssd_bwd_plain(*ins, dy)
    calls = {}
    for name, lib in libs.items():
        k = int(name.split("_")[-1])
        kk = max(d for d in range(1, min(k, H // G) + 1) if (H // G) % d == 0)
        call, outs, _ = cs._ssd_bwd_entry("repro_ssd_bwd", ins, dy, states,
                                          aend, nsl=H // G // kk, lib=lib)
        call()
        torch.cuda.synchronize()
        row = {"probe": "ssd_bwd_heads", "variant": name,
               "heads_per_block": kk, "shape": [B, S, H, P, G, N],
               "scaled": cs._ssd_bwd_check(outs, want, dt_, name)}
        if name == "shipped_48":
            again = [o.clone() for o in outs[:5]]
            call()
            torch.cuda.synchronize()
            row["repeats_bit_identical"] = all(
                torch.equal(a, b) for a, b in zip(again, outs[:5]))
            cs.check(row["repeats_bit_identical"],
                     "ssd_bwd: two calls differ")
        print(json.dumps(row), flush=True)
        calls[name] = call
    for name in libs:
        if name == "shipped_48":
            continue
        for _ in range(2):
            ms, ms_var = cs.time_in_turns(calls["shipped_48"], calls[name],
                                          10)
            print(json.dumps({"trained_ms": {"shipped_48": ms, name: ms_var,
                                             "gain": 1 - ms / ms_var}}),
                  flush=True)


# parts of the bf16 SSD backward's stage (c') that ssd_bwd_parts leaves
# out, one variant each: (texts of csrc/ssd.cu, their replacements)
SSD_BWD_PARTS = {
    "no_inputs": (["    {\n      // dy, G_c and h_c: every load of the thread in "
                   "flight, then split"],
                  ["    if (false) {\n      // dy, G_c and h_c: every load "
                   "of the thread in flight, then split"]),
    "no_tiles": (["    if (warp < 10) {\n      int i, jt;\n      "
                  "bw_tile(warp, i, jt);\n      float q[2][4];"],
                 ["    if (false) {\n      int i, jt;\n      "
                  "bw_tile(warp, i, jt);\n      float q[2][4];"]),
    "no_dx": (["for (int u = warp; u < Lay::DX_UNITS; u += BT_W) {"],
              ["for (int u = warp; u < 0; u += BT_W) {"]),
    "no_dB": (["for (int kb = rb; kb < 4; ++kb) {        // K^T is 0 below",
               "        a_rows(a, Xs, LDP, r0, ks, lane);"],
              ["for (int kb = 4; kb < 4; ++kb) {        // K^T is 0 below",
               "        if (ks >= 0) continue;\n"
               "        a_rows(a, Xs, LDP, r0, ks, lane);"]),
    "no_dC": (["for (int kb = 0; kb <= rb; ++kb) {       // K is 0 past",
               "        a_rows(ah, DYh, LDP, r0, ks, lane);"],
              ["for (int kb = 0; kb < 0; ++kb) {       // K is 0 past",
               "        if (ks >= 0) continue;\n"
               "        a_rows(ah, DYh, LDP, r0, ks, lane);"]),
    "no_ddt": (["    float gac = 0.f, zz = 0.f, colv = 0.f;\n    if (t < L) {"],
               ["    float gac = 0.f, zz = 0.f, colv = 0.f;\n    if (false) {"]),
}


def ssd_bwd_parts(gen) -> None:
    """Where the bf16 SSD backward's stage (c') spends its time at
    mamba2-780m's trained shape: the shipped build against variants that
    each leave one part of a head's work out (its outputs are then wrong
    and are not checked) -- the loads of dy, G_c and h_c with their split
    into hi / lo, the (m, l) tiles, the dx, dB and dC products, the ddt
    pass -- timed in turns (shipped, variant, variant, shipped); a part's
    share is the time its variant saves."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(SSD_BWD_PARTS)) as pool:
        futs = {name: pool.submit(variant_library, f"ssd_bwd_{name}",
                                  "ssd.cu", "ssd.cu", old, new)
                for name, (old, new) in SSD_BWD_PARTS.items()}
        libs = {name: f.result() for name, f in futs.items()}
    B, S, H, P, G, N = cs.SSD_TRAINED
    ins = cs._ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16, served=True)
    dy = cs._randn(gen, B, S, H, P, dtype=torch.float32)
    _, _, states, aend = cs.ssd(*ins, keep_states=True)
    nsl = cs.ssd_bwd_slices(H // G, P, N, torch.bfloat16)
    shipped, _, _ = cs._ssd_bwd_entry("repro_ssd_bwd", ins, dy, states,
                                      aend, nsl=nsl)
    for name, lib in libs.items():
        call, _, _ = cs._ssd_bwd_entry("repro_ssd_bwd", ins, dy, states,
                                       aend, nsl=nsl, lib=lib)
        ms, ms_var = cs.time_in_turns(shipped, call, 10)
        print(json.dumps({"probe": "ssd_bwd_parts", "variant": name,
                          "shipped_ms": ms, "variant_ms": ms_var,
                          "saved_ms": ms - ms_var}), flush=True)


# Parts of the bf16 D = 256 dK/dV and dQ (``flash_bwd_dkv_d256_kernel``,
# ``flash_bwd_dq_d256_kernel`` of csrc/flash_attention_bwd.cu) that
# dkv_d256_parts and dq_d256_parts leave out, one variant each: (texts,
# their replacements).  A part left out leaves its registers or shared
# memory as they were (the outputs are then wrong and are not checked);
# where the next stage would be dead code without it, a cheap use of its
# result stands in.  dK/dV also without head slices (``one_slice``: the
# balance), with the slices' partials left unsummed (``no_sum``), without
# the exchange's writes (``no_exchange``).
DKV_D256_PARTS = {
    "no_q_do_loads": (
        ["mbar_arrive_expect_tx(&full[stage], BM * D * 4);  // q, dO\n"
         "          for (int p = 0; p < NP; ++p) {"],
        ["mbar_arrive(&full[stage]);\n"
         "          for (int p = 0; p < 0; ++p) {"]),
    "no_scores": (
        ["#pragma unroll\n  for (int ks = 0; ks < 16; ++ks)\n"
         "    wgmma_ss(acc,"],
        ["  for (int i = 0; i < 16; ++i) acc[i] = (float)(b_addr + i);\n"
         "#pragma unroll\n  for (int ks = 0; ks < 0; ++ks)\n"
         "    wgmma_ss(acc,"]),
    "no_grad_products": (
        ["for (int kk = 0; kk < Lay::BM / 16; ++kk) {"],
        ["for (int kk = 0; kk < 0; ++kk) {"]),
    "no_elementwise": (
        ["for (int i2 = 0; i2 < 16; ++i2)\n"
         "        sc[i2] = softcap * tanhf(sc[i2] * to_t);",
         "#pragma unroll\n    for (int j = 0; j < 4; ++j) {\n"
         "      const float2 mq"],
        ["for (int i2 = 0; i2 < 0; ++i2)\n"
         "        sc[i2] = softcap * tanhf(sc[i2] * to_t);",
         "#pragma unroll\n    for (int j = 0; j < 0; ++j) {\n"
         "      const float2 mq"]),
    # the exchange's writes, and with them the packing and the elementwise
    # pass that only feed them
    "no_exchange": (
        ["    for (int h = 0; h < 2; ++h) {\n"
         "      // lane 8 i + rr: row rr of the block"],
        ["    for (int h = 0; h < 0; ++h) {\n"
         "      // lane 8 i + rr: row rr of the block"]),
    "no_sum": (
        ["if (rc != 0 || nsl == 1) return rc;"],
        ["if (rc != 0 || nsl >= 1) return rc;"]),
    "one_slice": (
        ["const int nsl = dkv256_slices(B, Tk, K, G);"],
        ["const int nsl = 1;"]),
}
DQ_D256_PARTS = {
    "no_k_v_loads": (
        ["mbar_arrive_expect_tx(&full[stage], BN * D * 4);  // K, V\n"
         "        for (int p = 0; p < NP; ++p) {"],
        ["mbar_arrive(&full[stage]);\n"
         "        for (int p = 0; p < 0; ++p) {"]),
    "no_scores": (
        ["for (int ks = 0; ks < 16; ++ks)\n      wgmma_ss(s,",
         "for (int ks = 0; ks < 16; ++ks)\n      wgmma_ss(dp,"],
        ["for (int i = 0; i < NB * 4; ++i) s[i] = dp[i] = "
         "(float)(k_addr + i);\n"
         "    for (int ks = 0; ks < 0; ++ks)\n      wgmma_ss(s,",
         "for (int ks = 0; ks < 0; ++ks)\n      wgmma_ss(dp,"]),
    "no_grad_product": (
        ["for (int kk = 0; kk < PK; ++kk)\n"
         "      wgmma_rs_panels<64, NP>(acc, da[kk],"],
        ["for (int kk = 0; kk < PK; ++kk)\n"
         "      acc[0][kk] += __uint_as_float(da[kk][0] ^ da[kk][1] ^ "
         "da[kk][2] ^\n"
         "                                    da[kk][3]);\n"
         "    for (int kk = 0; kk < 0; ++kk)\n"
         "      wgmma_rs_panels<64, NP>(acc, da[kk],"]),
    "no_elementwise": (
        ["      for (int i = 0; i < NB * 4; ++i)\n"
         "        s[i] = softcap * tanhf(s[i] * to_t);",
         "for (int i = 0; i < NB * 4; ++i) {\n"
         "      const int h = (i >> 1) & 1;"],
        ["      for (int i = 0; i < 0; ++i)\n"
         "        s[i] = softcap * tanhf(s[i] * to_t);",
         "for (int i = 0; i < 0; ++i) {\n"
         "      const int h = (i >> 1) & 1;"]),
}


def _attn_parts(gen, probe, entry, parts, iters) -> None:
    """The shipped ``entry`` against variants of
    csrc/flash_attention_bwd.cu that each leave one part out (``parts``), at recurrentgemma-2b's trained shape (q (2,4096,10,256), k/v
    (2,4096,1,256), bf16, causal, window 2048), timed in turns (shipped,
    variant, variant, shipped); a part's share is the time its variant
    saves."""
    from concurrent.futures import ThreadPoolExecutor
    shipped_lib = build.load()
    with ThreadPoolExecutor(len(parts)) as pool:
        futs = {name: pool.submit(
            variant_library, f"{probe}_{name}", "flash_attention_bwd.cu",
            "flash_attention_bwd.cu", old, new)
            for name, (old, new) in parts.items()}
        libs = {name: f.result() for name, f in futs.items()}
    B, S, H, K, D, window = 2, 4096, 10, 1, 256, 2048
    q, k, v, do = cs._bwd_inputs(gen, B, S, S, H, K, D, torch.bfloat16)
    o, m, l = cs.flash_attention_fwd_stats(q, k, v, causal=True,
                                           window=window)
    ins = (q, k, v, do, m, l, cs.attention_delta(o, do))
    outs = _outs(entry, q, k, v)
    shipped = cs._entry(shipped_lib, entry, ins + outs, True, window)
    for name, lib in libs.items():
        call = cs._entry(lib, entry, ins + outs, True, window)
        ms, ms_var = cs.time_in_turns(shipped, call, iters)
        print(json.dumps({"probe": probe, "entry": entry, "variant": name,
                          "shipped_ms": ms, "variant_ms": ms_var,
                          "saved_ms": ms - ms_var}), flush=True)


def _outs(entry, q, k, v):
    """The outputs (and scratch) of a backward entry point: dk, dv and the
    head slices' partials, or dq."""
    if "_dq" in entry:
        return (torch.empty_like(q),)
    B, S, H, D = q.shape
    nsl = cs.dkv_slices(B, k.shape[1], H, k.shape[2], D, q.dtype)
    return torch.empty_like(k), torch.empty_like(v), torch.empty(
        2 * nsl * k.numel(), dtype=torch.float32, device=q.device)


def dkv_d256_parts(gen) -> None:
    """Where the bf16 D = 256 dK/dV spends its time
    (``DKV_D256_PARTS``)."""
    _attn_parts(gen, "dkv_d256_parts", "repro_flash_attention_bwd_dkv",
                DKV_D256_PARTS, 3)


def dq_d256_parts(gen) -> None:
    """The same for the bf16 D = 256 dQ (``DQ_D256_PARTS``)."""
    _attn_parts(gen, "dq_d256_parts", "repro_flash_attention_bwd_dq",
                DQ_D256_PARTS, 5)


def _step_turns(probe, work, cfg, variants, make, B):
    """``work``'s train step under each of ``variants`` (name -> a function
    that installs it) in turns (a, b, b, a): ``make()`` builds the model
    after the variant is installed.  Prints the p50 of steps 2-5, the
    losses and, for each, one profiled step's device ms by kind."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import trainer
    (a, set_a), (b, set_b) = variants.items()
    policy = cs.TRAIN_POLICY if work.domain == "nlp" else \
        cs.PolicyConfig(compute_dtype="float32", param_dtype="float32",
                        remat="none")
    for name, install in ((a, set_a), (b, set_b), (b, set_b), (a, set_a)):
        install()
        model = make()
        opt = AdamWConfig(lr=cs.PAPER_LR[work.domain])
        state = trainer.TrainState.create(model, policy, opt)
        step = trainer.make_step(trainer.paper_loss_fn(cfg, policy), opt)
        gen = torch.Generator(device=cs.DEV)
        gen.manual_seed(0)
        batch = cs._paper_batch(work, cfg, B, gen)
        times, losses = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = cs.time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(cs.time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        prof = cs._profile(lambda: step(state, batch), f"{probe} {name}")
        print(json.dumps({"probe": probe, "workload": work.name,
                          "variant": name, "batch": B,
                          "step_s_p50": float(cs.np.median(times[1:])),
                          "step_s": times, "losses": losses,
                          "device_busy_ms": prof["device_busy_ms"],
                          "device_ms_by_kind": prof["device_ms_by_kind"]}),
              flush=True)
        del model, state, step, batch
        torch.cuda.empty_cache()
    set_a()


def bert_gather(gen) -> None:
    """bert-base's and bert-large's step: positions and segments gathered
    by ``F.embedding`` (shipped) and by indexing."""
    from repro_torch.models import bert, lm
    shipped = (lm.LM.embed_inputs, bert.forward_qa)

    def embed_indexed(self, inputs, ctx, positions):
        cd = ctx.compute_dtype
        return (lm.layers.embed_tokens(self.embed, inputs, cd)
                + self.pos_embed.to(cd)[positions.long()])

    def forward_indexed(model, tokens, ctx, *, segments=None,
                        attn_mask=None):
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=tokens.device).expand(B, S)
        hidden = model.lm(tokens, ctx, positions=pos, return_hidden=True)[0]
        hidden = hidden + model.segment_embed.to(hidden.dtype)[
            segments.long()]
        logits = (hidden.float() @ model.qa_head.w.float()
                  + model.qa_head.b.float())
        return logits[..., 0], logits[..., 1]

    def install(embed, forward):
        def go():
            lm.LM.embed_inputs, bert.forward_qa = embed, forward
        return go

    variants = {"embedding": install(*shipped),
                "index": install(embed_indexed, forward_indexed)}
    with torch.enable_grad():
        for work in cs.PAPER_WORKLOADS:
            if work.domain == "nlp":
                cfg = cs.get_config(work.name)
                _step_turns("bert_gather", work, cfg, variants,
                            lambda: bert.BertQA.init(cfg, device=cs.DEV),
                            work.batch_size)


def vision_layout(gen) -> None:
    """The CNNs' fp32 step with NCHW activations (shipped) and with
    channels_last activations and weights."""
    from repro_torch.models import vision
    shipped = vision._Vision.forward
    layout = {"memory_format": torch.contiguous_format}

    def forward_cl(self, images):
        return self.apply_nchw(images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))

    def install(forward, fmt):
        def go():
            vision._Vision.forward = forward
            layout["memory_format"] = fmt
        return go

    variants = {"nchw": install(shipped, torch.contiguous_format),
                "channels_last": install(forward_cl, torch.channels_last)}
    with torch.enable_grad():
        for work in cs.PAPER_WORKLOADS:
            if work.domain == "vision":
                cfg = cs.VISION_CFGS[work.name]
                B = cs.PAPER_BATCH_CUT.get(work.name, (work.batch_size,))[0]
                _step_turns("vision_layout", work, cfg, variants,
                            lambda: vision.init_vision(cfg, device=cs.DEV)
                            .to(memory_format=layout["memory_format"]), B)


# (peak lr, one fixed batch): chip_smoke's MOE_TRAIN_LR against the other
# archs' 3e-4, each on new batches and on one batch
MOE_LR_VARIANTS = ((3e-4, False), (3e-4, True), (1e-4, False), (1e-4, True))


def moe_train_lr(gen) -> None:
    """moonshot-v1-16b-a3b at ``chip_smoke``'s 4-layer training cut: four
    steps from seed 0 under ``chip_smoke.train``'s schedule (cosine, one
    warm-up step at lr 0, 3 steps) for each of ``MOE_LR_VARIANTS``; the
    loss, cross entropy and load-balance term of every step."""
    del gen
    cfg = cs.cut_depth(cs.get_config(cs.MOE_ARCH), cs.MOE_TRAIN_LAYERS)
    ds = cs.SyntheticDataset(cfg, cs.TRAIN_SHAPE, seed=0)
    for lr, fixed in MOE_LR_VARIANTS:
        opt = cs.AdamWConfig(lr=lr)
        sched = cs.ScheduleConfig(kind="cosine", peak_lr=lr, warmup_steps=1,
                                  total_steps=cs.MOE_TRAIN_STEPS)
        state = cs.trainer.init_state(cfg, cs.TRAIN_POLICY, opt, seed=0,
                                      device=cs.DEV)
        step = cs.trainer.make_train_step(cfg, cs.TRAIN_POLICY, opt, sched,
                                          shape=cs.TRAIN_SHAPE)
        metrics = []
        with torch.enable_grad():
            for i in range(cs.MOE_TRAIN_STEPS + 1):
                m = step(state, ds.batch_at(0 if fixed else i))[1]
                metrics.append({k: float(m[k])
                                for k in ("loss", "xent", "aux", "lr")})
        print(json.dumps({"probe": "moe_train_lr", "arch": cfg.name,
                          "peak_lr": lr, "fixed_batch": fixed,
                          "steps": metrics}), flush=True)
        del state, step
        torch.cuda.empty_cache()


SPLIT_ROUNDS = 8


def moe_split_count(gen) -> None:
    """moonshot-v1-16b-a3b's 4-layer train step (``chip_smoke``'s cut and
    batch) under ``chip_smoke._moe_profile``, ``SPLIT_ROUNDS`` times: the
    wall ms, the device ms of every kernel event (each once; the ranges'
    device-side spans left out), the device ms ``chip_smoke._split_ms``
    counts (each correlation id once) and what summing every CPU event's
    kernels counts (a correlation id's kernels hang on each CPU event with
    that id), with the CPU events that share an id."""
    del gen
    cfg = cs.cut_depth(cs.get_config(cs.MOE_ARCH), cs.MOE_TRAIN_LAYERS)
    ds = cs.SyntheticDataset(cfg, cs.TRAIN_SHAPE, seed=0)
    opt = cs.AdamWConfig(lr=cs.MOE_TRAIN_LR)
    sched = cs.ScheduleConfig(kind="cosine", peak_lr=cs.MOE_TRAIN_LR,
                              warmup_steps=1, total_steps=cs.MOE_TRAIN_STEPS)
    state = cs.trainer.init_state(cfg, cs.TRAIN_POLICY, opt, seed=0,
                                  device=cs.DEV)
    step = cs.trainer.make_train_step(cfg, cs.TRAIN_POLICY, opt, sched,
                                      shape=cs.TRAIN_SHAPE)
    batch = ds.batch_at(0)
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    with torch.enable_grad():
        for _ in range(2):
            step(state, batch)
        for i in range(SPLIT_ROUNDS):
            events, wall = cs._moe_profile(lambda: step(state, batch))
            held = [e for e in events if e.device_type == cpu and e.kernels]
            by_id = {}
            for e in held:
                by_id.setdefault(e.id, []).append(e.name[:40])
            print(json.dumps({
                "probe": "moe_split_count", "round": i, "wall_ms": wall,
                "kernel_events_ms": sum(e.time_range.elapsed_us()
                                        for e in events
                                        if e.device_type == dev
                                        and not e.is_user_annotation) / 1e3,
                "split_ms": sum(cs._split_ms(events).values()),
                "every_event_ms": sum(k.duration for e in held
                                      for k in e.kernels) / 1e3,
                "shared_ids": [g for g in by_id.values()
                               if len(g) > 1][:6]}), flush=True)
    del state, step
    torch.cuda.empty_cache()


CARD_ROUNDS = 3


def card_figures(gen) -> None:
    """``chip_smoke.chip_figures`` and ``host_link`` on an idle card,
    ``CARD_ROUNDS`` times: what the port's ``ChipSpec`` and ``HOST`` link
    are held against, without the rest of the run's load before it."""
    del gen
    chip = cs.ChipSpec()
    for i in range(CARD_ROUNDS):
        print(json.dumps({"probe": "card_figures", "round": i,
                          "chip": cs.chip_figures(chip),
                          "host_link": cs.host_link(
                              cs.DEFAULT_LINKS[cs.LinkClass.HOST])}),
              flush=True)


def _drift(got, want, lr):
    """``got``'s losses, norms, step 0's gradients and last parameters
    against ``want``'s: relative differences, bit identity, and the
    parameters' largest difference in lr."""
    grads = {n: float((g - want["grads"][n]).norm()
                      / want["grads"][n].norm().clamp_min(1e-30))
             for n, g in got["grads"].items()}
    params = {n: float((p - want["params"][n]).abs().max())
              for n, p in got["params"].items()}
    top = dict(sorted(grads.items(), key=lambda kv: -kv[1])[:4])
    return {"losses_rel": [abs(a - b) / abs(b) for a, b in
                           zip(got["losses"], want["losses"])],
            "norms_rel": [abs(a - b) / b for a, b in
                          zip(got["norms"], want["norms"])],
            "losses_bit_identical": got["losses"] == want["losses"],
            "step0_grads_worst_rel_fro": max(grads.values()),
            "step0_grads_largest": top,
            "step0_grads_bit_identical": all(
                torch.equal(g, want["grads"][n])
                for n, g in got["grads"].items()),
            "params_max_abs": max(params.values()),
            "params_max_abs_in_lr": max(params.values()) / lr,
            "params_bit_identical": all(v == 0.0 for v in params.values()),
            "params_largest": dict(sorted(params.items(),
                                          key=lambda kv: -kv[1])[:4])}


DRIFT_RUNS = (("data", "bfloat16", False), ("data_repeat", "bfloat16", True),
              ("data_model", "bfloat16", False), ("data", "float32", False),
              ("data_model", "float32", False))
DRIFT_PAIRS = ((("data_repeat", "bfloat16"), ("data", "bfloat16")),
               (("data_model", "bfloat16"), ("data", "bfloat16")),
               (("data_model", "bfloat16"), ("data_repeat", "bfloat16")),
               (("data_model", "float32"), ("data", "float32")))


def tp_hybrid_drift(gen) -> None:
    """Why recurrentgemma-2b's step with the model axis drifts from the
    step without it after an update (``chip_smoke._tp_hybrid_rung``): the
    ladder's DDP+mixed rung at 2 x 4096 tokens, a warm-up at lr 0 and
    ``LADDER_TIMED`` steps, on a one-rank ``data`` mesh, the same with
    B1 / B2 on K/V repeated to H (``chip_smoke._repeat_kv_attend``), and
    on a one-rank ``(data, model)`` mesh; then without and with the model
    axis in fp32.  Each pair of ``DRIFT_PAIRS``: losses, gradient norms, step
    0's gradients and the last parameters."""
    del gen
    from repro_torch.models import attention
    build.load()
    cfg = cs.get_config(cs.HYBRID_ARCH)
    base = cs.PolicyConfig(param_dtype="float32", remat="block",
                           attn_impl="kernel", dp_axes=("data",))
    rung = cs.policy_mod.ladder(base)["DDP+mixed"]
    lr = cs.LADDER_LR
    optcfg = cs.AdamWConfig(lr=lr)
    sched = cs.ScheduleConfig(kind="cosine", peak_lr=lr, warmup_steps=1,
                              total_steps=1 + cs.LADDER_TIMED)
    ds = cs.SyntheticDataset(cfg, cs.TRAIN_SHAPE, seed=0)
    kept, attend = {}, attention._attend
    for name, dtype, repeat in DRIFT_RUNS:
        pol = cs.dataclasses.replace(rung, compute_dtype=dtype)
        shape, axes = (((1, 1), ("data", "model")) if name == "data_model"
                       else ((1,), ("data",)))
        if repeat:
            attention._attend = cs._repeat_kv_attend(attend)
        try:
            with torch.enable_grad(), cs.one_rank(shape, axes,
                                                  device=cs.DEV) as mesh:
                state = cs.trainer.init_state(cfg, pol, optcfg, seed=0,
                                              device=cs.DEV, mesh=mesh)
                step = cs.trainer.make_train_step(
                    cfg, pol, optcfg, sched, mesh=mesh, shape=cs.TRAIN_SHAPE)
                run = {"losses": [], "norms": [], "step_s": []}
                for i in range(1 + cs.LADDER_TIMED):
                    torch.cuda.synchronize()
                    t = cs.time.perf_counter()
                    state, m = step(state, ds.batch_at(i))
                    torch.cuda.synchronize()
                    run["step_s"].append(cs.time.perf_counter() - t)
                    run["losses"].append(float(m["loss"]))
                    run["norms"].append(float(m["grad_norm"]))
                    if i == 0:
                        run["grads"] = {
                            n: p.grad.detach().to("cpu", copy=True)
                            for n, p in state.model.named_parameters()}
                run["params"] = {n: p.detach().to("cpu", copy=True)
                                 for n, p in state.model.named_parameters()}
                del state, step
                torch.cuda.empty_cache()
        finally:
            attention._attend = attend
        kept[(name, dtype)] = run
        print(json.dumps({"probe": "tp_hybrid_drift", "run": name,
                          "compute_dtype": dtype, "repeat_kv": repeat,
                          **{k: run[k] for k in ("losses", "norms",
                                                 "step_s")}}), flush=True)
        for a, b in DRIFT_PAIRS:
            if (name, dtype) in (a, b) and a in kept and b in kept:
                print(json.dumps({"probe": "tp_hybrid_drift",
                                  "pair": [list(a), list(b)], "lr": lr,
                                  **_drift(kept[a], kept[b], lr)}),
                      flush=True)
        if name == "data_model":            # every pair of its dtype shown
            kept = {k: v for k, v in kept.items() if k[1] != dtype}


def ladder(gen) -> None:
    """``chip_smoke.ladder_phase`` alone, after the build."""
    del gen
    build.load()
    with torch.enable_grad():
        cs.ladder_phase()


PROBES = {"fwd_d256_pv": fwd_d256_pv, "ssd_bwd_heads": ssd_bwd_heads,
          "ssd_bwd_parts": ssd_bwd_parts, "dkv_d256_parts": dkv_d256_parts,
          "dq_d256_parts": dq_d256_parts, "bert_gather": bert_gather,
          "vision_layout": vision_layout, "moe_train_lr": moe_train_lr,
          "moe_split_count": moe_split_count, "card_figures": card_figures,
          "ladder": ladder, "tp_hybrid_drift": tp_hybrid_drift}


def main(names) -> int:
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        print(f"probe_variant: no probe {unknown}; the probes are "
              f"{sorted(PROBES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_variant: needs a CUDA device", file=sys.stderr)
        return 1
    # fp32 means fp32, as in chip_smoke.py: cuDNN and cuBLAS would run fp32
    # products in TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device=cs.DEV)
    with torch.no_grad():
        for name in names or PROBES:
            gen.manual_seed(0)
            PROBES[name](gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
