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
                  product, the elementwise pass).

Run from the repository root (no name runs every probe):

    python3 scripts/probe_variant.py [fwd_d256_pv] [ssd_bwd_heads]
        [ssd_bwd_parts] [dkv_d256_parts] [dq_d256_parts]

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


PROBES = {"fwd_d256_pv": fwd_d256_pv, "ssd_bwd_heads": ssd_bwd_heads, "ssd_bwd_parts": ssd_bwd_parts,
          "dkv_d256_parts": dkv_d256_parts, "dq_d256_parts": dq_d256_parts}


def main(names) -> int:
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        print(f"probe_variant: no probe {unknown}; the probes are "
              f"{sorted(PROBES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_variant: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device=cs.DEV)
    with torch.no_grad():
        for name in names or PROBES:
            gen.manual_seed(0)
            PROBES[name](gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
