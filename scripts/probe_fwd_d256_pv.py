#!/usr/bin/env python3
"""Time the bf16 D = 256 warpgroup forward's O += P V two ways, in turns,
on one CUDA device: as shipped (one m64n256k16 per 16 keys over the four
64-column panels of V, ``csrc/hopper.cuh`` ``wgmma_rs_n256_tb``) and as one
m64n64k16 per panel.  The second is built from a scratch copy of
``csrc/flash_attention.cu`` whose ``hopper.cuh`` leaves out the four-panel
branch of ``wgmma_rs_panels``, into its own library under
``build/probe_fwd_d256_pv/``.  Both are held to the plain version on
``chip_smoke.ATTN_D256_CASES``' bf16 cases and on recurrentgemma-2b's served
shape (``chip_smoke.ATTN_SERVED``), and timed in turns (shipped, per-panel,
per-panel, shipped) at the served shape, twice.  Run from the repository
root:

    python3 scripts/probe_fwd_d256_pv.py

Prints the card's name and power limit, one JSON object per case and per
round of turns, and exits non-zero without a CUDA device or on a mismatch.
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

WIDE_BRANCH = '''  } else if constexpr (NP == 4) {
    wgmma_rs_n256_tb(acc, a, panel_desc<PW>(b_addr, panel));
'''


def per_panel_library() -> ctypes.CDLL:
    """The forward built with one m64n64k16 per panel at D = 256."""
    out = os.path.join(ROOT, "build", "probe_fwd_d256_pv")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for name in ("common.cuh", "hopper.cuh", "flash_attention.cu"):
        shutil.copy(build.CSRC / name, out)
    path = os.path.join(out, "hopper.cuh")
    text = open(path).read()
    cs.check(text.count(WIDE_BRANCH) == 1,
             "hopper.cuh has no four-panel branch to leave out")
    with open(path, "w") as f:
        f.write(text.replace(WIDE_BRANCH, ""))
    lib = os.path.join(out, "libper_panel.so")
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
         os.path.join(out, "flash_attention.cu")],
        capture_output=True, text=True)
    cs.check(done.returncode == 0, "nvcc failed:\n" + done.stdout
             + done.stderr)
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_fwd_d256_pv: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    libs = {"shipped": build.load(), "per_panel": per_panel_library()}
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(0)
    cases = [c for c in cs.ATTN_D256_CASES if c[-1] == torch.bfloat16]
    with torch.no_grad():
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
            row = {"shape": [B, S, T, H, K, D], "causal": causal,
                   "window": window,
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
