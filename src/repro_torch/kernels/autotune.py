"""Kernel autotuner: time every candidate knob of a cell on the card, keep the
measured winners; held against ``repro/kernels/autotune.py``.

For each (kernel, shape-bucket, dtype, variant) cell it runs every legal
candidate through the dispatch (``kernels/ops.py``), holds its output to the
plain version at the tolerance that ``chip_smoke.py``'s kernel cases use (a
wrong candidate fails the sweep; it does not merely lose), times it, and
writes the fastest to the tuned-config registry (``kernels/registry.py``),
which the dispatch then resolves when a kernel is called.

The candidates are what the CUDA kernels expose:

  * ``decode_attention`` (B3, split-KV paged decode): ``block_k``, the
    tokens a piece, whole pages: 1, 2, 4, 8 or 16 pages that divide the
    table, the reference's rule;
  * ``rglru`` (B5): ``block_seq``, the forward scan's steps a chunk: 16,
    32, 64, 128 or 256 fitted to S, the reference's rule;
  * ``flash_attention`` (B1), ``flash_attention_bwd`` (B2) and ``ssd``
    (B4): one candidate each, the tile that the design for (head_dim,
    dtype) launches (``flash_attention.tile``) and the SSD kernel's
    64-step chunk (``ssd.KERNEL_CHUNK``).  The reference's
    ``flash_attention_xla`` has no counterpart here.

Timing: on the card, CUDA events around replays of one CUDA graph of the
candidate's launches, the median of the rounds (the launches cycle over
enough input sets to keep a small cell's inputs out of the 50 MB L2, as a
layer of a served model finds them, and over every set of decode row
lengths the cell carries); on the CPU, the host clock around the plain
versions.  Each candidate is held to the plain version on every input set
it is timed on.

A decode cell's row lengths are those its key sees when served: the sets
that ``Case.lengths`` carries (a caller records them from a served run), or
else ``served_lengths``, the spread that the engine's table bucketing
implies.  ``tune``, ``sweep`` and ``main`` run on the card unless
they are asked for the CPU, and raise without one.

CLI::

    PYTHONPATH=src python -m repro_torch.kernels.autotune \\
        --out results/torch/tuned_configs.json
    REPRO_TORCH_TUNED_CONFIGS=results/torch/tuned_configs.json <program>
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import registry as reg
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ssd as _sd

KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "ssd", "rglru")

_PAGES_OPTS = (1, 2, 4, 8, 16)             # pages a split-KV piece
_RGLRU_BLOCK_OPTS = (16, 32, 64, 128, 256)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
L2_BYTES = 50 * 2 ** 20                    # the H100's L2 cache

# each candidate's output against the plain version, as chip_smoke.py's
# kernel cases hold the kernels: elementwise atol = rtol ...
ELEMENT_TOL = {"flash_attention": {"bfloat16": 2e-2, "float32": 2e-5},
               "flash_attention_bwd": {"bfloat16": 2e-2, "float32": 5e-4},
               "decode_attention": {"bfloat16": 2e-2, "float32": 1e-5},
               "rglru": {"float32": 2e-5}}
# ... and to the size of what they compare (the largest error over the
# largest |want|, the relative Frobenius error, each row's error over its
# norm floored at the median row norm): bf16 attention, the paged decode's
# too, at chip_smoke.py's SCALED_TOL, the SSD at its SSD_TOL
SCALED_TOL = {"max_err_over_max_abs": 2e-2, "rel_fro": 1e-2,
              "row_rel_max": 5e-2}
SSD_TOL = {"max_err_over_max_abs": 2e-4, "rel_fro": 2e-4,
           "row_rel_max": 2e-4}


@dataclasses.dataclass(frozen=True)
class Case:
    """One tuning cell: a kernel at a concrete shape/dtype/variant.

    ``dims`` is the kernel-specific dimension dict (sorted tuple so the
    case is hashable); it carries exactly the names the registry resolvers
    key on (attention: s,t,d,g -- decode: b,d,g,t -- ssd: s,h,p,g,n --
    rglru: s,w).  ``batch``, ``kv_heads`` and ``lengths`` are input
    details outside the key: a cell can be timed at a served head layout,
    and a decode cell on the row lengths (one tuple of ``b`` lengths a set;
    none: ``served_lengths``) that its key sees when served.
    """
    kernel: str
    dims: Tuple[Tuple[str, int], ...]
    dtype: str = "float32"
    causal: bool = True
    window: int = 0
    batch: int = 1
    page_size: int = 0                # paged decode cells only
    kv_heads: int = 2
    lengths: Tuple[Tuple[int, ...], ...] = ()  # paged decode cells only

    def dim(self, name: str) -> int:
        return dict(self.dims)[name]

    @property
    def variant(self) -> str:
        if (self.kernel.startswith("flash_attention")
                or self.kernel == "decode_attention"):
            return reg.attention_variant(self.causal, self.window)
        return ""

    @property
    def key(self) -> str:
        return reg.make_key(self.kernel, dtype=self.dtype,
                            variant=self.variant, **dict(self.dims))

    def label(self) -> str:
        d = ",".join(f"{k}{v}" for k, v in self.dims)
        return f"{self.kernel}[{d},{self.dtype},{self.variant or 'na'}]"


def attn_case(kernel: str = "flash_attention", *, S: int, T: int = 0,
              D: int = 32, G: int = 2, dtype: str = "float32",
              causal: bool = True, window: int = 0, batch: int = 1,
              kv_heads: int = 2) -> Case:
    T = T or S
    return Case(kernel, (("d", D), ("g", G), ("s", S), ("t", T)),
                dtype=dtype, causal=causal, window=window, batch=batch,
                kv_heads=kv_heads)


def decode_case(*, B: int, T: int, D: int = 32, G: int = 2,
                page_size: int = 16, dtype: str = "float32",
                kv_heads: int = 2,
                lengths: Sequence[Sequence[int]] = ()) -> Case:
    """Paged-attention decode cell: (B, 1, cache_len T) over the page
    pool, keyed on the engine's decode bucket vocabulary
    (``decode_attention|b=…,d=…,g=…,t=…``)."""
    assert T % page_size == 0, (T, page_size)
    lengths = tuple(tuple(int(n) for n in ls) for ls in lengths)
    assert all(len(ls) == B and 0 <= min(ls) and max(ls) <= T
               for ls in lengths), (B, T, lengths)
    return Case("decode_attention", (("b", B), ("d", D), ("g", G), ("t", T)),
                dtype=dtype, batch=B, page_size=page_size,
                kv_heads=kv_heads, lengths=lengths)


def served_lengths(B: int, T: int) -> Tuple[int, ...]:
    """Row lengths of a decode step at the key (``B`` rows, tables of ``T``
    tokens) as the serving engine forms it.  Its table width is the
    power-of-two bucket of the longest row's pages, so that row holds more
    than T/2 tokens and the others fewer: the rows spread evenly from 3T/4
    down to 3T/(4B)."""
    return tuple(max(1, round(3 * T * (B - i) / (4 * B))) for i in range(B))


def ssd_case(*, S: int, H: int = 4, P: int = 16, G: int = 1, N: int = 32,
             dtype: str = "float32", batch: int = 1) -> Case:
    return Case("ssd", (("g", G), ("h", H), ("n", N), ("p", P), ("s", S)),
                dtype=dtype, batch=batch)


def rglru_case(*, S: int, W: int = 64, dtype: str = "float32",
               batch: int = 1) -> Case:
    return Case("rglru", (("s", S), ("w", W)), dtype=dtype, batch=batch)


# ---------------------------------------------------------------------------
# deterministic candidate enumeration
# ---------------------------------------------------------------------------
def _design_tile(case: Case) -> Dict[str, int]:
    t = _fa.tile(case.dim("d"), _DTYPES[case.dtype])
    if t is None:
        raise ValueError(f"no attention design serves {case.label()}")
    return {"block_q": t[0], "block_k": t[1]}


def candidates_for(case: Case) -> List[Dict[str, int]]:
    """Every legal knob config for ``case``, in sorted (deterministic)
    order."""
    if case.kernel not in KERNELS:
        raise ValueError(
            "flash_attention_xla has no counterpart in the port: the "
            "reference's XLA flash path has no CUDA kernel here"
            if case.kernel == "flash_attention_xla"
            else f"unknown kernel {case.kernel!r}")
    if case.kernel in ("flash_attention", "flash_attention_bwd"):
        return [_design_tile(case)]
    if case.kernel == "ssd":
        return [{"chunk": _sd.KERNEL_CHUNK}]
    seen: List[Dict[str, int]] = []
    if case.kernel == "decode_attention":
        ps = case.page_size
        P = case.dim("t") // ps
        for ppb in _PAGES_OPTS:
            if ppb > P or P % ppb:
                continue
            cand = {"block_q": 1, "block_k": ppb * ps}
            if cand not in seen:
                seen.append(cand)
        seen.sort(key=lambda c: c["block_k"])
    else:
        S = case.dim("s")
        for bs in _RGLRU_BLOCK_OPTS:
            cb = min(bs, S)
            if S % cb:
                continue
            cand = {"block_seq": cb}
            if cand not in seen:
                seen.append(cand)
        seen.sort(key=lambda c: c["block_seq"])
    return seen


def default_blocks(case: Case) -> Dict[str, int]:
    """The untuned config, fitted the way the reference's dispatch fits it:
    the design's tile; ``PIECE_TOKENS`` as whole pages dividing the table;
    the SSD kernel's own chunk; ``rglru.CHUNK`` dividing S."""
    if case.kernel in ("flash_attention", "flash_attention_bwd", "ssd"):
        return candidates_for(case)[0]
    if case.kernel == "decode_attention":
        ps = case.page_size
        P = case.dim("t") // ps
        ppb = reg.fit_block(max(_pa.PIECE_TOKENS // ps, 1), P)
        return {"block_q": 1, "block_k": ppb * ps}
    if case.kernel == "rglru":
        return {"block_seq": reg.fit_block(_rg.CHUNK, case.dim("s"))}
    raise ValueError(f"unknown kernel {case.kernel!r}")


def resolve(case: Case) -> Dict[str, int]:
    """The knobs that the dispatch resolves for ``case`` under the active
    registry (``kernels/ops.py``'s lookups with the port's defaults; for
    the RG-LRU, the chunk the kernel launches)."""
    dt = _DTYPES[case.dtype]
    if case.kernel in ("flash_attention", "flash_attention_bwd"):
        t = _design_tile(case)
        bq, bk = reg.attention_blocks(
            case.dim("s"), case.dim("t"), case.dim("d"), case.dim("g"), dt,
            case.causal, case.window, defaults=(t["block_q"], t["block_k"]),
            kernel=case.kernel)
        return {"block_q": bq, "block_k": bk}
    if case.kernel == "decode_attention":
        return {"block_q": 1, "block_k": ops.piece_tokens(
            case.dim("b"), case.dim("t"), case.dim("d"), case.dim("g"), dt)}
    if case.kernel == "ssd":
        return {"chunk": ops.ssd_chunk(
            case.dim("s"), case.dim("h"), case.dim("p"), case.dim("g"),
            case.dim("n"), dt)}
    if case.kernel == "rglru":
        return {"block_seq": ops.rglru_chunk(case.dim("s"), case.dim("w"),
                                             dt)}
    raise ValueError(f"unknown kernel {case.kernel!r}")


# ---------------------------------------------------------------------------
# input + callable construction
# ---------------------------------------------------------------------------
def _inputs(case: Case, device: torch.device, seed: int) -> tuple:
    """The reference's input distributions, from a generator on the case's
    device; a decode cell's row lengths are its set ``seed`` (cycled), else
    ``served_lengths``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = _DTYPES[case.dtype]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32)

    B = case.batch
    if case.kernel.startswith("flash_attention"):
        S, T, D, K = case.dim("s"), case.dim("t"), case.dim("d"), \
            case.kv_heads
        H = K * case.dim("g")
        q, k, v = (randn(B, n, h, D).to(dt)
                   for n, h in ((S, H), (T, K), (T, K)))
        if case.kernel == "flash_attention":
            return q, k, v
        return (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
                randn(B, S, H, D).to(dt))
    if case.kernel == "decode_attention":
        T, ps, D, K = case.dim("t"), case.page_size, case.dim("d"), \
            case.kv_heads
        B, P = case.dim("b"), T // ps
        n_pages = B * P
        q = randn(B, K * case.dim("g"), D).to(dt)
        kp = randn(n_pages + 1, ps, K, D).to(dt)
        vp = randn(n_pages + 1, ps, K, D).to(dt)
        # exclusive, non-contiguous tables, as the serving pool hands out
        tables = torch.arange(n_pages, dtype=torch.int32,
                              device=device).reshape(B, P).flip(1)
        tables = tables.contiguous()
        ls = (case.lengths[seed % len(case.lengths)] if case.lengths
              else served_lengths(B, T))
        lengths = torch.tensor(ls, dtype=torch.int32, device=device)
        return q, kp, vp, tables, lengths
    if case.kernel == "ssd":
        S, H, P = case.dim("s"), case.dim("h"), case.dim("p")
        G, N = case.dim("g"), case.dim("n")
        x = randn(B, S, H, P).to(dt)
        dt_ = torch.nn.functional.softplus(randn(B, S, H))
        A = -torch.exp(randn(H))
        Bm = (randn(B, S, G, N) * 0.5).to(dt)
        Cm = (randn(B, S, G, N) * 0.5).to(dt)
        return x, dt_, A, Bm, Cm
    if case.kernel == "rglru":
        S, W = case.dim("s"), case.dim("w")
        log_a = -torch.nn.functional.softplus(randn(B, S, W)).to(dt)
        return log_a, randn(B, S, W).to(dt)
    raise ValueError(f"unknown kernel {case.kernel!r}")


def build_call(case: Case, blocks: Dict[str, int], *,
               device="cuda", seed: int = 0) -> Tuple[Callable, tuple]:
    """(fn, args) for one candidate; fn(*args) runs the kernel once through
    the dispatch with the knobs ``blocks``."""
    args = _inputs(case, torch.device(device), seed)
    kw = dict(causal=case.causal, window=case.window)
    if case.kernel == "flash_attention":
        def fn(q, k, v):
            return ops.attention(q, k, v, block_q=blocks["block_q"],
                                 block_k=blocks["block_k"], **kw)
    elif case.kernel == "flash_attention_bwd":
        def fn(q, k, v, do):
            with torch.enable_grad():
                o = ops.attention(q, k, v, block_q=blocks["block_q"],
                                  block_k=blocks["block_k"], **kw)
            return torch.autograd.grad(o, (q, k, v), do)
    elif case.kernel == "decode_attention":
        def fn(*a):
            return ops.paged_attention(*a, block_k=blocks["block_k"])
    elif case.kernel == "ssd":
        def fn(*a):
            return ops.ssd(*a, chunk=blocks["chunk"])
    elif case.kernel == "rglru":
        def fn(*a):
            return ops.rglru(*a, block_seq=blocks["block_seq"])
    else:
        raise ValueError(f"unknown kernel {case.kernel!r}")
    return fn, args


def _plain(case: Case, args: tuple):
    """The plain version's output on ``args``.  For the backward cell: the
    stats-emitting forward is held to its plain version, and the plain
    backward runs on the forward's statistics, as ``chip_smoke.py``'s
    backward cases hold the kernels (with the plain statistics the bf16
    rounding of o moves delta, and with it the gradient of rows whose dP
    sits near delta)."""
    kw = dict(causal=case.causal, window=case.window)
    with torch.no_grad():
        if case.kernel == "flash_attention":
            return ops.attention(*args, impl="plain", **kw)
        if case.kernel == "flash_attention_bwd":
            q, k, v, do = (a.detach() for a in args)
            stats = _fab.flash_attention_fwd_stats(q, k, v, **kw)
            fwd = dataclasses.replace(case, kernel="flash_attention")
            _check_output(fwd, _design_tile(fwd), stats[0],
                          _fab.attention_fwd_stats_plain(q, k, v, **kw)[0])
            o, m, l = stats
            return _fab.attention_bwd_plain(
                q, k, v, do, m, l, _fab.attention_delta(o, do), **kw)
        if case.kernel == "decode_attention":
            return ops.paged_attention(*args, impl="plain")
        if case.kernel == "ssd":
            return ops.ssd(*args, chunk=_sd.KERNEL_CHUNK, impl="plain")
        return ops.rglru(*args, impl="plain")


def _scaled(got, want) -> Dict[str, float]:
    got, want = got.float(), want.float()
    diff = got - want
    rows = want.norm(dim=-1)
    floor = rows.flatten().median()
    return {"max_err_over_max_abs":
            float(diff.abs().max() / want.abs().max()),
            "rel_fro": float(diff.norm() / want.norm()),
            "row_rel_max": float((diff.norm(dim=-1)
                                  / torch.maximum(rows, floor)).max())}


def _check_output(case: Case, blocks: Dict[str, int], got, want
                 ) -> Dict[str, object]:
    """``got`` (a candidate's output) against ``want`` (the plain
    version's) at the kernel's tolerance; raises RuntimeError where it is
    not finite or not within it.  Returns the largest error and, where the
    kernel is held to scale, the scaled errors."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    what = f"autotune {case.label()} {blocks}"
    out: Dict[str, object] = {"max_abs_err": 0.0}
    atol = ELEMENT_TOL.get(case.kernel, {}).get(case.dtype)
    scaled_tol = (SSD_TOL if case.kernel == "ssd" else SCALED_TOL
                  if case.kernel != "rglru" and case.dtype == "bfloat16"
                  else None)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{what}: output {i} is not finite")
        err = float((g - w).abs().max())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if atol is not None and not bool(
                ((g - w).abs() <= atol + atol * w.abs()).all()):
            raise RuntimeError(f"{what}: output {i} max abs err {err} "
                               f"exceeds atol=rtol={atol}")
        if scaled_tol is not None:
            s = _scaled(g, w)
            if any(v > scaled_tol[k] for k, v in s.items()):
                raise RuntimeError(f"{what}: output {i} scaled errors {s} "
                                   f"exceed {scaled_tol}")
            out.setdefault("scaled", []).append(s)
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_call(fn: Callable, arg_sets: Sequence[tuple], *, iters: int = 10,
              rounds: int = 5) -> float:
    """Median us/call of ``fn`` over ``rounds`` rounds of ``iters`` calls on
    each argument set of ``arg_sets`` in turn, after a warm-up.  On the card
    the events time replays of one CUDA graph of the launches (the Python
    that enqueues them is not timed); on the CPU the host clock times the
    calls."""
    n = max(1, iters) * len(arg_sets)
    dev = next(a.device for a in arg_sets[0] if isinstance(a, torch.Tensor))
    if dev.type != "cuda":
        for a in arg_sets:
            fn(*a)
        ts = []
        for _ in range(max(1, rounds)):
            t0 = time.perf_counter()
            for _ in range(max(1, iters)):
                for a in arg_sets:
                    fn(*a)
            ts.append((time.perf_counter() - t0) / n)
        return statistics.median(ts) * 1e6
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for a in arg_sets:                 # builds, first launches
            fn(*a)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(cur)
    # capture_begin / capture_end, not ``torch.cuda.graph``, which collects
    # garbage and empties the allocator's cache at every capture
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(max(1, iters)):
                for a in arg_sets:
                    fn(*a)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    graph.replay()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(max(1, rounds)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(dev)
        ts.append(start.elapsed_time(end) / n)
    return statistics.median(ts) * 1e3


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CaseResult:
    case: Case
    entry: reg.TunedEntry
    timings: List[Tuple[Dict[str, int], float]]   # (blocks, us) per cand
    errors: List[Dict[str, object]]               # _check_output per cand

    def to_json(self) -> Dict[str, object]:
        return {
            "key": self.case.key,
            "kernel": self.case.kernel,
            "best": self.entry.blocks,
            "us": self.entry.us,
            "default": default_blocks(self.case),
            "default_us": self.entry.default_us,
            "speedup": self.entry.speedup,
            "candidates": [{"blocks": b, "us": us, **e}
                           for (b, us), e in zip(self.timings,
                                                 self.errors)],
        }


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "autotune: no CUDA device; the sweep times the kernels on the "
            "card (device='cpu' times their plain versions)")
    return dev


def _copies(case: Case, args: tuple, dev: torch.device) -> int:
    """Input sets to cycle: every set of decode row lengths the cell
    carries, and on the card enough that a launch finds its inputs past the
    L2 (at most 8)."""
    if dev.type != "cuda":
        return max(1, len(case.lengths))
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    return max(1, len(case.lengths),
               min(8, -(-2 * L2_BYTES // max(nbytes, 1))))


def tune_case(case: Case, *, iters: int = 10, device="cuda") -> CaseResult:
    """Hold every candidate of one cell to the plain version on every input
    set, then time it on those sets; return the measured winner.  Leaves
    the launch counts as it found them."""
    dev = _device(device)
    cands = candidates_for(case)
    default = default_blocks(case)
    timings: List[Tuple[Dict[str, int], float]] = []
    errors: List[Dict[str, object]] = []
    best: Optional[Dict[str, int]] = None
    best_us = float("inf")
    default_us = 0.0
    counts = ops.launch_counts()
    wants = None
    try:
        for blocks in cands + ([] if default in cands else [default]):
            fn, args = build_call(case, blocks, device=dev)
            sets = [args] + [build_call(case, blocks, device=dev, seed=s)[1]
                             for s in range(1, _copies(case, args, dev))]
            if wants is None:
                wants = [_plain(case, a) for a in sets]
            errs = [_check_output(case, blocks, fn(*a), w)
                    for a, w in zip(sets, wants)]
            err = {"max_abs_err": max(e["max_abs_err"] for e in errs)}
            if "scaled" in errs[0]:
                err["scaled"] = [s for e in errs for s in e["scaled"]]
            us = time_call(fn, sets, iters=iters)
            if blocks == default:
                default_us = us
            if blocks not in cands:
                continue          # measured for the speedup only
            timings.append((blocks, us))
            errors.append(err)
            if us < best_us:
                best, best_us = blocks, us
    finally:
        ops.add_launch_counts({k: counts[k] - v
                               for k, v in ops.launch_counts().items()})
    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    entry = reg.TunedEntry(blocks=dict(best or default), us=best_us,
                           default_us=default_us, n_candidates=len(cands),
                           backend=backend)
    return CaseResult(case, entry, timings, errors)


def tune(cases: Sequence[Case], *, iters: int = 10,
         registry: Optional[reg.Registry] = None, verbose: bool = False,
         device="cuda") -> Tuple[reg.Registry, List[CaseResult]]:
    """Sweep every case into ``registry`` (a new one when None)."""
    _device(device)
    registry = registry if registry is not None else reg.Registry()
    results: List[CaseResult] = []
    for case in cases:
        res = tune_case(case, iters=iters, device=device)
        registry.put(case.key, res.entry)
        results.append(res)
        if verbose:
            print(f"{case.label():60s} best={res.entry.blocks} "
                  f"{res.entry.us:9.1f}us (default "
                  f"{res.entry.default_us:9.1f}us, "
                  f"x{res.entry.speedup:.2f})")
    return registry, results


def sweep(cases: Optional[Sequence[Case]] = None, *, iters: int = 10,
          path: Optional[str] = None, merge: bool = True,
          verbose: bool = False, device="cuda"
          ) -> Tuple[reg.Registry, List[CaseResult]]:
    """tune() + persist: merge into the registry at ``path`` and save; the
    winners are installed in this process too (``set_registry``)."""
    cases = list(cases if cases is not None else DEFAULT_CASES)
    path = path or reg.DEFAULT_PATH
    registry = None
    if merge:
        try:
            registry = reg.Registry.load(path)
        except (OSError, ValueError, KeyError):
            registry = None
    registry, results = tune(cases, iters=iters, registry=registry,
                             verbose=verbose, device=device)
    registry.save(path)
    reg.set_registry(registry)
    return registry, results


def _decode_cells(arch: str, batches: Sequence[int], pages: Sequence[int],
                  page_size: int = 16) -> Tuple[Case, ...]:
    """Decode cells of ``arch``'s served head layout in bf16: each batch
    bucket at each table width (in pages of ``page_size``)."""
    cfg = get_config(arch)
    return tuple(decode_case(B=b, T=p * page_size, D=cfg.head_dim,
                             G=cfg.n_heads // cfg.n_kv_heads,
                             page_size=page_size, dtype="bfloat16",
                             kv_heads=cfg.n_kv_heads)
                 for b in batches for p in pages)


# The standing grids.  SMOKE: small shapes of every kernel (seconds on the
# CPU's plain versions).  DEFAULT: the cells of the port's main path on the
# card -- llama3.2-3b's paged decode at every step key its engine captures
# (row buckets 1-8 x table widths 1-128 pages of 16, 8 slots x 2048; row
# lengths by ``served_lengths`` unless a caller records them); the
# (1, 2048) and (8, 2048) cells of stablelm-12b (D = 160, G = 4),
# moonshot-v1-16b-a3b (G = 1 on 16 KV heads) and llama4-scout (G = 5);
# recurrentgemma-2b's RG-LRU at its served prefill buckets (16-4096 steps,
# W = 2560) and its trained (2, 4096); one cell each of B1 (a 2048-token
# prefill) and B2 (the trained 2 x 4096) at llama's heads and of the SSD at
# mamba2-780m's 2048-token prefill.
SMOKE_CASES: Tuple[Case, ...] = (
    attn_case("flash_attention", S=128, D=32, G=2),
    attn_case("flash_attention", S=128, D=32, G=2, window=64),
    attn_case("flash_attention_bwd", S=128, D=32, G=2),
    decode_case(B=4, T=128, D=32, G=2, page_size=16),
    ssd_case(S=128, H=4, P=16, G=1, N=32),
    rglru_case(S=128, W=64),
)

DEFAULT_CASES: Tuple[Case, ...] = (
    _decode_cells("llama3.2-3b", (1, 2, 4, 8),
                  (1, 2, 4, 8, 16, 32, 64, 128))
    + _decode_cells("stablelm-12b", (1, 8), (128,))
    + _decode_cells("moonshot-v1-16b-a3b", (1, 8), (128,))
    + _decode_cells("llama4-scout-17b-a16e", (1, 8), (128,))
    + tuple(rglru_case(S=2 ** i, W=2560) for i in range(4, 13))
    + (rglru_case(S=4096, W=2560, batch=2),
       attn_case("flash_attention", S=2048, D=128, G=3, kv_heads=8,
                 dtype="bfloat16"),
       attn_case("flash_attention_bwd", S=4096, D=128, G=3, kv_heads=8,
                 dtype="bfloat16", batch=2),
       ssd_case(S=2048, H=48, P=64, G=1, N=128, dtype="bfloat16"))
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes of every kernel instead of the main "
                         "path's cells")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=reg.DEFAULT_PATH)
    ap.add_argument("--no-merge", action="store_true",
                    help="overwrite instead of merging into --out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    args = ap.parse_args(argv)
    cases = SMOKE_CASES if args.smoke else DEFAULT_CASES
    registry, _ = sweep(cases, iters=args.iters, path=args.out,
                        merge=not args.no_merge, verbose=True,
                        device=args.device)
    print(f"wrote {len(registry)} tuned config(s) to {registry.path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
