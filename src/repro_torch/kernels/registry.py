"""Tuned-config registry: measured-best kernel knobs, held against
``repro/kernels/registry.py``.

The autotuner (``repro_torch.kernels.autotune``) times every candidate of a
(kernel, shape-bucket, dtype, variant) cell on the card and writes the
winners here; the dispatch layer (``repro_torch.kernels.ops``) resolves a
knob left at ``None`` from this registry when the kernel is called.  Keys,
the JSON file, lookups and ``kernel_speedups`` are the reference's, byte for
byte:

    <kernel>|<dim>=<bucket>,...|<dtype>|<variant>

e.g. ``decode_attention|b=8,d=128,g=3,t=2048|bfloat16|causal``.  Sequence
and batch dims (``s``, ``t``, ``b``) are bucketed to the next power of two;
head and feature dims are exact.

Registry file schema:

    {"version": 1,
     "schema_version": 1,
     "configs": {"<key>": {"blocks": {"block_k": 64, ...},
                           "us": 21.7,           # best measured us/call
                           "default_us": 24.9,   # default-config us/call
                           "n_candidates": 5,
                           "backend": "NVIDIA H100 80GB HBM3"}}}

One departure from the reference: ``get_registry()`` returns what
``set_registry`` installed, else the file that ``$REPRO_TORCH_TUNED_CONFIGS``
names, else None.  It reads no default path (the reference falls back to
``results/tuned_configs.json``, timings of its Pallas interpreter on a CPU)
and never ``$REPRO_TUNED_CONFIGS``, so a file that one run left behind
changes no later run.  A malformed file behaves as untuned, as in the
reference.  A lookup that misses gives the caller's defaults, and with no
registry every kernel launches as it does untuned.

The per-kernel resolvers below are the reference's, which fit a knob to
divide S or T as its Pallas grids need; the port's dispatch reads the
registry through ``kernels.ops`` (``piece_tokens``, ``rglru_chunk``,
``ssd_chunk``) and fits nothing to the shape, since its kernels take any S
and cut whole pages themselves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# where ``Registry.save`` and the autotuner's CLI write by default; nothing
# reads it unless ``$REPRO_TORCH_TUNED_CONFIGS`` names it
DEFAULT_PATH = os.path.join("results", "torch", "tuned_configs.json")
ENV_VAR = "REPRO_TORCH_TUNED_CONFIGS"

# bucketed dims (next pow2 >= floor); others exact.  ``b`` (decode batch)
# buckets from 1 so tiny serving batches don't all collapse into one cell
_BUCKET_FLOOR = {"s": 32, "t": 32, "b": 1}


def bucket_pow2(n: int, floor: int = 32) -> int:
    """Next power of two >= n (>= floor): shape buckets for seq dims."""
    b = floor
    while b < n:
        b *= 2
    return b


def make_key(kernel: str, *, dtype: str, variant: str = "",
             **dims: int) -> str:
    """Canonical registry key; seq/batch dims (s, t, b) are bucketed to
    the next power of two, every other dim (head/feature widths) stays
    exact."""
    parts = []
    for name in sorted(dims):
        v = int(dims[name])
        if name in _BUCKET_FLOOR:
            v = bucket_pow2(v, _BUCKET_FLOOR[name])
        parts.append(f"{name}={v}")
    return f"{kernel}|{','.join(parts)}|{dtype}|{variant}"


@dataclasses.dataclass
class TunedEntry:
    """One registry cell: winning blocks + the measurement behind them."""
    blocks: Dict[str, int]
    us: float = 0.0                   # best candidate, measured us/call
    default_us: float = 0.0           # default config, measured us/call
    n_candidates: int = 0
    backend: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, js: Mapping[str, Any]) -> "TunedEntry":
        return cls(blocks={k: int(v) for k, v in js["blocks"].items()},
                   us=float(js.get("us", 0.0)),
                   default_us=float(js.get("default_us", 0.0)),
                   n_candidates=int(js.get("n_candidates", 0)),
                   backend=str(js.get("backend", "")))

    @property
    def speedup(self) -> float:
        """Measured default/best ratio (1.0 when either side is missing)."""
        if self.us <= 0 or self.default_us <= 0:
            return 1.0
        return self.default_us / self.us


class Registry:
    """In-memory tuned-config table with JSON round-trip."""

    def __init__(self, entries: Optional[Dict[str, TunedEntry]] = None,
                 path: str = ""):
        self.entries: Dict[str, TunedEntry] = dict(entries or {})
        self.path = path

    def get(self, key: str) -> Optional[TunedEntry]:
        return self.entries.get(key)

    def put(self, key: str, entry: TunedEntry) -> None:
        self.entries[key] = entry

    def lookup(self, kernel: str, defaults: Mapping[str, int], *,
               dtype: str, variant: str = "", **dims: int) -> Dict[str, int]:
        """Tuned blocks for the cell, or ``defaults`` on a miss."""
        entry = self.get(make_key(kernel, dtype=dtype, variant=variant,
                                  **dims))
        if entry is None:
            return dict(defaults)
        out = dict(defaults)
        out.update(entry.blocks)
        return out

    def __len__(self) -> int:
        return len(self.entries)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or DEFAULT_PATH
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        js = {"version": 1,
              "schema_version": 1,
              "configs": {k: e.to_json()
                          for k, e in sorted(self.entries.items())}}
        with open(path, "w") as f:
            json.dump(js, f, indent=2)
            f.write("\n")
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "Registry":
        with open(path) as f:
            js = json.load(f)
        entries = {k: TunedEntry.from_json(v)
                   for k, v in js.get("configs", {}).items()}
        return cls(entries, path=path)


# ---------------------------------------------------------------------------
# process-wide active registry (dispatch-time resolution)
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_active: Optional[Registry] = None
_loaded = False


def set_registry(reg: Optional[Registry]) -> None:
    """Install ``reg`` as the process-wide registry (None -> defaults)."""
    global _active, _loaded
    with _lock:
        _active = reg
        _loaded = True


def reset_registry() -> None:
    """Drop the installed registry; the next lookup reads
    ``$REPRO_TORCH_TUNED_CONFIGS`` again."""
    global _active, _loaded
    with _lock:
        _active = None
        _loaded = False


def get_registry() -> Optional[Registry]:
    """The active registry: set_registry() > the file that
    ``$REPRO_TORCH_TUNED_CONFIGS`` names > None (pure defaults).  The answer
    is cached until ``set_registry`` or ``reset_registry``; with no registry
    it returns at once."""
    global _active, _loaded
    if _loaded:
        return _active
    with _lock:
        if _loaded:
            return _active
        path = os.environ.get(ENV_VAR, "")
        if path and os.path.exists(path):
            try:
                _active = Registry.load(path)
            except (OSError, ValueError, KeyError):
                _active = None       # malformed file: behave as untuned
        _loaded = True
        return _active


# ---------------------------------------------------------------------------
# per-kernel resolvers (the shape-keyed lookups the dispatch calls)
# ---------------------------------------------------------------------------
def fit_block(block: int, dim: int) -> int:
    """Largest size <= ``block`` that divides ``dim`` (at most ``block``
    decrements)."""
    b = max(1, min(int(block), int(dim)))
    while dim % b:
        b -= 1
    return b


def _dtype_name(dtype) -> str:
    """The reference's dtype names (``float32``, ``bfloat16``) for a torch
    dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    import numpy as np
    try:
        return np.dtype(dtype).name
    except TypeError:
        return getattr(dtype, "name", None) or str(dtype)


def attention_variant(causal: bool, window: int) -> str:
    if window > 0:
        return "window"
    return "causal" if causal else "full"


def attention_blocks(S: int, T: int, D: int, G: int, dtype,
                     causal: bool, window: int,
                     defaults: Tuple[int, int] = (256, 256),
                     kernel: str = "flash_attention") -> Tuple[int, int]:
    """(block_q, block_k) for an attention cell; defaults on miss."""
    reg = get_registry()
    if reg is None:
        return defaults
    out = reg.lookup(kernel, {"block_q": defaults[0], "block_k": defaults[1]},
                     dtype=_dtype_name(dtype),
                     variant=attention_variant(causal, window),
                     s=S, t=T, d=D, g=G)
    return fit_block(out["block_q"], S), fit_block(out["block_k"], T)


def decode_attention_blocks(B: int, T: int, D: int, G: int, dtype,
                            causal: bool = True, window: int = 0,
                            defaults: Tuple[int, int] = (1, 256),
                            kernel: str = "decode_attention"
                            ) -> Tuple[int, int]:
    """(block_q, block_k) for the (B, 1, cache_len) decode shape, keyed on
    the batch bucket and the cache length
    (``decode_attention|b=<batch>,d=…,g=…,t=<cache_len>``); ``block_q`` is
    1, ``block_k`` is fitted to ``T``."""
    reg = get_registry()
    if reg is None:
        return 1, fit_block(defaults[1], T)
    out = reg.lookup(kernel,
                     {"block_q": defaults[0], "block_k": defaults[1]},
                     dtype=_dtype_name(dtype),
                     variant=attention_variant(causal, window),
                     b=B, t=T, d=D, g=G)
    return fit_block(out["block_q"], 1), fit_block(out["block_k"], T)


def ssd_chunk(S: int, H: int, P: int, G: int, N: int, dtype,
              default: int = 256) -> int:
    reg = get_registry()
    if reg is None:
        return default
    return fit_block(
        reg.lookup("ssd", {"chunk": default}, dtype=_dtype_name(dtype),
                   s=S, h=H, p=P, g=G, n=N)["chunk"], S)


def rglru_block(S: int, W: int, dtype, default: int = 128) -> int:
    reg = get_registry()
    if reg is None:
        return default
    return fit_block(
        reg.lookup("rglru", {"block_seq": default},
                   dtype=_dtype_name(dtype), s=S, w=W)["block_seq"], S)


def kernel_speedups(reg: Optional[Registry] = None) -> Dict[str, float]:
    """Per-kernel measured speedup (default_us / best_us), averaged over
    every tuned cell of that kernel -- the calibration signal
    ``core.costmodel.CalibratedCost`` layers onto the analytic terms.
    Uses the active registry when ``reg`` is None."""
    reg = reg if reg is not None else get_registry()
    if reg is None:
        return {}
    acc: Dict[str, Tuple[float, int]] = {}
    for key, entry in reg.entries.items():
        kernel = key.split("|", 1)[0]
        s = entry.speedup
        if s <= 0:
            continue
        tot, n = acc.get(kernel, (0.0, 0))
        acc[kernel] = (tot + s, n + 1)
    return {k: tot / n for k, (tot, n) in acc.items() if n}
