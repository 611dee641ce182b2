"""Shape-bucket helpers, held against ``repro/kernels/registry.py``.

Only ``bucket_pow2`` and ``fit_block`` are here: the serving engine pads
its steps' batch rows, block-table widths and prompt lengths to the first's
buckets (the keys of its CUDA graphs, ``serve/graphs.py``), and the second
fits a tile to a dimension.  The tuned-config registry itself arrives with the
autotuner.
"""
from __future__ import annotations


def bucket_pow2(n: int, floor: int = 32) -> int:
    """Next power of two >= n (>= floor): shape buckets for seq dims."""
    b = floor
    while b < n:
        b *= 2
    return b


def fit_block(block: int, dim: int) -> int:
    """Largest size <= ``block`` that divides ``dim`` (at most ``block``
    decrements)."""
    b = max(1, min(int(block), int(dim)))
    while dim % b:
        b -= 1
    return b
