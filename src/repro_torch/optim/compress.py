"""Int8 error-feedback gradient compression (beyond-paper optimization),
held against ``repro/optim/compress.py``.

The paper mitigates the slow composed fabric with mixed precision and ZeRO
(§V-4).  The next rung on the same ladder -- not available in its 2021
stack -- is lossy gradient compression with error feedback (1-bit Adam /
PowerSGD family): symmetric per-tensor int8 with a globally-agreed scale
and local error carry, applied only to the *slow* (cross-pod) hop
(``core/hierarchy.allreduce_int8_ef``).

The same arithmetic as the reference: fp32 throughout, ``torch.round``
rounds half to even as ``jnp.round`` does, the same clip to [-127, 127]
and the same ``1e-30`` floor under the scale.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def int8_encode(x: torch.Tensor,
                global_max: Callable[[torch.Tensor], torch.Tensor]
                = lambda m: m) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize fp32 -> int8 against a (collectively agreed) scale.

    ``global_max``: hook to maximize the scale across participants (a MAX
    all-reduce over the reduction group) so every rank uses the same grid.
    """
    m = global_max(x.abs().max())
    scale = torch.clamp(m, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_leaf(g: torch.Tensor, residual: torch.Tensor,
                     global_max=lambda m: m
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, residual) -> (int8 payload, scale, new residual)."""
    y = g.to(torch.float32) + residual
    q, scale = int8_encode(y, global_max)
    new_r = y - int8_decode(q, scale)
    return q, scale, new_r


def compression_ratio(dtype=torch.float32) -> float:
    """Wire-byte ratio of int8 vs the uncompressed dtype."""
    return torch.empty((), dtype=dtype).element_size() / 1.0
