"""AdamW with decoupled weight decay, held against ``repro/optim/adamw.py``
(``apply``: lines 72-109).

The same rule as the reference, step for step: the gradients are clipped to
the global norm first; the bias corrections use the incremented step; weight
decay ``weight_decay * base`` is added only where the parameter has
``ndim >= 2``, on the fp32 base value (the master copy where there is one);
the metrics are ``grad_norm`` (before clipping) and ``lr``.
``torch.optim.AdamW`` differs on all three points, so it is not used.

Where the reference builds new pytrees, this updates in place, one tensor at
a time: the moments, the masters and the parameters are overwritten, and
the temporaries are those of one tensor (a few copies of the largest one),
never a second copy of the whole state.  Parameters, gradients and moments
are dicts keyed by parameter name (``dict(model.named_parameters())``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0          # global-norm clip; 0 disables
    accum_dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class AdamWState:
    step: int                       # optimizer steps taken
    m: Dict[str, torch.Tensor]      # like params, in accum_dtype
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]] = None   # fp32 masters


def init(params: Mapping[str, torch.Tensor],
         cfg: AdamWConfig = AdamWConfig(), *,
         master_weights: bool = False) -> AdamWState:
    """``master_weights=True`` keeps fp32 copies of the parameters in the
    state, so that the parameters themselves can live in bf16."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.accum_dtype, device=p.device)

    master = ({n: p.detach().to(torch.float32, copy=True)
               for n, p in params.items()} if master_weights else None)
    return AdamWState(step=0, m={n: zeros(p) for n, p in params.items()},
                      v={n: zeros(p) for n, p in params.items()},
                      master=master)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (a 0-d tensor
    on the tensors' device: no host synchronisation)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """New clipped gradients (each in its own dtype) and the norm before
    clipping."""
    norm = global_norm(grads.values())
    scale = _clip_scale(norm, max_norm)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, \
        norm


def _correction(beta: float, step: int) -> float:
    """``1 - beta ** step`` in float32, as the reference computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step))


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: AdamWState,
          cfg: AdamWConfig = AdamWConfig(), *, lr: Optional[float] = None
          ) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                     Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    names = list(params)
    gnorm = global_norm(grads[n] for n in names)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr_t = cfg.lr if lr is None else float(lr)
    b1c, b2c = _correction(cfg.b1, step), _correction(cfg.b2, step)
    acc = cfg.accum_dtype
    for n in names:
        p, g, m, v = params[n], grads[n], state.m[n], state.v[n]
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        g32 = g.to(acc)
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if state.master is not None:
            base = state.master[n]
        elif p.dtype == acc:
            base = p
        else:
            base = p.to(acc)
        if p.ndim >= 2:
            delta.add_(base, alpha=cfg.weight_decay)
        base.sub_(delta, alpha=lr_t)        # base - lr * (delta + decay)
        if base is not p:
            p.copy_(base)
    state.step = step
    return params, state, {
        "grad_norm": gnorm,
        "lr": torch.tensor(lr_t, dtype=torch.float32, device=gnorm.device)}
