"""Training step builder, held against ``repro/train/trainer.py``:
``make_run_ctx`` (lines 91-111), ``init_state`` (114-123), ``make_loss_fn``
(144-159), ``_accum_grads`` (162-185), ``make_train_step`` (191-225) and
``StepTracker`` (292-345).

The step is ``train_step(state, batch) -> (state, metrics)`` as in the
reference; it updates the state **in place** (parameters, moments and
masters are overwritten tensor by tensor) and returns it.  Each
parameter's ``.grad`` holds the step's (unclipped, accumulated) gradient
until the next step.  Metrics are 0-d tensors on the device: reading one
waits for the step to finish.

Not ported: meshes and with them ZeRO sharding and the manual-pod
gradient exchange with ``grad_compression="int8_ef"`` (ROADMAP queue A item
7; ``zero_stage`` has no effect without a mesh, as in the reference's
un-sharded jit).
``rglru`` blocks train through ``RGLRUFn`` (the forward kernel and the
hand-written RG-LRU backward), ``ssm`` blocks through ``SSDFn`` (the SSD
forward kernel and the hand-written SSD backward) and ``attn_local`` blocks
through the windowed attention kernels, as ``attn`` blocks do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig, PolicyConfig, ShapeConfig
from repro_torch.configs.paper_bench import VisionConfig
from repro_torch.models import bert, lm, vision
from repro_torch.models.lm import LM
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import adamw, schedule

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_MESH = ("meshes are not ported yet: ROADMAP queue A item 7 (the parallel "
         "layer)")


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def make_run_ctx(cfg: ModelConfig, policy: PolicyConfig, mesh=None, *,
                 seq_len: Optional[int] = None, decode: bool = False,
                 batch: Optional[int] = None) -> RunCtx:
    """``seq_len`` / ``decode`` / ``batch`` key the reference's tuned-tile
    lookup for ``RunCtx.attn_blocks``, the tiles of its XLA flash path
    (``repro/train/trainer.py:64-90``).  The port has no such path, and its
    attention kernels launch the one tile of their design
    (``kernels/ops.py``), so they are accepted and unused; the knobs that
    the registry does tune resolve in ``kernels/ops.py`` when a kernel is
    called."""
    del cfg, seq_len, decode, batch
    if mesh is not None:
        raise NotImplementedError(_MESH)
    if policy.attn_impl not in ("kernel", "full"):
        raise ValueError(f"attn_impl {policy.attn_impl!r} not in "
                         f"('kernel', 'full')")
    return RunCtx(compute_dtype=_dt(policy.compute_dtype),
                  attn_impl=policy.attn_impl, remat=policy.remat)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
class TrainState:
    """The model (its parameters) and the optimizer state."""

    def __init__(self, model: LM, opt: adamw.AdamWState):
        self.model = model
        self.opt = opt

    @classmethod
    def create(cls, model: LM, policy: PolicyConfig,
               optcfg: adamw.AdamWConfig = adamw.AdamWConfig()
               ) -> "TrainState":
        """Fresh optimizer state for ``model`` (fp32 masters when the
        parameters are bf16, as ``init_state`` decides in the reference)."""
        return cls(model, adamw.init(
            dict(model.named_parameters()), optcfg,
            master_weights=(policy.param_dtype == "bfloat16")))

    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.model.device


def init_state(cfg: ModelConfig, policy: PolicyConfig,
               optcfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
               seed: int = 0, device="cuda") -> TrainState:
    """Random weights from ``seed`` on ``device`` (the GPU unless the caller
    names the CPU) in ``policy.param_dtype``, and fresh AdamW state."""
    model = LM.init(cfg, seed=seed, dtype=_dt(policy.param_dtype),
                    device=device)
    return TrainState.create(model, policy, optcfg)


# ---------------------------------------------------------------------------
# loss / grads
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, policy: PolicyConfig, mesh=None,
                 seq_len: Optional[int] = None) -> Callable:
    """``loss_fn(model, batch) -> (loss, metrics)``.  A padded vocabulary of
    32768 or more takes the chunked cross entropy with the largest chunk in
    (512, 256, 128, 64, 1) that divides the sequence, as the reference."""
    ctx = make_run_ctx(cfg, policy, mesh, seq_len=seq_len)
    big_vocab = cfg.padded_vocab >= 32_768

    def loss_fn(model: LM, batch):
        chunk = 0
        if big_vocab:
            S = batch["labels"].shape[1]
            chunk = next(c for c in (512, 256, 128, 64, 1) if S % c == 0)
        return lm.lm_loss(model, batch, ctx, xent_chunk=chunk)

    return loss_fn


def _detach(metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def _grads(params) -> Dict[str, torch.Tensor]:
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def _accum_grads(loss_fn, model: LM, batch, n_accum: int):
    """Returns (grads by parameter name, mean loss, the last microbatch's
    metrics).  With ``n_accum > 1`` the batch is cut into ``n_accum``
    microbatches along its first axis and their gradients are summed in fp32
    and divided by ``n_accum``: autograd sums straight into the fp32
    ``.grad`` of fp32 parameters; other parameters get fp32 buffers."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    if n_accum <= 1:
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        return _grads(params), loss.detach(), _detach(metrics)

    B = next(iter(batch.values())).shape[0]
    b = B // n_accum
    fp32 = all(p.dtype == torch.float32 for p in params.values())
    acc = None if fp32 else {
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in params.items()}
    loss_sum = None
    for i in range(n_accum):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        loss, metrics = loss_fn(model, mb)
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None \
            else loss_sum + loss.detach()
        if acc is not None:
            for n, p in params.items():
                if p.grad is not None:
                    acc[n] += p.grad.float()
                    p.grad = None
    if acc is None:
        acc = _grads(params)
    for g in acc.values():
        g.div_(n_accum)
    return acc, loss_sum / n_accum, _detach(metrics)


def _device_batch(batch, device) -> Dict[str, Any]:
    """Each array of ``batch`` on ``device``; a list or tuple of arrays
    (YOLO's three target maps) becomes a list of tensors."""
    def put(v):
        return torch.as_tensor(v).to(device)

    return {k: [put(x) for x in v] if isinstance(v, (list, tuple)) else put(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, policy: PolicyConfig,
                    optcfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    schedcfg: Optional[schedule.ScheduleConfig] = None,
                    mesh=None,
                    shape: Optional[ShapeConfig] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``xent``, ``aux``, ``grad_norm`` and ``lr``.  ``batch`` holds
    numpy arrays or tensors; they are moved to the state's device."""
    if mesh is not None:
        what = (" (and with it the manual-pod exchange of "
                "grad_compression='int8_ef')"
                if policy.grad_compression == "int8_ef" else "")
        raise NotImplementedError(_MESH + what)
    seq_len = shape.seq_len if shape is not None else None
    return make_step(make_loss_fn(cfg, policy, mesh, seq_len=seq_len),
                     optcfg, schedcfg, n_accum=policy.grad_accum)


def make_step(loss_fn: Callable,
              optcfg: adamw.AdamWConfig = adamw.AdamWConfig(),
              schedcfg: Optional[schedule.ScheduleConfig] = None, *,
              n_accum: int = 1) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for any model and
    ``loss_fn(model, batch) -> (loss, metrics)``: the loss, its backward
    (``_accum_grads``) and ``adamw.apply``, metrics as ``make_train_step``'s.
    The reference's Table II models have no step beyond ``value_and_grad``
    of their loss (``tests/test_paper_bench.py``); they take this one with
    ``paper_loss_fn``."""

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        batch = _device_batch(batch, state.device)
        grads, loss, metrics = _accum_grads(loss_fn, state.model, batch,
                                            n_accum)
        lr = None
        if schedcfg is not None:
            lr = schedule.lr_at(state.opt.step, schedcfg)
        _, _, om = adamw.apply(state.params(), grads, state.opt, optcfg,
                               lr=lr)
        return state, dict(metrics, **om, loss=loss)

    return train_step


def paper_loss_fn(cfg, policy: PolicyConfig) -> Callable:
    """``loss_fn(model, batch)`` of a Table II workload: ``bert.qa_loss``
    under ``policy``'s run context for BERT (a ``ModelConfig``), or
    ``vision.vision_loss`` for a ``VisionConfig`` (fp32, as the
    reference; the policy's dtypes do not apply)."""
    if isinstance(cfg, VisionConfig):
        def vision_loss_fn(model, batch):
            loss = vision.vision_loss(model, batch)
            return loss, {"loss": loss}

        return vision_loss_fn
    ctx = make_run_ctx(cfg, policy)
    return lambda model, batch: bert.qa_loss(model, batch, ctx)


# ---------------------------------------------------------------------------
# run tracking -- per-step loss / step_s / tokens-per-s into the tracking plane
# ---------------------------------------------------------------------------
class StepTracker:
    """Adapter from the training loop to the tracking plane.

    Call :meth:`step` once per optimizer step with the step's metrics
    dict; it derives wall-clock ``step_s`` and ``tokens_per_s`` from an
    injectable clock and logs one tracking row per step (plus a system
    sample every ``system_every`` steps).  All methods are no-ops when
    no run is active, so the loop needs no tracking conditionals.

    Reading a metric (``float`` of a 0-d device tensor) waits for the step
    to finish: a loop that times its steps on the host synchronizes first.
    """

    def __init__(self, tokens_per_step: int, run=None, *,
                 clock=None, system_every: int = 50):
        import time as _time
        from repro_torch import tracking
        self.run = run if run is not None else tracking.current_run()
        self.tokens_per_step = tokens_per_step
        self.clock = clock or _time.time
        self.system_every = max(int(system_every), 1)
        self._last_t: Optional[float] = None
        self._n = 0
        self._loss: Optional[float] = None
        self._tok_s = 0.0

    def step(self, step: int, metrics: Mapping[str, Any]) -> None:
        if self.run is None:
            return
        now = self.clock()
        row: Dict[str, Any] = {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float)) or hasattr(v, "item")}
        if self._last_t is not None:
            step_s = now - self._last_t
            row["step_s"] = step_s
            row["tokens_per_s"] = (self.tokens_per_step / step_s
                                   if step_s > 0 else 0.0)
            self._tok_s = row["tokens_per_s"]
        self._last_t = now
        self._n += 1
        self._loss = row.get("loss", self._loss)
        self.run.log(row, step=step + 1)
        if self._n % self.system_every == 0:
            self.run.log_system()

    def summary(self) -> Dict[str, Any]:
        """Final-row metrics; also merged into the run summary."""
        out: Dict[str, Any] = {"steps": self._n,
                               "tokens_per_s": self._tok_s}
        if self._loss is not None:
            out["final_loss"] = self._loss
        if self.run is not None:
            self.run.log_summary(out)
        return out
