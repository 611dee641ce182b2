"""Training step builder, held against ``repro/train/trainer.py``:
``make_run_ctx`` (lines 91-111), ``init_state`` (114-123), ``state_specs``
(126-137), ``make_loss_fn`` (144-159), ``_accum_grads`` (162-185),
``make_train_step`` (191-266) and ``StepTracker`` (292-345).

The step is ``train_step(state, batch) -> (state, metrics)`` as in the
reference; it updates the state **in place** (parameters, moments and
masters are overwritten tensor by tensor) and returns it.  Each
parameter's ``.grad`` holds the step's (unclipped, accumulated) gradient
until the next step.  Metrics are 0-d tensors on the device: reading one
waits for the step to finish.

Under a data-parallel ``DeviceMesh`` (``make_train_step(..., mesh=)``)
the step is the paper's §V-4 ladder (``core/policy.ladder``): DP and DDP
(``zero_stage=0``; one program, as in the reference, where only
``ladder()`` tells them apart), mixed precision (``compute_dtype``), ZeRO-1
(moments and fp32 masters sharded, each rank updates its pieces, the
parameters are all-gathered) and ZeRO-3 (parameters sharded too, gathered
per block and again for the remat recompute, gradients reduce-scattered:
``train/sharding.py``), and the int8 error-feedback exchange over the pod
axis with ``grad_compression="int8_ef"``.  Each rank takes its rows of the
global batch; the loss is the reference's mean over the global batch (each
rank's loss weighted by its share of the counted tokens).  The kernels see
plain local tensors.  A mesh with a tp axis (``model``; size 1 too) makes
the step tensor- and expert-parallel: the model's blocks split their work
over the axis (``models/transformer.ParallelCtx``), the loss is
vocabulary-parallel, and MoE takes ``_moe_ep`` (the reference's
``moe_impl="ep"`` rule, ``moe_impl``).  On a mesh without the tp axis MoE
takes the sorted path in the global batch's order (``RunCtx.moe_dp``:
capacity and sort order over every rank's rows, as the reference's GSPMD
step computes them).  BERT and the Table II CNNs under a mesh raise: the
reference has no mesh step for them (ROADMAP, not ported by decision).
Without a mesh ``zero_stage`` has no effect, as in the reference's
un-sharded jit.
``rglru`` blocks train through ``RGLRUFn`` (the forward kernel and the
hand-written RG-LRU backward), ``ssm`` blocks through ``SSDFn`` (the SSD
forward kernel and the hand-written SSD backward) and ``attn_local`` blocks
through the windowed attention kernels, as ``attn`` blocks do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig, PolicyConfig, ShapeConfig
from repro_torch.configs.paper_bench import VisionConfig
from repro_torch.models import bert, lm, vision
from repro_torch.models.lm import LM
from repro_torch.models.transformer import ParallelCtx, RunCtx
from repro_torch.optim import adamw, schedule
from repro_torch.train import sharding

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

_NO_MESH = ("{what} under a mesh is not ported: {why} (ROADMAP queue A item "
            "7 names what comes next)")


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def make_run_ctx(cfg: ModelConfig, policy: PolicyConfig, mesh=None, *,
                 seq_len: Optional[int] = None, decode: bool = False,
                 batch: Optional[int] = None, traffic=None) -> RunCtx:
    """``seq_len`` / ``decode`` / ``batch`` key the reference's tuned-tile
    lookup for ``RunCtx.attn_blocks``, the tiles of its XLA flash path
    (``repro/train/trainer.py:64-90``).  The port has no such path, and its
    attention kernels launch the one tile of their design
    (``kernels/ops.py``), so they are accepted and unused; the knobs that
    the registry does tune resolve in ``kernels/ops.py`` when a kernel is
    called.  Under ``mesh`` the context's ``ParallelCtx`` counts its
    collectives into ``traffic`` (a ``hierarchy.Traffic``; a new one by
    default)."""
    del seq_len, decode, batch
    if policy.attn_impl not in ("kernel", "full"):
        raise ValueError(f"attn_impl {policy.attn_impl!r} not in "
                         f"('kernel', 'full')")
    pctx = ParallelCtx(mesh=mesh, dp_axes=tuple(policy.dp_axes),
                       tp_axis=policy.tp_axis,
                       fsdp_experts=policy.zero_stage >= 3, traffic=traffic)
    return RunCtx(compute_dtype=_dt(policy.compute_dtype),
                  attn_impl=policy.attn_impl, remat=policy.remat,
                  moe_impl=moe_impl(cfg, policy, mesh), pctx=pctx)


def moe_impl(cfg: ModelConfig, policy: PolicyConfig, mesh=None) -> str:
    """The reference's rule (``repro/train/trainer.py:93-100``): ``"ep"``
    for an MoE config under a mesh whose tp axis divides the experts, with
    ``policy.ep``; else ``"sorted"`` (a mesh without the tp axis too: there
    the step's MoE takes the global batch's order, ``models/moe.py``).  One
    departure: a tp axis of size 1 takes ``"ep"`` too (the reference asks
    for more than 1), so that a one-rank mesh runs the expert-parallel
    program a wider one runs.  A tp axis larger than 1 that ``"sorted"``
    would have to run raises: the port's sorted path has no
    tensor-parallel form."""
    if cfg.moe is None or mesh is None:
        return "sorted"
    names = tuple(mesh.mesh_dim_names)
    tp = policy.tp_axis
    if tp not in names:
        return "sorted"
    n_tp = int(mesh.mesh.shape[names.index(tp)])
    if policy.ep and cfg.moe.n_experts % n_tp == 0:
        return "ep"
    raise NotImplementedError(_NO_MESH.format(
        what=f"MoE with {cfg.moe.n_experts} experts over {tp} = {n_tp} "
             f"without expert parallelism",
        why="only the expert-parallel path is tensor-parallel"))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
class TrainState:
    """The model (its parameters), the optimizer state and the int8
    error-feedback residuals (parameter name -> fp32 tensor, or None).
    Under a mesh, ``layout`` (``train/sharding.Layout``) says which piece
    of each leaf this rank holds."""

    def __init__(self, model: LM, opt: adamw.AdamWState, ef_residual=None,
                 layout: Optional[sharding.Layout] = None):
        self.model = model
        self.opt = opt
        self.ef_residual = ef_residual
        self.layout = layout

    @classmethod
    def create(cls, model: LM, policy: PolicyConfig,
               optcfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
               n_pods: Optional[int] = None, mesh=None) -> "TrainState":
        """Fresh optimizer state for ``model`` (fp32 masters when the
        parameters are bf16, as ``init_state`` decides in the reference).

        ``grad_compression="int8_ef"`` with ``n_pods > 1`` adds zero
        residuals as the reference does, one per pod: without a mesh
        stacked ``(n_pods,) + shape``; under ``mesh`` (whose ``pod`` axis
        gives ``n_pods``) each rank holds its own pod's, as the piece of its
        optimizer spec.  Under ``mesh`` the whole ``model`` is cut to this
        rank's pieces first (``train/sharding.Layout``)."""
        layout = None
        params = dict(model.named_parameters())
        if mesh is not None:
            layout = sharding.Layout(model.cfg, policy, mesh)
            pods = layout.axes.get("pod", 1)
            if n_pods is not None and n_pods != pods:
                raise ValueError(f"n_pods={n_pods} on a mesh of {pods} pods")
            n_pods = pods
            layout.lay_out(model)
            params = layout.opt_params(model)
        state = cls(model, adamw.init(
            params, optcfg, master_weights=(policy.param_dtype == "bfloat16")),
            layout=layout)
        if policy.grad_compression == "int8_ef" and (n_pods or 1) > 1:
            stack = () if mesh is not None else (n_pods,)
            state.ef_residual = {
                n: torch.zeros(stack + tuple(p.shape), dtype=torch.float32,
                               device=p.device) for n, p in params.items()}
        return state

    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.model.device


def init_state(cfg: ModelConfig, policy: PolicyConfig,
               optcfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
               seed: int = 0, device="cuda", n_pods: Optional[int] = None,
               mesh=None) -> TrainState:
    """Random weights from ``seed`` on ``device`` (the GPU unless the caller
    names the CPU) in ``policy.param_dtype``, and fresh AdamW state
    (``TrainState.create``: the int8 residuals, and under ``mesh`` this
    rank's pieces of a model every rank draws whole from ``seed``)."""
    model = LM.init(cfg, seed=seed, dtype=_dt(policy.param_dtype),
                    device=device)
    return TrainState.create(model, policy, optcfg, n_pods=n_pods, mesh=mesh)


def state_specs(state: TrainState, cfg: ModelConfig, policy: PolicyConfig,
                mesh_axes: Mapping[str, int]) -> Dict[str, Any]:
    """The specs a ``TrainState`` takes on a mesh of ``mesh_axes``
    (``sharding.specs``: the reference's, but for a mesh whose fsdp axes
    all have size 1), keyed as ``train/checkpoint`` keys its leaves
    (``sharding.leaf_specs``)."""
    return sharding.leaf_specs(
        *sharding.specs(LM(cfg, device="meta"), cfg, policy, mesh_axes),
        state)


# ---------------------------------------------------------------------------
# loss / grads
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, policy: PolicyConfig, mesh=None,
                 seq_len: Optional[int] = None, *, pctx=None,
                 moe_dp=()) -> Callable:
    """``loss_fn(model, batch) -> (loss, metrics)``.  A padded vocabulary of
    32768 or more takes the chunked cross entropy with the largest chunk in
    (512, 256, 128, 64, 1) that divides the sequence, as the reference.
    ``pctx``: the ``ParallelCtx`` to run under (a mesh step's layout's);
    ``moe_dp``: the dp axes that split the batch's rows
    (``RunCtx.moe_dp``)."""
    ctx = make_run_ctx(cfg, policy, mesh, seq_len=seq_len)
    if pctx is not None:
        ctx = dataclasses.replace(ctx, pctx=pctx, moe_dp=tuple(moe_dp))
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
    numpy arrays or tensors; they are moved to the state's device.  Under
    ``mesh`` (a ``DeviceMesh``; the state from ``init_state(...,
    mesh=mesh)``) every rank calls it with the same global batch."""
    seq_len = shape.seq_len if shape is not None else None
    if mesh is not None:
        layout = sharding.Layout(cfg, policy, mesh)
        loss_fn = make_loss_fn(cfg, policy, mesh, seq_len=seq_len,
                               pctx=layout.pctx, moe_dp=layout.dp)
        return _mesh_train_step(layout, loss_fn, optcfg, schedcfg,
                                policy.grad_accum)
    loss_fn = make_loss_fn(cfg, policy, mesh, seq_len=seq_len)
    return make_step(loss_fn, optcfg, schedcfg, n_accum=policy.grad_accum)


def _mesh_train_step(layout: sharding.Layout, loss_fn: Callable,
                     optcfg: adamw.AdamWConfig,
                     schedcfg: Optional[schedule.ScheduleConfig],
                     n_accum: int) -> Callable:
    """The step on ``layout``'s mesh (module docstring).  ``train_step.
    traffic`` counts its collectives (``hierarchy.Traffic``)."""
    from repro_torch.core import hierarchy
    ndim = {n: len(s) for n, s in layout.shapes.items()}
    loss_group = layout.group(layout.dp) if layout.dp else None
    pods = layout.group(("pod",)) if layout.exchange else None
    # the agreed int8 scale of a reference leaf (a scanned segment's layers
    # together): over every rank that holds a piece of it, in every pod
    scale_group = layout.group(layout.axes) if layout.exchange else None
    # the sorted MoE's global order needs every rank's own rows
    global_moe = layout.cfg.moe is not None and layout.tp is None
    split_all = tuple(a for a in layout.dp if layout.axes[a] > 1)

    def train_step(state: TrainState, batch: Mapping[str, Any]):
        if not layout.same(state.layout):
            raise ValueError("the state is not laid out on this step's mesh "
                             "and specs: make it with init_state(..., "
                             "mesh=mesh)")
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        B = next(iter(batch.values())).shape[0]
        b = B // n_accum
        if global_moe and layout.rows_axes(b) != split_all:
            raise NotImplementedError(
                f"MoE on a mesh without the {layout.policy.tp_axis!r} axis "
                f"takes the global batch's order over {split_all}: a "
                f"(micro)batch of {b} rows does not split over them")
        acc: Dict[str, torch.Tensor] = {}
        loss_sum = None
        for i in range(n_accum):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()} \
                if n_accum > 1 else batch
            local = _device_batch(layout.batch_piece(mb), state.device)
            # the reference's loss is a mean over the global (micro)batch:
            # weigh this rank's mean by its share of the counted tokens
            mask = local.get("mask")
            count = (mask.float().sum() if mask is not None else torch.tensor(
                float(local["labels"].numel()), device=state.device))
            mine = torch.clamp(count, min=1.0)
            if loss_group is not None:
                count = hierarchy.all_reduce(count.clone(), loss_group)
            w = mine / torch.clamp(count, min=1.0)
            with layout.unsharded(model):
                loss, metrics = loss_fn(model, local)
                (loss * (w / n_accum)).backward()
            for n, p in params.items():
                if p.dtype != torch.float32 and n_accum > 1 and \
                        p.grad is not None:
                    g = p.grad.float()
                    acc[n] = g if n not in acc else acc[n].add_(g)
                    p.grad = None
            # this rank's shares of the loss and of the last microbatch's
            # metrics
            last = torch.stack([loss.detach(), metrics["xent"].detach(),
                                metrics["aux"].detach()]) * w
            loss_sum = last[0] if loss_sum is None else loss_sum + last[0]
        sums = torch.stack([loss_sum / n_accum, last[1], last[2]])
        if loss_group is not None:
            hierarchy.all_reduce(sums, loss_group)
        grads = {n: acc[n] if n in acc else p.grad if p.grad is not None
                 else torch.zeros_like(p) for n, p in params.items()}
        grads = layout.reduce_grads(grads)
        if pods is not None:
            hierarchy.all_reduce(sums, pods).div_(pods.size)
            grads, state.ef_residual = hierarchy.allreduce_int8_ef(
                grads, state.ef_residual, pods, scale_group=scale_group,
                scale_keys=layout.ref_paths)
        lr = None
        if schedcfg is not None:
            lr = schedule.lr_at(state.opt.step, schedcfg)
        _, _, om = adamw.apply(layout.opt_params(model), grads, state.opt,
                               optcfg, lr=lr, norm=layout.global_norm(grads),
                               ndim=ndim)
        layout.gather_params(model)
        loss, xent, aux = sums.unbind(0)
        return state, dict(xent=xent, aux=aux, **om, loss=loss)

    train_step.traffic = layout.traffic
    return train_step


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


def paper_loss_fn(cfg, policy: PolicyConfig, mesh=None) -> Callable:
    """``loss_fn(model, batch)`` of a Table II workload: ``bert.qa_loss``
    under ``policy``'s run context for BERT (a ``ModelConfig``), or
    ``vision.vision_loss`` for a ``VisionConfig`` (fp32, as the
    reference; the policy's dtypes do not apply).  A ``mesh`` raises: the
    reference's batch norm takes its statistics over the global batch,
    which a rank's batch norm would not, and BERT's QA step is not wired
    to the mesh step."""
    if mesh is not None:
        what = "A vision model" if isinstance(cfg, VisionConfig) else "BERT"
        why = ("its batch norm's statistics are the global batch's in the "
               "reference" if isinstance(cfg, VisionConfig) else
               "its QA loss has no mesh step")
        raise NotImplementedError(_NO_MESH.format(what=what, why=why))
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
