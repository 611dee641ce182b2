"""Analytic cost model, held against ``repro/core/costmodel.py``.

The reference reads its counts off compiled XLA artifacts and an analytic
model; the port keeps the analytic model and the pricing:

  * analytic model FLOPs  -> 6·N·D-style "useful" compute, plus exact
                             per-block forward FLOPs for every model family
                             (``forward_flops``, ``step_flops``)
  * ``analytic_hbm_bytes`` -> the reference's fused-traffic model of the
                             HBM bytes one step must move (written for XLA's
                             fusion on a TPU; the card measures how far the
                             port's traffic is from it)

From these, three roofline terms per (arch x shape x mesh):

    compute    = FLOPs / (chips x peak)
    memory     = bytes / (chips x HBM bw)
    collective = wire-bytes(axis) / link-bw(axis)   summed over axes

and -- the paper's experiment -- the same program re-priced on a different
composed fabric by swapping the FabricSpec under the collective term
(localGPUs vs hybridGPUs vs falconGPUs, Table III/Fig 11).

Not here: the readers of XLA artifacts (``parse_hlo_collectives`` and
``extract``, which fill a ``CostReport`` from a compiled executable) wait
for the port's dry run, ROADMAP queue A item 7.  A ``CostReport`` is built
directly, its ``collectives`` given as ``CollectiveOp`` records.
``CalibratedCost.from_registry`` reads the speedups that the autotuner
measured on the card (``kernels.registry.kernel_speedups``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, RGLRU, SSM,
                                      ModelConfig, PolicyConfig, ShapeConfig)
from repro_torch.core.compose import ComposedSystem
from repro_torch.core.topology import ChipSpec, FabricSpec

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ring-collective wire factor: bytes crossing one device's link / payload
_RING_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    payload_bytes: float          # per-device shape bytes of the op
    group_size: int
    axes: Tuple[str, ...]         # mesh axes the group spans
    trip_count: int = 1           # multiplier from enclosing while loops
    computation: str = "main"

    @property
    def wire_bytes(self) -> float:
        """Bytes crossing one device's link, x trip count (ring cost)."""
        return (_RING_FACTOR[self.kind](max(self.group_size, 2))
                * self.payload_bytes * self.trip_count)


# ---------------------------------------------------------------------------
# analytic FLOPs (exact per family; MACs x 2)
# ---------------------------------------------------------------------------
def _attn_flops(cfg: ModelConfig, B: int, S: int, *, window: int,
                kind: str, cache_len: int = 0) -> float:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = B * S
    proj = 2 * T * d * (H + 2 * K) * hd + 2 * T * H * hd * d
    if kind == "decode":
        ctx = min(cache_len, window) if window else cache_len
        score = 2 * 2 * B * ctx * H * hd
    elif window and S > window + 512:
        # sliding-span flash executes window + q_block keys per query
        score = 2 * 2 * B * S * (window + 512) * H * hd
    else:
        eff = min(S, window) if window else S
        score = 2 * 2 * B * S * eff * H * hd / (2 if cfg.causal else 1)
    return proj + score


def _ffn_flops(cfg: ModelConfig, T: int) -> float:
    if cfg.moe is not None:
        m = cfg.moe
        mult = 6 if cfg.act in ("swiglu", "geglu") else 4
        expert = T * m.top_k * m.capacity_factor * mult * cfg.d_model * m.d_ff_expert
        router = 2 * T * cfg.d_model * m.n_experts
        shared = mult * T * cfg.d_model * m.n_shared_experts * m.d_ff_shared
        return expert + router + shared
    if cfg.d_ff == 0:
        return 0.0
    mult = 6 if cfg.act in ("swiglu", "geglu") else 4
    return mult * T * cfg.d_model * cfg.d_ff


def _ssm_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    N, G, P_ = s.d_state, s.n_groups, s.head_dim
    Z = 2 * d_in + 2 * G * N + H
    T = B * S
    proj = 2 * T * d * Z + 2 * T * d_in * d
    if kind == "decode":
        core = 2 * 2 * B * H * N * P_
    else:
        c = s.chunk
        core = (2 * B * S * c * G * N          # C·Bᵀ within chunk
                + 2 * B * S * c * H * P_       # W·x
                + 2 * 2 * B * S * H * N * P_)  # inter-chunk read + update
    return proj + core


def _rglru_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    T = B * S
    proj = 2 * T * d * w * 2 + 2 * T * w * d
    gates = 2 * 2 * T * w * (w // 8)
    scan = 10 * T * w
    return proj + gates + scan


def forward_flops(cfg: ModelConfig, shape: ShapeConfig, *,
                  with_logits: bool = True) -> float:
    """Exact forward FLOPs of one step of ``shape`` (per whole batch)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    cache_len = shape.seq_len if shape.kind == "decode" else 0
    T = B * S
    total = 0.0
    for blk in cfg.pattern:
        if blk == ATTN:
            total += _attn_flops(cfg, B, S, window=0, kind=shape.kind,
                                 cache_len=cache_len)
        elif blk == ATTN_LOCAL:
            total += _attn_flops(cfg, B, S, window=cfg.local_window,
                                 kind=shape.kind, cache_len=cache_len)
        elif blk == SSM:
            total += _ssm_flops(cfg, B, S, shape.kind)
        elif blk == RGLRU:
            total += _rglru_flops(cfg, B, S, shape.kind)
        total += _ffn_flops(cfg, T)
    if with_logits:
        total += 2 * T * cfg.d_model * cfg.padded_vocab
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6·N·D-style 'useful' figure required by the assignment:
    6 x active-params x tokens for training; 2 x for inference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    toks = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return 2.0 * n * toks


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig,
                       policy: PolicyConfig,
                       mesh_axes: Mapping[str, int]) -> float:
    """Per-device HBM bytes for one step: the reference's fused-traffic
    model (written for XLA's fusion on a TPU: elementwise chains fused,
    flash tiles kept on chip), a coarse documented model of the traffic
    that *must* cross HBM:

      weights    : own shard, read per materialization (fwd, bwd, +remat),
                   x2 for the bf16 cast write (weights-stationary SPMD:
                   activations, not weights, ride the collectives)
      optimizer  : read+write p/m/v fp32 on the shard (ZeRO placement)
      activations: C_ACT passes over the (B_loc, S, d) residual stream per
                   layer (fwd writes + bwd reads + remat recompute)
      attention  : K/V read/write per pass (flash keeps scores in VMEM)
      logits     : chunked xent round-trips fp32 chunk logits once fwd +
                   once bwd on the (T_loc, V_loc) shard
      caches     : decode reads + writes the local cache slice once
    """
    n = max(1, int(np.prod(list(mesh_axes.values()))))
    tp = mesh_axes.get(policy.tp_axis or "", 1)
    dp_total = 1
    for a in policy.dp_axes:
        dp_total *= mesh_axes.get(a, 1)
    B = shape.global_batch
    # batch shards over dp only while it divides (mirrors batch_specs)
    B_loc = max(1, B // dp_total) if B % dp_total == 0 else \
        (max(1, B // mesh_axes.get("data", 1))
         if B % mesh_axes.get("data", 1) == 0 else B)
    S = 1 if shape.kind == "decode" else shape.seq_len
    T_loc = B_loc * S
    d = cfg.d_model
    L = cfg.n_layers
    V_loc = cfg.padded_vocab / tp
    N = cfg.param_count()
    N_shard = N / (n if policy.zero_stage >= 3 else tp)

    C_ACT = 16 if shape.kind == "train" else 6
    mats = {"none": 2, "block": 3, "full": 3}[policy.remat] \
        if shape.kind == "train" else 1

    w_bytes = mats * 2 * 2 * N_shard            # bf16 read + cast write
    opt_bytes = 6 * 4 * N_shard if shape.kind == "train" else 0.0
    act_bytes = C_ACT * 2 * T_loc * d * L
    # attention K/V traffic (flash: no S^2 HBM term)
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    n_attn = sum(1 for b in cfg.pattern if b in (ATTN, ATTN_LOCAL))
    attn_bytes = (3 if shape.kind == "train" else 1) * 2 * T_loc * kv * n_attn
    logits_bytes = (4 if shape.kind == "train" else 2) * 4 * T_loc * V_loc \
        if (shape.kind != "decode") else 2 * 4 * B_loc * V_loc
    cache_bytes = 0.0
    if shape.kind == "decode":
        W = shape.seq_len
        per_layer = {
            ATTN: W * kv, ATTN_LOCAL: min(W, cfg.local_window) * kv,
            SSM: 0.0, RGLRU: 0.0}
        cache_loc = sum(per_layer[b] for b in cfg.pattern) * B_loc * 2 / tp
        cache_bytes = 2 * cache_loc                     # read + write
    return (w_bytes + opt_bytes + act_bytes + attn_bytes + logits_bytes
            + cache_bytes)


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               policy: PolicyConfig) -> float:
    """Analytic FLOPs the hardware must actually execute for one step
    (fwd + bwd + remat recompute for training; fwd for inference)."""
    fwd = forward_flops(cfg, shape)
    if shape.kind != "train":
        return fwd
    mult = 3.0
    if policy.remat == "block":
        mult += 1.0          # one recomputed forward for the block interior
    elif policy.remat == "full":
        mult += 1.0
    return mult * fwd


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostReport:
    """Everything extracted from one compiled (arch x shape x mesh) cell."""
    arch: str
    shape: str
    mesh: Dict[str, int]
    flops_hlo: float                 # per-device, a compiled artifact's
    flops_analytic: float            # whole-step, analytic (exact)
    model_flops: float               # 6·N·D useful figure
    hbm_bytes: float                 # per-device bytes accessed (artifact)
    peak_memory: Optional[float]     # per-device bytes (artifact)
    hbm_bytes_analytic: float = 0.0  # per-device, fused-traffic model
    collectives: List[CollectiveOp] = dataclasses.field(default_factory=list)

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.mesh.values())))

    def per_axis_wire_bytes(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for op in self.collectives:
            if not op.axes:
                continue
            # attribute to the single axis the group spans; multi-axis groups
            # are attributed to every spanned axis proportionally to (n-1)
            if len(op.axes) == 1:
                out[op.axes[0]] = out.get(op.axes[0], 0.0) + op.wire_bytes
            else:
                for a in op.axes:
                    out[a] = out.get(a, 0.0) + op.wire_bytes / len(op.axes)
        return out

    def collective_bytes_total(self) -> float:
        return sum(op.wire_bytes for op in self.collectives)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float                  # analytic (fused traffic) when given
    memory_hlo_s: float              # from the artifact's byte count
    collective_s: float
    per_axis_s: Dict[str, float]
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float              # model_flops / executed flops
    step_time_s: float               # max of the three terms (overlap bound)
    roofline_fraction: float         # compute_s / step_time_s

    def summary(self) -> str:
        return (f"compute={self.compute_s*1e3:.2f}ms "
                f"memory={self.memory_s*1e3:.2f}ms "
                f"collective={self.collective_s*1e3:.2f}ms "
                f"dominant={self.dominant} "
                f"frac={self.roofline_fraction:.3f} "
                f"useful={self.useful_ratio:.3f}")


def roofline(report: CostReport, system: ComposedSystem,
             chip: Optional[ChipSpec] = None) -> Roofline:
    """The three roofline terms for one compiled cell on one fabric."""
    chip = chip or system.chip
    n = report.n_devices
    flops_exec = max(report.flops_analytic,
                     report.flops_hlo * n)   # HLO figure is per device
    compute_s = flops_exec / (n * chip.peak_flops_bf16)
    memory_hlo_s = report.hbm_bytes / chip.hbm_bw   # per-device, no fusion
    memory_s = (report.hbm_bytes_analytic / chip.hbm_bw
                if report.hbm_bytes_analytic > 0 else memory_hlo_s)
    per_axis: Dict[str, float] = {}
    for axis, wire in report.per_axis_wire_bytes().items():
        if axis in system.fabric.axis_links:
            # hop-aware path price (== wire / bandwidth on 1-hop axes)
            per_axis[axis] = system.fabric.axis_time(axis, wire)
        else:
            link, hops = system.fabric.slowest_path()
            per_axis[axis] = (wire / link.bandwidth
                              + (hops - 1) * link.latency)
    collective_s = sum(per_axis.values())
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    step = max(compute_s, memory_s, collective_s)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, memory_hlo_s=memory_hlo_s,
        collective_s=collective_s,
        per_axis_s=per_axis, dominant=dominant,
        model_flops=report.model_flops, hlo_flops=flops_exec,
        useful_ratio=report.model_flops / max(flops_exec, 1.0),
        step_time_s=step,
        roofline_fraction=(report.model_flops / (n * chip.peak_flops_bf16))
        / max(step, 1e-30))


# ---------------------------------------------------------------------------
# measured-cost calibration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CalibratedCost:
    """Measured-cost layer over the analytic model.

    The analytic terms price every composition from first principles; this
    layer folds *measurements* back in, in priority order:

      1. ``cell_step_s`` — an exact measured step time for one
         (arch, shape, mesh) cell (dry-run artifact, bench run, or the
         cluster's own telemetry).  Replaces the whole step estimate.
      2. ``kernel_speedup`` — measured default/best ratios from the
         tuned-config registry (``kernels.autotune``).  Scales the
         analytic *compute* term of every workload whose block pattern
         uses that kernel family: tuned kernels execute the same FLOPs in
         measurably less time, and the scheduler/simulator should price
         that in.

    Construct explicitly, or via ``from_registry()`` to pull the speedups
    out of a tuned-config registry.
    """
    cell_step_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_speedup: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @staticmethod
    def cell_key(arch: str, shape_name: str, mesh_label: str) -> str:
        return f"{arch}|{shape_name}|{mesh_label}"

    @classmethod
    def from_registry(cls, registry=None) -> "CalibratedCost":
        """Speedups measured by the autotuner (``registry``, else the
        active one; empty when untuned)."""
        from repro_torch.kernels import registry as kreg
        return cls(kernel_speedup=kreg.kernel_speedups(registry))

    def __bool__(self) -> bool:
        return bool(self.cell_step_s or self.kernel_speedup)

    # ----------------------------------------------------------- queries --
    def step_override(self, arch: str, shape_name: str,
                      mesh_label: str) -> Optional[float]:
        return self.cell_step_s.get(
            self.cell_key(arch, shape_name, mesh_label))

    def _block_speedup(self, kernel: str, kind: str) -> float:
        s = self.kernel_speedup.get(kernel, 1.0)
        if kind == "train" and kernel == "flash_attention":
            # the training path runs fwd + bwd kernels; average the
            # measured ratios when both were tuned
            s = (s + self.kernel_speedup.get("flash_attention_bwd", s)) / 2
        return max(s, 1e-9)

    def compute_scale(self, cfg: ModelConfig, shape: ShapeConfig) -> float:
        """Multiplier on the analytic compute term, FLOPs-weighted: a
        tuned kernel only accelerates the *core* FLOPs it executes
        (attention scores, SSD recurrence, RG-LRU scan) — projections,
        FFN, and logits are untouched XLA matmuls and keep weight 1.0.
        Returns scaled_flops / total_flops over the whole forward."""
        if not self.kernel_speedup:
            return 1.0
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        kind = shape.kind
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        total = scaled = 0.0
        for blk in cfg.pattern:
            core, s = 0.0, 1.0
            if blk in (ATTN, ATTN_LOCAL):
                w = cfg.local_window if blk == ATTN_LOCAL else 0
                cache = shape.seq_len if kind == "decode" else 0
                full = _attn_flops(cfg, B, S, window=w, kind=kind,
                                   cache_len=cache)
                proj = 2 * B * S * d * (H + 2 * K) * hd \
                    + 2 * B * S * H * hd * d
                core = max(0.0, full - proj)
                s = self._block_speedup("flash_attention", kind)
            elif blk == SSM:
                full = _ssm_flops(cfg, B, S, kind)
                sc = cfg.ssm
                d_in = sc.expand * d
                z = 2 * d_in + 2 * sc.n_groups * sc.d_state \
                    + d_in // sc.head_dim
                proj = 2 * B * S * d * z + 2 * B * S * d_in * d
                core = max(0.0, full - proj)
                s = self._block_speedup("ssd", kind)
            elif blk == RGLRU:
                full = _rglru_flops(cfg, B, S, kind)
                r = cfg.rglru
                core = min(full, 10.0 * B * S * (r.lru_width or d))
                s = self._block_speedup("rglru", kind)
            else:
                full = 0.0
            blk_total = full + _ffn_flops(cfg, B * S)
            total += blk_total
            scaled += blk_total - core + core / s
        logits = 2.0 * B * S * d * cfg.padded_vocab    # unscaled
        total += logits
        scaled += logits
        return scaled / total if total > 0 else 1.0

    def measure_cell(self, arch: str, shape_name: str, mesh_label: str,
                     step_s: float) -> None:
        """Record a measured step time (the feedback edge of the loop)."""
        self.cell_step_s[self.cell_key(arch, shape_name, mesh_label)] = \
            float(step_s)

    # -------------------------------------------------------- persistence --
    def to_json(self) -> Dict[str, Any]:
        return {"cell_step_s": dict(self.cell_step_s),
                "kernel_speedup": dict(self.kernel_speedup)}

    @classmethod
    def from_json(cls, js: Mapping[str, Any]) -> "CalibratedCost":
        return cls(cell_step_s=dict(js.get("cell_step_s", {})),
                   kernel_speedup=dict(js.get("kernel_speedup", {})))


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    """KV-cache bytes appended per token across every attention layer —
    the unit of serving KV traffic (page writes locally, cache-slice
    ownership transfers on the wire in the flash-decode layout)."""
    per_layer = 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    n_attn = sum(1 for b in cfg.pattern if b in (ATTN, ATTN_LOCAL))
    return float(per_layer * n_attn)


def serving_throughput(cfg: ModelConfig, shape: ShapeConfig,
                       step_s: float) -> Dict[str, float]:
    """Token throughput and KV traffic of one decode replica stepping at
    ``step_s`` (pass a ``CalibratedCost``-priced step time to price from
    measurements).  ``tokens_per_s`` is the replica's saturated decode
    rate — ``global_batch`` sequences advance one token per step."""
    step_s = max(step_s, 1e-30)
    toks = shape.global_batch / step_s
    kv_tok = kv_bytes_per_token(cfg)
    return {
        "tokens_per_s": toks,
        "tpot_s": step_s,
        "kv_write_bytes_per_s": toks * kv_tok,
        # each decode step re-reads every sequence's history from HBM
        "kv_read_bytes_per_s": toks * kv_tok * shape.seq_len,
    }


def predict_step_time(report: CostReport, system: ComposedSystem,
                      overlap: float = 1.0) -> float:
    """Step-time prediction on a given composed fabric.

    ``overlap=1`` -> perfect compute/comm overlap (max of terms);
    ``overlap=0`` -> fully serial (sum).  The paper's DDP baseline achieves
    partial overlap; we report both bounds in the benchmarks.
    """
    r = roofline(report, system)
    serial = r.compute_s + r.memory_s + r.collective_s
    overlapped = max(r.compute_s, r.memory_s, r.collective_s)
    return overlap * overlapped + (1 - overlap) * serial


def price_on_fabrics(report: CostReport,
                     systems: Mapping[str, ComposedSystem],
                     overlap: float = 0.5) -> Dict[str, float]:
    """The paper's Fig-11 experiment: one program, many fabrics."""
    return {name: predict_step_time(report, sys_, overlap)
            for name, sys_ in systems.items()}
