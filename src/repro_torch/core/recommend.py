"""Topology recommendation (the paper's stated future work), held against
``repro/core/recommend.py``.

    "...build a system framework that can take the input of various
     configured runs, and recommend the optimal system level topology
     for AI and HPC workloads."  (paper §VI)

The analytic mode: a closed-form wire model ranks candidate (dp, tp)
factorizations of the chip budget.  The model is deliberately coarse
(documented term by term below) but reproduces the reference's measured
ordering on every cell it profiled: it exists to pre-screen compositions
so only the top few need a run.  The reference's measured mode
(``recommend_from_measurements``, ranking dry-run artifacts) comes with
the port's dry run (ROADMAP item 7).  Its process-wide calibration hook
(``set_calibration`` / ``get_calibration``) is not ported: a calibration
is passed to ``recommend``, as to the cluster ``Scheduler``, so no
ranking has a hidden input.

The wire model reads the link table by name (``ICI_BW`` and
``DEFAULT_LINKS``); the chip and the cross-pod bandwidth default to
``ChipSpec()`` and the table's DCN row when the call is made.

Hard feasibility constraints (each learned from a measured regression):
  * ``batch % dp == 0``        — otherwise GSPMD replicates the batch
                                 (command-r prefill at (64,4): 9 s -> 87 s);
  * per-device memory estimate — params+opt shards, activations, caches
    must fit HBM;
  * MoE: ``n_experts % tp == 0`` for the EP layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, PolicyConfig,
                                      ShapeConfig, SHAPES)
from repro_torch.core import costmodel
from repro_torch.core.costmodel import CalibratedCost
from repro_torch.core.topology import (DEFAULT_LINKS, ChipSpec, ICI_BW,
                                       LinkClass, Topology)


@dataclasses.dataclass
class Candidate:
    shape: Tuple[int, ...]            # (dp, tp) or (pod, dp, tp)
    step_s: float                     # predicted step time
    terms: Dict[str, float]
    feasible: bool
    why: str = ""
    # bytes crossing one device's link per step, per mesh axis — the input
    # to cluster-level per-link traffic accounting
    wire_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return "x".join(str(x) for x in self.shape)


# ---------------------------------------------------------------------------
# analytic wire model (coarse, per-device seconds)
# ---------------------------------------------------------------------------
def _estimate(cfg: ModelConfig, shape: ShapeConfig, dp: int, tp: int,
              pods: int = 1, chip: Optional[ChipSpec] = None,
              dcn_bw: Optional[float] = None,
              topology: Optional[Topology] = None,
              domain_chips: int = 0) -> Candidate:
    chip = ChipSpec() if chip is None else chip
    if dcn_bw is None:
        dcn_bw = DEFAULT_LINKS[LinkClass.DCN].bandwidth
    n = pods * dp * tp
    B = shape.global_batch
    mesh_shape = (pods, dp, tp) if pods > 1 else (dp, tp)
    dp_total = pods * dp

    # -------- feasibility --------
    if B % dp_total:
        return Candidate(mesh_shape, float("inf"), {}, False,
                         f"batch {B} % dp {dp_total} != 0")
    if cfg.moe is not None and tp > 1 and cfg.moe.n_experts % tp:
        return Candidate(mesh_shape, float("inf"), {}, False,
                         f"experts {cfg.moe.n_experts} % tp {tp} != 0")

    P = cfg.param_count()
    serve = shape.kind != "train"
    pbytes = 2 if serve else 4
    # params per device: serve = TP-only; train = ZeRO-3 over dp x tp
    p_dev = P * pbytes / (tp if serve else n)
    opt_dev = 0 if serve else 2 * P * 4 / n
    S = 1 if shape.kind == "decode" else shape.seq_len
    T_loc = (B // dp_total) * S
    act_dev = 4 * T_loc * cfg.d_model * 2 * (2 if shape.kind == "train"
                                             else 1)
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    n_attn = sum(1 for b in cfg.pattern if b == "attn")
    cache_dev = (shape.seq_len * kv * n_attn * (B // dp_total) * 2 / tp
                 if shape.kind == "decode" else 0)
    mem = p_dev + opt_dev + act_dev + cache_dev
    if mem > chip.hbm_bytes * 0.95:
        return Candidate(mesh_shape, float("inf"), {}, False,
                         f"memory {mem/2**30:.1f} GiB > HBM")

    # -------- terms --------
    flops = costmodel.step_flops(cfg, shape, PolicyConfig())
    compute = flops / (n * chip.peak_flops_bf16)
    memory = costmodel.analytic_hbm_bytes(
        cfg, shape, PolicyConfig(
            dp_axes=("pod", "data") if pods > 1 else ("data",)),
        dict(zip(("pod", "data", "model") if pods > 1 else
                 ("data", "model"), mesh_shape))) / chip.hbm_bw

    passes = 3 if shape.kind == "train" else 1
    wire_dp = wire_tp = pod_wire = 0.0
    if shape.kind == "train":
        # ZeRO-3 param gathers (bf16 on the wire) + grad reduce
        wire_dp += passes * (n - 1) / n * P * 2
        wire_dp += 2 * (dp - 1) / dp * P * 2
    # row-parallel / EP activation reductions over tp per layer
    if tp > 1:
        n_red = 2 * cfg.n_layers * (3 if shape.kind == "train" else 1)
        wire_tp += n_red * 2 * (tp - 1) / tp * T_loc * cfg.d_model * 2
    coll = (wire_dp + wire_tp) / ICI_BW
    if topology is not None and domain_chips > 0:
        # multi-tier admission hint: a candidate whose per-pod mesh
        # cannot fit one drawer (``domain_chips`` chips) must span the
        # composed fabric — derate its collective term by the topology's
        # cross-drawer bandwidth scale and charge the extra hop latency,
        # so admission ranks drawer-sized candidates above spanning ones
        # *before* placement.  The flat single-switch topology passes no
        # hint (scale 1, 1 hop) and prices exactly the legacy estimate.
        n_local = dp * tp
        n_dom = -(-n_local // domain_chips)       # drawers spanned
        if n_dom > 1:
            span = n_dom - 1
            flows = min(domain_chips, n_local)
            scale = topology.bw_scale(LinkClass.SWITCH, span, flows)
            hops = topology.hops(LinkClass.SWITCH, span)
            coll = ((wire_dp + wire_tp) / (ICI_BW * max(scale, 1e-9))
                    + (hops - 1) * DEFAULT_LINKS[LinkClass.SWITCH].latency)
    if pods > 1 and shape.kind == "train":
        pod_wire = 2 * (pods - 1) / pods * P * 2 / dp   # hierarchical
        coll += pod_wire / dcn_bw

    step = max(compute, memory, coll)
    wire = {"data": wire_dp, "model": wire_tp}
    if pods > 1:
        wire["pod"] = pod_wire
    return Candidate(mesh_shape, step,
                     {"compute": compute, "memory": memory,
                      "collective": coll}, True, wire_bytes=wire)


def calibrate_candidate(cand: Candidate, cfg: ModelConfig, arch: str,
                        shape_name: str, shape: ShapeConfig,
                        cal: Optional[CalibratedCost]) -> Candidate:
    """Re-price one analytic candidate from measurements (no-op without
    a calibration layer or for infeasible candidates)."""
    if cal is None or not cal or not cand.feasible:
        return cand
    measured = cal.step_override(arch, shape_name, cand.label)
    terms = dict(cand.terms)
    if measured is not None:
        terms["measured"] = measured
        return dataclasses.replace(cand, step_s=measured, terms=terms)
    scale = cal.compute_scale(cfg, shape)
    if scale == 1.0:
        return cand
    terms["compute"] = terms.get("compute", 0.0) * scale
    step = max(terms.get("compute", 0.0), terms.get("memory", 0.0),
               terms.get("collective", 0.0))
    return dataclasses.replace(cand, step_s=step, terms=terms)


def candidates(n_chips: int = 256, pods: int = 1
               ) -> List[Tuple[int, int]]:
    out = []
    tp = 1
    while tp <= n_chips:
        if n_chips % tp == 0:
            out.append((n_chips // tp, tp))
        tp *= 2
    return out


def recommend(arch: str, shape_name: str, *, n_chips: int = 256,
              pods: int = 1, top: int = 3,
              calibration: Optional[CalibratedCost] = None,
              topology: Optional[Topology] = None,
              domain_chips: int = 0) -> List[Candidate]:
    """Analytic ranking of compositions for one workload.

    When a ``calibration`` layer is supplied the analytic terms are
    re-priced from measurements before ranking — measured cells override
    the whole step, tuned-kernel speedups scale the compute term.
    ``topology`` +
    ``domain_chips`` (chips per drawer) apply the multi-tier admission
    derate to candidates that must span drawers.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cands = [calibrate_candidate(
                 _estimate(cfg, shape, dp, tp, pods,
                           topology=topology, domain_chips=domain_chips),
                 cfg, arch, shape_name, shape, calibration)
             for dp, tp in candidates(n_chips, pods)]
    cands.sort(key=lambda c: c.step_s)
    return cands[:top]
