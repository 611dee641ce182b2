"""Port vs reference: the cluster control plane end to end
(``repro_torch/cluster/{scheduler,faults,recomposer,simulator}.py`` against
``repro/cluster/...``).

The reference promises that ``report()`` is bit-identical for a
``TraceConfig``.  Under ``ref_constants`` the port's report must be
byte-identical to the reference's (``json.dumps(..., sort_keys=True)``) for
every scenario the reference's example and benchmarks build, rebuilt here
with each side's classes: the default trace, ``examples/cluster_trace.py``,
``benchmarks/recompose_bench.py``, ``benchmarks/serve_bench.py`` and
``benchmarks/chaos_bench.py``, each policy with tenant weights, a gang trace,
each fault kind, a multi-tier fabric, and a seeded sweep of fault and
recompose interleavings.  The port's scheduler reads only the calibration
it is handed; the reference's process-wide one gives the same report.  The
mirror into a tracking run is the reference's, byte for byte, with the
clocks stubbed.  At the H100's own constants the reports differ from the
reference's and repeat byte for byte.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro import tracking as ref_tracking
from repro.cluster import faults as ref_faults
from repro.cluster import recomposer as ref_recomposer
from repro.cluster import scheduler as ref_scheduler
from repro.cluster import simulator as ref_simulator
from repro.core import costmodel as ref_costmodel
from repro.core import fabrics as ref_fabrics
from repro.core import recommend as ref_recommend
from repro.core import topology as ref_topology
from repro.data import pipeline as ref_pipeline
from repro.data import storage as ref_storage

from repro_torch import tracking
from repro_torch.cluster import (faults, recomposer, scheduler, simulator)
from repro_torch.core import costmodel, fabrics, recommend, topology
from repro_torch.data import pipeline, storage

from test_torch_topology import ref_constants  # noqa: F401


def _side(sim, flt, rc, topo, fab, pipe, sto, trk):
    return types.SimpleNamespace(
        sim=sim, faults=flt, rc=rc, topology=topo, fabrics=fab,
        pipeline=pipe, storage=sto, tracking=trk)


REF = _side(ref_simulator, ref_faults, ref_recomposer, ref_topology,
            ref_fabrics, ref_pipeline, ref_storage, ref_tracking)
PORT = _side(simulator, faults, recomposer, topology, fabrics, pipeline,
             storage, tracking)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as in ``tests/test_torch_moe.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(rep) -> str:
    return json.dumps(rep, sort_keys=True, default=str)


def report(s, cfg):
    return canon(s.sim.ClusterSimulator(cfg).run())


def same_report(build):
    """``build(side)`` -> TraceConfig; the two reports, byte for byte."""
    ref, port = report(REF, build(REF)), report(PORT, build(PORT))
    assert port == ref
    return json.loads(port)


# ---------------------------------------------------------------------------
# the scenarios of the reference's example and benchmarks
# ---------------------------------------------------------------------------
def bench_cfg(s):                       # examples/cluster_trace.py too
    return s.sim.TraceConfig(n_jobs=24, arrival_rate_hz=0.2, seed=7,
                             failures=((120.0, 12),), repair_after_s=180.0)


def skew_policy_cfg(s, policy, weights=()):
    """``benchmarks/cluster_sim.py``'s skewed tenants and a 2-pod gang."""
    JT = s.sim.JobTemplate
    heavy = JT("qwen2-0.5b", "train_4k", 32, 30, tenant="heavy")
    blue = JT("qwen2-0.5b", "train_4k", 32, 6, tenant="blue")
    green = JT("qwen2-0.5b", "train_4k", 32, 6, tenant="green")
    gang = JT("qwen2-0.5b", "train_4k", 64, 10, n_pods=2, tenant="gang",
              priority=5)
    arrivals = (tuple((float(i), heavy) for i in range(16))
                + ((18.0, gang),)
                + tuple((20.0 + i, blue) for i in range(3))
                + tuple((22.0 + i, green) for i in range(3)))
    return s.sim.TraceConfig(n_jobs=0, seed=0, n_local=128, n_switch=128,
                             pods=2, failures=(), arrivals=arrivals,
                             policy=policy, tenant_weights=weights)


RC_KW = dict(interval_s=10.0, cooldown_s=20.0)


def recompose_cfgs(s):
    """``benchmarks/recompose_bench.py``: skew, chaos and migrate, each
    without and with its ``RecomposeConfig``."""
    JT, TC = s.sim.JobTemplate, s.sim.TraceConfig
    wide = JT("llama3.2-3b", "train_4k", 64, 100, elastic=True)
    small = JT("qwen2-0.5b", "train_4k", 16, 10)
    med = JT("qwen2-0.5b", "train_4k", 32, 30)
    skew = TC(n_jobs=0, n_local=64, n_switch=64, pods=2, failures=(),
              arrivals=((0.0, wide), (1.0, wide))
              + tuple((40.0 + i, small) for i in range(8))
              + ((60.0, med),))
    chaos_job = JT("llama3.2-3b", "train_4k", 64, 200, elastic=True)
    chaos = TC(n_jobs=0, n_local=128, n_switch=16, pods=2,
               failures=((30.0, 85),), repair_after_s=60.0,
               arrivals=((1.0, chaos_job),))

    def io(name, dataset_tb, batch=2048):
        return s.pipeline.IOWorkload(name, 1e6, 0.0, batch,
                                     int(dataset_tb * 1e6))
    blocker = JT("qwen2-0.5b", "train_4k", 16, 40, io=io("blocker", 1.0))
    io_elastic = JT("qwen2-0.5b", "train_4k", 16, 400, elastic=True,
                    io=io("elastic", 0.5))
    io_small = JT("qwen2-0.5b", "train_4k", 16, 150, io=io("small", 0.3))
    LOCAL = s.topology.LinkClass.LOCAL
    migrate = TC(
        n_jobs=0, n_local=64, n_switch=64, pods=2, failures=(),
        storage_tranches=(
            s.storage.StorageTranche("nvme-0", capacity_bytes=1.2e12,
                                     attach=LOCAL, domain=0),
            s.storage.StorageTranche("nvme-1", capacity_bytes=4e12,
                                     attach=LOCAL, domain=0)),
        arrivals=((0.0, blocker), (2.0, io_elastic), (3.0, io_small),
                  (4.0, io_small)))
    rc = s.rc.RecomposeConfig(**RC_KW)
    return {"skew": skew, "chaos": chaos, "migrate": migrate,
            "skew_rc": dataclasses.replace(skew, recompose=rc),
            "chaos_rc": dataclasses.replace(chaos, recompose=rc),
            "migrate_rc": dataclasses.replace(migrate, recompose=rc)}


def serve_cfgs(s):
    """``benchmarks/serve_bench.py``: the cluster scenarios under both
    arrival shapes, and the overload sweep, fixed and autoscaled."""
    TC, SC = s.sim.TraceConfig, s.sim.ServiceConfig

    def cluster_cfg(arrival):
        return TC(n_jobs=12, arrival_rate_hz=0.2, seed=7,
                  failures=((300.0, 8),), repair_after_s=180.0,
                  services=(SC(name="chat", arch="llama3.2-3b",
                               shape_name="decode_32k", n_replicas=2,
                               chips_per_replica=64, n_requests=160,
                               arrival_rate_hz=2.0, arrival=arrival,
                               prompt_len=2048, max_new=128, n_prefixes=6,
                               prefix_len=1024, prefill_chunk=512),))

    def overload_cfg(load, autoscale):
        extra = dict(autoscale=True, autoscale_interval_s=0.5,
                     max_replicas=8, scale_up_queue=1.0,
                     scale_down_queue=0.25) if autoscale else {}
        return TC(n_jobs=0, failures=(), seed=3,
                  services=(SC(name="chat", arch="llama3.2-3b",
                               shape_name="decode_32k", n_replicas=1,
                               chips_per_replica=64, n_requests=320,
                               arrival_rate_hz=20.0 * load,
                               arrival="poisson", prompt_len=2048,
                               max_new=256, n_prefixes=6, prefix_len=1024,
                               prefill_chunk=512, ttft_slo_s=2.0,
                               tpot_slo_s=0.5, **extra),))
    return {"poisson": cluster_cfg("poisson"), "burst": cluster_cfg("burst"),
            "fixed_1x": overload_cfg(1.0, False),
            "fixed_2x": overload_cfg(2.0, False),
            "autoscale_1x": overload_cfg(1.0, True),
            "autoscale_2x": overload_cfg(2.0, True)}


def chaos_cfgs(s):
    """``benchmarks/chaos_bench.py``: outage, degradation, MTBF churn, the
    empty plan, and the serving burst under a replica-killing fault with
    and without its resilience."""
    FP, FS = s.faults.FaultPlan, s.faults.FaultSpec
    base = bench_cfg(s)
    outage = dataclasses.replace(base, failures=(), faults=FP(
        faults=(FS(kind="domain_outage", t=120.0, domain=1, t_clear=150.0,
                   detect_s=2.0),), retry_backoff_s=5.0))
    degrade = dataclasses.replace(base, failures=(), faults=FP(faults=(
        FS(kind="link_degrade", t=60.0, link="switch", frac=0.5,
           t_clear=300.0),
        FS(kind="link_degrade", t=60.0, link="dcn", frac=0.5, t_clear=300.0),
        FS(kind="tranche_brownout", t=90.0, tranche="local-nvme-0",
           frac=0.25, t_clear=240.0))))
    churn = s.sim.TraceConfig(
        n_jobs=24, arrival_rate_hz=0.25, seed=7, failures=(),
        faults=FP(mtbf_s=90.0, mttr_s=60.0, horizon_s=360.0, mtbf_n=48,
                  detect_s=2.0, retry_backoff_s=5.0))
    serve_fault = FP(faults=(FS(kind="device_down", t=30.0, n=64,
                                t_clear=200.0, detect_s=10.0),))

    def serve_cfg(retries, health_s, timeout_s):
        return s.sim.TraceConfig(
            n_jobs=0, seed=11, failures=(),
            services=(s.sim.ServiceConfig(
                name="chat", arch="llama3.2-3b", shape_name="decode_32k",
                n_replicas=3, chips_per_replica=64, n_requests=160,
                arrival_rate_hz=4.0, prompt_len=2048, max_new=128,
                request_timeout_s=timeout_s, max_request_retries=retries,
                retry_backoff_s=0.5, health_check_s=health_s),),
            faults=serve_fault)
    return {"outage": outage, "degrade": degrade, "churn": churn,
            "empty_plan": dataclasses.replace(base, faults=FP()),
            "serve_resilient": serve_cfg(2, 2.0, 15.0),
            "serve_no_retry": serve_cfg(0, 0.0, 15.0),
            "serve_no_resilience": serve_cfg(0, 0.0, 0.0)}


SCENARIOS = {
    "default": lambda s: s.sim.TraceConfig(),
    "cluster_trace": bench_cfg,
    **{f"recompose_{k}": (lambda k: lambda s: recompose_cfgs(s)[k])(k)
       for k in ("skew", "chaos", "migrate", "skew_rc", "chaos_rc",
                 "migrate_rc")},
    **{f"serve_{k}": (lambda k: lambda s: serve_cfgs(s)[k])(k)
       for k in ("poisson", "burst", "fixed_1x", "fixed_2x", "autoscale_1x",
                 "autoscale_2x")},
    **{f"chaos_{k}": (lambda k: lambda s: chaos_cfgs(s)[k])(k)
       for k in ("outage", "degrade", "churn", "empty_plan",
                 "serve_resilient", "serve_no_retry",
                 "serve_no_resilience")},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_report_is_the_reference_report(ref_constants, name):
    rep = same_report(SCENARIOS[name])
    assert rep["lease_conflicts"] == 0
    assert rep["jobs"]["submitted"] > 0 or "serving" in rep


def test_cluster_trace_example_holds_its_claims(ref_constants):
    """``examples/cluster_trace.py``'s assertions, on the port."""
    rep = same_report(bench_cfg)
    assert rep["jobs"]["completed"] == rep["jobs"]["submitted"] == 24
    assert rep["recomposition"]["count"] >= 1


# ---------------------------------------------------------------------------
# policies, gangs, fault kinds, fabrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["easy", "fair_share", "priority_preempt"])
def test_each_policy_with_tenant_weights(ref_constants, policy):
    assert tuple(scheduler.POLICIES) == tuple(ref_scheduler.POLICIES)
    rep = same_report(lambda s: skew_policy_cfg(
        s, policy, weights=(("heavy", 1.0), ("blue", 3.0), ("green", 2.0))))
    assert rep["policy"] == policy
    assert set(rep["fairness"]["tenants"]) == {"heavy", "blue", "green",
                                               "gang"}


def test_gang_trace(ref_constants):
    def cfg(s):
        JT = s.sim.JobTemplate
        return s.sim.TraceConfig(
            n_jobs=8, arrival_rate_hz=0.2, seed=4, n_local=96, n_switch=32,
            pods=4, failures=((60.0, 90.0, 20),), policy="priority_preempt",
            arrivals=((5.0, JT("qwen2-0.5b", "train_4k", 32, 12, n_pods=2,
                               priority=3)),
                      (9.0, JT("qwen2-0.5b", "train_4k", 64, 8, n_pods=4,
                               priority=1)),
                      (70.0, JT("qwen2-0.5b", "train_4k", 32, 6, n_pods=2,
                                priority=2))))
    rep = same_report(cfg)
    assert rep["gangs"]["started"] >= 2


def _one_fault(kind):
    def cfg(s):
        FS = s.faults.FaultSpec
        spec = FS(kind=kind, t=40.0, n=24, domain=1, link="switch",
                  frac=0.3, tranche="local-nvme-0", t_clear=130.0,
                  flaps=2, period_s=30.0, detect_s=2.0, notice_s=5.0)
        return s.sim.TraceConfig(
            n_jobs=12, arrival_rate_hz=0.3, seed=2, failures=(),
            n_local=64, n_switch=64, pods=2,
            services=(s.sim.ServiceConfig(
                n_replicas=2, chips_per_replica=16, n_requests=60,
                arrival_rate_hz=3.0, request_timeout_s=10.0,
                health_check_s=2.0),),
            faults=s.faults.FaultPlan(faults=(spec,), retry_backoff_s=2.0))
    return cfg


@pytest.mark.parametrize("kind", faults.FAULT_KINDS)
def test_each_fault_kind(ref_constants, kind):
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS
    rep = same_report(_one_fault(kind))
    assert rep["faults"]["injected"] >= 1


@pytest.mark.parametrize("name,params", [
    ("pcie_cascade", {"tiers": 2}),
    ("oversubscribed_spine", {"oversubscription": 2.0, "leaf_ports": 4})])
def test_multi_tier_fabric(ref_constants, name, params):
    same_report(lambda s: dataclasses.replace(
        bench_cfg(s), topology=s.fabrics.make_topology(name, **params)))


# ---------------------------------------------------------------------------
# the seeded sweep of fault and recompose interleavings
# ---------------------------------------------------------------------------
_KINDS = ("device_down", "device_flaky", "domain_outage", "link_degrade",
          "tranche_brownout", "tranche_fail")
_DENSE_CASES = [
    [(0, 20, 24, 30), (2, 35, 0, 25), (1, 50, 16, 0)],
    [(4, 15, 0, 40), (5, 30, 0, 30), (3, 45, 0, 0)],
    [(0, 30, 12, 10), (2, 30, 0, 10), (5, 31, 0, 10), (3, 31, 0, 10)],
    [(1, 10, 32, 0), (2, 25, 0, 0), (0, 40, 8, 20)],
]


def _plan(s, choices):
    """(kind_idx, t, n, clear_dt) quadruples -> a scripted FaultPlan, as
    ``tests/test_fault_props.py`` builds them."""
    out = []
    for kind_idx, t, n, clear_dt in choices:
        out.append(s.faults.FaultSpec(
            kind=_KINDS[kind_idx % len(_KINDS)], t=float(t), n=int(n),
            domain=kind_idx % 2, frac=0.3, tranche="local-nvme-0", flaps=2,
            period_s=25.0, detect_s=1.0,
            t_clear=float(t + clear_dt) if clear_dt > 0 else float("inf")))
    return s.faults.FaultPlan(faults=tuple(out), retry_backoff_s=2.0)


def _elastic_cfg(s, seed, interval_s=10.0, cooldown_s=20.0,
                 failures=((60.0, 24),)):
    """``tests/test_recompose_props.py``'s elastic trace."""
    JT = s.sim.JobTemplate
    return s.sim.TraceConfig(
        n_jobs=10, arrival_rate_hz=0.3, seed=seed, n_local=64, n_switch=64,
        pods=2,
        templates=(JT("qwen2-0.5b", "train_4k", 16, 20, weight=3,
                      elastic=True),
                   JT("qwen2-0.5b", "train_4k", 32, 12, weight=2,
                      elastic=True),
                   JT("llama3.2-3b", "train_4k", 64, 8, weight=2,
                      elastic=True),
                   JT("mamba2-780m", "train_4k", 32, 10, weight=1)),
        failures=failures, repair_after_s=90.0,
        recompose=s.rc.RecomposeConfig(interval_s=interval_s,
                                       cooldown_s=cooldown_s))


def _random_choices(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 6)), int(rng.integers(0, 120)),
             int(rng.integers(1, 40)), int(rng.integers(0, 90)))
            for _ in range(int(rng.integers(1, 5)))]


SWEEP = (
    [(f"dense{c}_seed{sd}", (lambda c, sd: lambda s: s.sim.TraceConfig(
        n_jobs=10, arrival_rate_hz=0.3, seed=sd, failures=(),
        faults=_plan(s, _DENSE_CASES[c])))(c, sd))
     for c in range(len(_DENSE_CASES)) for sd in (0, 7)]
    + [("legacy_and_faults", lambda s: s.sim.TraceConfig(
        n_jobs=10, arrival_rate_hz=0.3, seed=3,
        failures=((40.0, 8), (60.0, 90.0, 12), (70.0, None, 6)),
        faults=_plan(s, [(0, 45, 16, 25), (4, 55, 0, 30)]))),
       ("mtbf_churn", lambda s: s.sim.TraceConfig(
           n_jobs=12, arrival_rate_hz=0.3, seed=5, failures=(),
           faults=s.faults.FaultPlan(mtbf_s=40.0, mttr_s=30.0,
                                     horizon_s=240.0, mtbf_n=32,
                                     detect_s=1.0, retry_backoff_s=2.0)))]
    + [(f"recompose_seed{sd}", (lambda sd: lambda s: _elastic_cfg(s, sd))(sd))
       for sd in (0, 3, 7, 11)]
    + [("recompose_aggressive", lambda s: _elastic_cfg(
        s, 5, interval_s=5.0, cooldown_s=5.0,
        failures=((40.0, 32), (100.0, 16)))),
       ("recompose_permanent_loss", lambda s: _elastic_cfg(
           s, 2, failures=((50.0, None, 48),)))]
    + [(f"faults_and_recompose{sd}", (lambda sd: lambda s: dataclasses.replace(
        _elastic_cfg(s, sd), faults=_plan(s, _random_choices(sd))))(sd))
       for sd in (21, 22, 23, 24)]
)


@pytest.mark.parametrize("name", [n for n, _ in SWEEP])
def test_fault_and_recompose_interleavings(ref_constants, name):
    rep = same_report(dict(SWEEP)[name])
    jobs = rep["jobs"]
    assert jobs["completed"] + jobs["rejected"] + jobs["failed"] \
        + jobs["stranded"] == jobs["submitted"]


# ---------------------------------------------------------------------------
# calibration: handed in, never process-wide
# ---------------------------------------------------------------------------
def _calibration(cm):
    cal = cm.CalibratedCost(kernel_speedup={"flash_attention": 1.5,
                                            "ssd": 2.0})
    cal.measure_cell("qwen2-0.5b", "train_4k", "16x1", 0.05)
    cal.measure_cell("llama3.2-3b", "train_4k", "64x1", 0.4)
    return cal


def _calibrated_cfg(s, cal):
    return dataclasses.replace(_elastic_cfg(s, 3), calibration=cal)


def test_handed_calibration_equals_the_reference_process_wide_one(
        ref_constants):
    """The reference under ``set_calibration(cal)`` (its scheduler and
    recomposer fall back to it) against the port handed ``cal`` through
    ``TraceConfig.calibration``: the same report, and a different one from
    the uncalibrated trace."""
    try:
        ref_recommend.set_calibration(_calibration(ref_costmodel))
        ref = report(REF, _calibrated_cfg(REF, None))
    finally:
        ref_recommend.set_calibration(None)
    port = report(PORT, _calibrated_cfg(PORT, _calibration(costmodel)))
    assert port == ref
    assert json.loads(port)["calibrated"] is True
    plain = report(PORT, _calibrated_cfg(PORT, None))
    assert plain != port and json.loads(plain)["calibrated"] is False
    # the scheduler's calibration is what it was handed, and nothing else
    pool = topology.make_pool(8, 8, 2)
    assert scheduler.Scheduler(pool).calibration is None
    cal = _calibration(costmodel)
    assert scheduler.Scheduler(pool, calibration=cal).calibration is cal
    for name in ("set_calibration", "get_calibration"):
        assert not hasattr(recommend, name)


# ---------------------------------------------------------------------------
# the mirror into a tracking run
# ---------------------------------------------------------------------------
class Clock:
    def __init__(self, t0=1_754_700_000.0, dt=0.25):
        self.t, self.dt = t0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def test_mirror_into_a_run_is_the_reference_mirror(ref_constants, tmp_path,
                                                   monkeypatch):
    """The simulator's ``event`` rows (``Run.log_event``), its ``system``
    sample of counters and its metrics row: the same bytes as the
    reference's, with the run's clock and the simulator's wall clock
    stubbed; the report itself is unchanged by the mirror."""
    files, reps = [], []
    for s in (REF, PORT):
        monkeypatch.setattr(s.sim, "time", types.SimpleNamespace(
            perf_counter=Clock(t0=100.0, dt=0.5)))
        run = s.tracking.Run("cluster-sim", dir=str(tmp_path / s.sim.__name__),
                             clock=Clock(), seed=3, sha="s",
                             samplers=[s.tracking.CounterSampler(
                                 "c", {"x": 1.0})])
        sim = s.sim.ClusterSimulator(chaos_cfgs(s)["outage"], tracker=run)
        reps.append(canon(sim.run()))
        run.finish()
        files.append(open(run.path, "rb").read())
    assert reps[1] == reps[0]
    assert files[1] == files[0]
    rows = [json.loads(l) for l in files[1].splitlines()]
    kinds = [r["kind"] for r in rows]
    assert kinds.count("event") > 5 and kinds.count("system") == 1
    assert {r["event"] for r in rows if r["kind"] == "event"} >= {
        "sim.fault", "sim.detect"}
    system = next(r for r in rows if r["kind"] == "system")
    assert "sim.auu" in system["metrics"] and "c.x" in system["metrics"]
    # without a tracker and outside a run the mirror is a no-op
    assert tracking.current_run() is None
    assert canon(simulator.ClusterSimulator(
        chaos_cfgs(PORT)["outage"]).run()) == reps[1]


# ---------------------------------------------------------------------------
# the H100's own constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["default", "cluster_trace"])
def test_h100_reports_differ_from_the_reference_and_repeat(name):
    """Without ``ref_constants`` the port prices the H100 (80 GiB of HBM,
    NVLink / PCIe / its host link): the report is not the reference's, and
    two runs give the same bytes."""
    build = SCENARIOS[name]
    port = report(PORT, build(PORT))
    assert report(PORT, build(PORT)) == port
    assert port != report(REF, build(REF))
    cfg = topology.ChipSpec()
    assert cfg.hbm_bytes == 80 * 2 ** 30
    assert json.loads(port)["jobs"]["completed"] > 0
