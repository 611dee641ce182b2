"""Port vs reference: the tracking plane (``repro_torch/tracking`` against
``repro/tracking``), the trainer's ``StepTracker``, the serving engine's
default tracker and ``launch/train --track``.

Under an injected clock, seed and commit a run's event stream must be
byte-identical to the reference's (the files are compared as bytes), and so
must the rows of the trainer's ``StepTracker`` fed the same metrics (torch
tensors here, numpy values there).  The engine and the launcher write
their runs into ``tmp_path``; the port's default paths are its own
(``results/torch/...``), never the reference's artifacts.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import tracking as ref_tracking
from repro.serve.engine import AsyncServeEngine as RefAsyncServeEngine
from repro.train.trainer import StepTracker as RefStepTracker

from repro_torch import tracking
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM
from repro_torch.serve import AsyncServeEngine, ServeRequest
from repro_torch.train.trainer import StepTracker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as in ``tests/test_torch_moe.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    """Deterministic clock: each call moves ``dt`` seconds on."""

    def __init__(self, t0=1_754_700_000.0, dt=0.25):
        self.t, self.dt = t0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


class Counters:
    """A sampler of pushed values (the sampler protocol: ``sample()``)."""

    def __init__(self, prefix, values):
        self.prefix, self.values = prefix, dict(values)

    def sample(self):
        return {f"{self.prefix}.{k}": v for k, v in self.values.items()}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------
def _drive(trk, d, status=None):
    counters = Counters("sim", {"auu": 0.5})
    run = trk.Run("bench/toy run", config={"arch": "x", "steps": 3,
                                           "shape": (2, 4), "obj": object},
                  tags=("a", "b"), dir=str(d), clock=Clock(), seed=11,
                  samplers=[counters], sha="abc1234")
    run.log({"loss": 2.5, "n": 3}, step=3)
    run.log({"loss": 2.25})
    run.log({"x": 1.0}, step=2)                   # never moves back
    counters.values.update({"auu": 0.75, "links": 2})
    run.log_system({"kv.pages_in_use": 4})
    run.log_summary({"makespan_s": 12.0})
    run.log_summary({"final": True})
    if status is None:
        run.finish()
    else:
        with run:
            raise_ = RuntimeError(status)
            try:
                raise raise_
            except RuntimeError:
                run.__exit__(RuntimeError, raise_, None)
    run.log({"after": 1.0})                        # dropped: finished
    return run


def test_run_event_stream_is_byte_identical(tmp_path):
    ref = _drive(ref_tracking, tmp_path / "ref")
    port = _drive(tracking, tmp_path / "port")
    assert port.id == ref.id
    assert _bytes(port.path) == _bytes(ref.path)
    assert tracking.read_events(port.path) == \
        ref_tracking.read_events(ref.path)
    kinds = [e["kind"] for e in tracking.read_events(port.path)]
    assert kinds == ["run", "metrics", "metrics", "metrics", "system",
                     "summary", "summary", "summary", "finish"]
    err = _drive(tracking, tmp_path / "port_err", status="boom")
    assert tracking.read_events(err.path)[-1]["status"] == "error"
    assert _bytes(err.path) == _bytes(
        _drive(ref_tracking, tmp_path / "ref_err", status="boom").path)


@pytest.mark.parametrize("seed", [None, 0, 5])
def test_run_ids_and_the_current_run(tmp_path, seed):
    for project, t in (("train-llama3.2-3b", 0.0), ("a/b c", 1.8e9)):
        if seed is not None:
            assert tracking.make_run_id(project, t, seed) == \
                ref_tracking.make_run_id(project, t, seed)
        else:
            assert tracking.make_run_id(project, t).startswith(
                ref_tracking.make_run_id(project, t, 0)[:-6])
    assert tracking.SCHEMA_VERSION == ref_tracking.SCHEMA_VERSION
    assert tracking.current_run() is None
    a = tracking.init("a", dir=str(tmp_path), seed=seed, sha="")
    assert tracking.current_run() is a and ref_tracking.current_run() is None
    b = tracking.init("b", dir=str(tmp_path), seed=seed, sha="")
    assert tracking.current_run() is b
    a.finish()
    assert tracking.current_run() is b
    b.finish()
    b.finish()
    assert tracking.current_run() is None
    # the port's default paths are its own
    assert tracking.Run.__init__.__kwdefaults__["dir"] == \
        os.path.join("results", "torch", "runs")
    assert tracking.Run.__init__.__kwdefaults__["dir"] != \
        ref_tracking.Run.__init__.__kwdefaults__["dir"]


def test_proc_sampler_keys():
    s = tracking.ProcSampler(clock=Clock())
    first, second = s.sample(), s.sample()
    want = ref_tracking.ProcSampler(clock=Clock()).sample()
    assert sorted(first) == sorted(want) == ["proc.cpu_pct", "proc.cpu_s",
                                             "proc.rss_mb"]
    assert first["proc.cpu_pct"] == 0.0 and second["proc.rss_mb"] > 0


@pytest.mark.parametrize("module, name", [
    ("tracking", "gate"), ("tracking", "trajectory")])
def test_tracking_surface_waits_for_its_callers(module, name):
    """The reference's trajectories and perf gate serve its benchmark
    harness: neither is ported before its caller (ROADMAP)."""
    ref = {"tracking": ref_tracking, "Run": ref_tracking.Run}[module]
    port = {"tracking": tracking, "Run": tracking.Run}[module]
    assert hasattr(ref, name)
    assert not hasattr(port, name)


def test_counter_sampler_is_the_reference_sampler(tmp_path):
    """``CounterSampler``, exported beside ``ProcSampler``: the same
    snapshots, and the same ``system`` rows when a run samples it."""
    def drive(trk, d):
        cs = trk.CounterSampler("sim", {"auu": 0.5, "links": 1})
        snaps = [cs.sample()]
        cs.update({"auu": 0.75, "kv.pages": 3})
        snaps.append(cs.sample())
        run = trk.Run("cs", dir=str(d), clock=Clock(), seed=1, sha="s",
                      samplers=[cs, trk.CounterSampler()])
        run.log_system({"extra": 2.0})
        cs.update({"links": 4})
        run.log_system()
        run.finish()
        return snaps, _bytes(run.path)
    assert drive(tracking, tmp_path / "port") ==         drive(ref_tracking, tmp_path / "ref")
    assert "CounterSampler" in tracking.__all__
    assert tracking.CounterSampler().sample() == {}


def test_log_event_rows_are_the_reference_rows(tmp_path):
    """``Run.log_event`` (the cluster simulator's mirror): rows with and
    without ``sim_t`` and data, between step rows, byte for byte."""
    def drive(trk, d):
        run = trk.Run("ev", dir=str(d), clock=Clock(), seed=4, sha="s")
        run.log_event("sim.fault", {"job": "j", "detail": "2 device(s)"},
                      sim_t=12.5)
        run.log({"loss": 1.0}, step=3)
        run.log_event("sim.repair")
        run.log_event("sim.evict", {"job": "k"}, sim_t=0.0)
        run.finish()
        run.log_event("sim.late")                   # dropped: finished
        return _bytes(run.path)
    port = drive(tracking, tmp_path / "port")
    assert port == drive(ref_tracking, tmp_path / "ref")
    rows = [json.loads(l) for l in port.splitlines()]
    events = [r for r in rows if r["kind"] == "event"]
    assert [e["event"] for e in events] == ["sim.fault", "sim.repair",
                                            "sim.evict"]
    assert [e.get("sim_t") for e in events] == [12.5, None, 0.0]
    assert [e["step"] for e in events] == [0, 3, 3]


# ---------------------------------------------------------------------------
# the trainer's StepTracker
# ---------------------------------------------------------------------------
def _steps(n=5):
    rng = np.random.default_rng(0)
    return [{"loss": float(rng.uniform(2, 3)), "aux": 0.0,
             "grad_norm": float(rng.uniform(0.5, 2)), "lr": 1e-4 * i,
             "tag": "not a number", "n": i} for i in range(n)]


def _track(trk, tracker_cls, d, as_value):
    run = trk.Run("train-toy", dir=str(d), clock=Clock(), seed=2, sha="s",
                  samplers=[Counters("c", {"x": 1.0})])
    st = tracker_cls(4096, run, clock=Clock(dt=0.5), system_every=2)
    for i, m in enumerate(_steps()):
        st.step(i, {k: as_value(v) for k, v in m.items()})
    out = st.summary()
    run.finish()
    return run, out


def test_step_tracker_rows_are_the_reference_rows(tmp_path):
    def as_tensor(v):
        return torch.tensor(v, dtype=torch.float64) \
            if isinstance(v, float) else v

    def as_numpy(v):
        return np.float64(v) if isinstance(v, float) else v

    port, out = _track(tracking, StepTracker, tmp_path / "port", as_tensor)
    ref, ref_out = _track(ref_tracking, RefStepTracker, tmp_path / "ref",
                          as_numpy)
    assert out == ref_out
    assert _bytes(port.path) == _bytes(ref.path)
    rows = [e for e in tracking.read_events(port.path)
            if e["kind"] == "metrics"]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["metrics"]["loss"] for r in rows] == \
        [m["loss"] for m in _steps()]
    assert "tag" not in rows[0]["metrics"]
    assert rows[1]["metrics"]["step_s"] == 0.5
    # no run: every call is a no-op
    idle = StepTracker(8)
    assert idle.run is None
    idle.step(0, {"loss": torch.tensor(1.0)})
    assert idle.summary() == {"steps": 0, "tokens_per_s": 0.0}


# ---------------------------------------------------------------------------
# the serving engine's default tracker
# ---------------------------------------------------------------------------
def test_engine_logs_to_the_current_run(tmp_path):
    cfg = reduced(get_config("llama3.2-3b"))
    model = LM.init(cfg, seed=0, device="cpu")
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel")
    eng = AsyncServeEngine(cfg, model, policy, mode="paged", n_slots=2,
                           max_seq=64, page_size=8, prefill_chunk=16,
                           clock=Clock(0.0, 0.01), track_every=2,
                           device="cpu")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size, 9 + 4 * i)
                         .tolist(), max_new=4) for i in range(3)]
    run = tracking.init("serve", dir=str(tmp_path / "runs"), seed=0,
                        sha="", clock=Clock())
    try:
        for r in reqs:
            assert eng.submit(r)
        eng.run()
    finally:
        run.finish()
    assert all(r.done for r in reqs)
    events = tracking.read_events(run.path)
    rows = [e["metrics"] for e in events if e["kind"] == "metrics"]
    assert eng._iters >= 4
    assert [r["iter"] for r in rows] == list(range(2, eng._iters + 1, 2))
    done = [r["completed"] for r in rows]
    assert done == sorted(done) and 0 < done[-1] <= 3
    system = [e["metrics"] for e in events if e["kind"] == "system"]
    assert len(system) == len(rows)
    assert set(system[0]) == {"kv.pages_in_use", "kv.hit_rate"}

    # the same state logged by the reference's code: the same bytes
    win = (eng._win_completed, eng._win_tokens, eng._win_t)
    now = eng.now()
    logs = {}
    for name, trk, fn in (("port", tracking, AsyncServeEngine._track_window),
                          ("ref", ref_tracking,
                           RefAsyncServeEngine._track_window)):
        eng._win_completed, eng._win_tokens, eng._win_t = win
        eng.tracker = trk.Run("w", dir=str(tmp_path / name), seed=1, sha="",
                              clock=Clock())
        fn(eng, now)
        eng.tracker.finish()
        logs[name] = _bytes(eng.tracker.path)
    assert logs["port"] == logs["ref"]
    # without a run nothing is logged and nothing breaks
    eng.tracker = None
    eng._track_window(eng.now())


# ---------------------------------------------------------------------------
# launch/train --track
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fail_at", [0, 1])
def test_launch_train_track_writes_a_readable_run(tmp_path, monkeypatch,
                                                  capsys, fail_at):
    monkeypatch.chdir(tmp_path)
    argv = ["--track", "--device", "cpu", "--reduced", "--steps", "2",
            "--log-every", "1"]
    if fail_at:
        argv += ["--fail-at", str(fail_at)]
    assert launch_train.main(argv) == (17 if fail_at else 0)
    root = tmp_path / "results" / "torch" / "runs"
    (run_dir,) = os.listdir(root)
    events = tracking.read_events(str(root / run_dir / "events.jsonl"))
    assert events[0]["kind"] == "run"
    assert events[0]["config"]["steps"] == 2 and events[0]["tags"] == \
        ["train"]
    rows = [e for e in events if e["kind"] == "metrics"]
    n = fail_at or 2
    assert [r["step"] for r in rows] == list(range(1, n + 1))
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step ")]
    # the launcher prints a step's line after its failure check
    assert len(printed) == n - bool(fail_at)
    assert [round(r["metrics"]["loss"], 4) for r in rows][:len(printed)] \
        == printed
    assert events[-1] == {**events[-1], "kind": "finish",
                          "status": "failed" if fail_at else "ok"}
    assert json.loads(json.dumps(events)) == events
    assert tracking.current_run() is None
