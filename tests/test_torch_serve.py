"""The serving slice as a whole: the port's engines against the reference's.

The same prompts and the same weights (made with numpy, converted by
``repro_torch.convert.from_reference``) go through the reference
``AsyncServeEngine`` (JAX on the CPU) and the port's (``device="cpu"``), both
in fp32 under a fixed injected clock.  Greedy token streams must be
**identical**; last-step logits agree within 2e-4 (fp32 on both sides, other
summation order, two layers).
"""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.models import lm as ref_lm
from repro.serve import AsyncServeEngine as RefAsyncServeEngine
from repro.serve import ServeRequest as RefServeRequest

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (SLO, AsyncServeEngine, Request, ServeEngine,
                               ServeRequest)
from repro_torch.train.trainer import make_run_ctx

REF_POLICY = RefPolicy(compute_dtype="float32", remat="none",
                       attn_impl="full")
ENGINE_KW = dict(n_slots=3, max_seq=96, page_size=8, prefill_chunk=16)


def _policy(impl="kernel"):
    return PolicyConfig(compute_dtype="float32", remat="none",
                        attn_impl=impl)


def _prompt(seed: int, n: int, vocab: int):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


class FixedClock:
    """Injected clock: advances 1 ms per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced(ref_get_config("qwen2-0.5b"))
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(0)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    params = jax.tree.map(redraw, tree)
    return ref_cfg, params, reduced(get_config("qwen2-0.5b"))


def _model(weights):
    _, params, cfg = weights
    return convert.from_reference(params, cfg, dtype=torch.float32,
                                  device="cpu")


def _engine(weights, impl="kernel", **kw):
    cfg = weights[2]
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    return AsyncServeEngine(cfg, _model(weights), _policy(impl),
                            clock=FixedClock(), device="cpu", **kw)


def _ref_engine(weights, **kw):
    ref_cfg, params, _ = weights
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    return RefAsyncServeEngine(ref_cfg, jax.tree.map(jnp.asarray, params),
                               REF_POLICY, clock=FixedClock(), **kw)


def _prompts(cfg, n=4):
    return [_prompt(10 + i, 20 + 5 * i, cfg.vocab_size) for i in range(n)]


def _serve(eng, prompts, cls, max_new=5):
    reqs = [cls(i, list(p), max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


# ---------------------------------------------------------------------------
# port == reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(mode="paged", fused=True), dict(mode="paged", fused=False),
    dict(mode="dense")], ids=["paged-fused", "paged-unfused", "dense"])
def test_greedy_streams_identical_to_reference(weights, kw):
    prompts = _prompts(weights[2])
    ref = _serve(_ref_engine(weights, **kw), prompts, RefServeRequest)
    eng = _engine(weights, **kw)
    got = _serve(eng, prompts, ServeRequest)
    for a, b in zip(ref, got):
        assert a.out == b.out
    rep = eng.report()
    assert rep["mode"] == kw["mode"]
    assert rep["requests"]["completed"] == len(prompts)
    if kw["mode"] == "paged":
        assert rep["decode_iterations"] > 0
        assert eng.pool.in_use == 0           # full recycling


def test_last_step_logits_match_reference(weights):
    """One pure-decode step, straight off the pool on the port's side and
    through the gathered dense view on the reference's: logits within 2e-4
    and the same argmax."""
    prompts = _prompts(weights[2], n=3)
    ref_eng, eng = _ref_engine(weights), _engine(weights)
    ref_reqs = [RefServeRequest(i, list(p), max_new=6)
                for i, p in enumerate(prompts)]
    reqs = [ServeRequest(i, list(p), max_new=6)
            for i, p in enumerate(prompts)]
    for a, b in zip(ref_reqs, reqs):
        ref_eng.submit(a)
        eng.submit(b)
    while not all(r.state == "decode" and len(r.out) >= 2 for r in reqs):
        ref_eng.step()
        eng.step()
    assert [r.out for r in ref_reqs] == [r.out for r in reqs]

    def decode_rows(rs):
        return ([[r.out[-1]] for r in rs],
                [[r.prompt_len + len(r.out) - 1] for r in rs])

    toks, pos = decode_rows(reqs)
    nxt, logits = eng._run_paged(reqs, toks, pos, [[True]] * 3, [0] * 3)
    ref_nxt, ref_logits = ref_eng._run_paged(
        ref_reqs, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.ones((3, 1), bool), jnp.zeros((3,), jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-4, rtol=2e-4)
    assert nxt == [int(t) for t in ref_nxt[:3]]


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------
def test_paged_engine_matches_teacher_forcing(weights):
    cfg = weights[2]
    reqs = _serve(_engine(weights), _prompts(cfg), ServeRequest)
    model = _model(weights)
    ctx = make_run_ctx(cfg, _policy("full"))
    for r in reqs[:2]:
        toks = list(r.prompt)
        for expect in r.out:
            with torch.no_grad():
                logits, _, _ = model(torch.tensor([toks]), ctx)
            assert int(logits[0, -1].argmax()) == expect
            toks.append(expect)


def test_fused_equals_unfused_and_kernel_path_equals_oracle(weights):
    prompts = _prompts(weights[2])
    outs = [[r.out for r in _serve(_engine(weights, impl, fused=fused),
                                   prompts, ServeRequest)]
            for impl, fused in (("kernel", True), ("kernel", False),
                                ("full", True))]
    assert outs[0] == outs[1] == outs[2]


def test_decode_rows_off_the_pool_equal_the_gather_path(weights):
    """The decode-row path that bypasses ``gather_dense`` computes what the
    gather -> decode_attention -> scatter path computes: same logits (1e-5:
    the same fp32 math on another layout), same tokens, same pool."""
    prompts = _prompts(weights[2], n=3)
    a, b = _engine(weights), _engine(weights)
    ra = [ServeRequest(i, list(p), max_new=8) for i, p in enumerate(prompts)]
    rb = [ServeRequest(i, list(p), max_new=8) for i, p in enumerate(prompts)]
    for x, y in zip(ra, rb):
        a.submit(x)
        b.submit(y)
    while not all(r.state == "decode" for r in ra):
        a.step()
        b.step()
    toks = [[r.out[-1]] for r in ra]
    pos = [[r.prompt_len + len(r.out) - 1] for r in ra]
    n0 = a.report()["decode_iterations"]
    nxt_a, log_a = a._run_paged(ra, toks, pos, [[True]] * 3, [0] * 3,
                                dense_view=False)
    nxt_b, log_b = b._run_paged(rb, toks, pos, [[True]] * 3, [0] * 3,
                                dense_view=True)
    assert a.report()["decode_iterations"] == n0 + 1
    assert b.report()["decode_iterations"] == n0
    assert nxt_a == nxt_b
    np.testing.assert_allclose(log_a.numpy(), log_b.numpy(), atol=1e-5,
                               rtol=1e-5)
    for la, lb in zip(a.pool.pages, b.pool.pages):
        live = list(range(a.pool.n_pages))
        assert torch.equal(la["pos"][live], lb["pos"][live])
        np.testing.assert_allclose(la["k"][live].numpy(),
                                   lb["k"][live].numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_prefix_reuse_hits_and_leaves_outputs_unchanged(weights):
    cfg = weights[2]
    shared = _prompt(42, 33, cfg.vocab_size)
    prompts = [shared + _prompt(50 + i, 5, cfg.vocab_size) for i in range(4)]

    def run(slots):
        eng = _engine(weights, n_slots=slots)
        return eng, _serve(eng, prompts, ServeRequest, max_new=4)

    e1, r1 = run(2)
    e2, r2 = run(3)
    assert e1.pool.hit_tokens > 0             # later requests reuse prefix
    assert e1.report()["kv_pages"]["hit_rate"] > 0
    for a, b in zip(r1, r2):
        assert a.out == b.out
    assert e1.pool.in_use == 0                # full recycling
    ref = _serve(_ref_engine(weights, n_slots=2), prompts, RefServeRequest,
                 max_new=4)
    assert [r.out for r in ref] == [r.out for r in r1]


def test_chunk_rows_padded_past_the_table_stay_in_bounds(weights):
    """A decode row near the end of its pages rides in a mixed iteration
    padded to ``prefill_chunk`` columns: its padded positions run past its
    own pages and must land on the scratch page, not out of bounds."""
    cfg = weights[2]
    eng = _engine(weights, n_slots=2, max_seq=64, prefill_chunk=32)
    first = ServeRequest(0, _prompt(1, 9, cfg.vocab_size), max_new=6)
    eng.submit(first)
    while first.state != "decode":
        eng.step()
    late = ServeRequest(1, _prompt(2, 50, cfg.vocab_size), max_new=3)
    eng.submit(late)
    eng.run()
    assert first.done and late.done
    alone = _serve(_engine(weights, n_slots=2, max_seq=64, prefill_chunk=32),
                   [first.prompt], ServeRequest, max_new=6)
    assert alone[0].out == first.out


def test_engine_rejects_overlong_prompt(weights):
    cfg = weights[2]
    eng = _engine(weights)
    bad = ServeRequest(0, _prompt(0, 95, cfg.vocab_size), max_new=8)
    assert not eng.submit(bad)
    assert bad.state == "rejected" and "capacity" in bad.why_rejected
    assert eng.report()["requests"]["rejected"] == 1


def test_drain_and_timeouts(weights):
    cfg = weights[2]
    eng = _engine(weights, request_timeout_s=0.5)
    r = ServeRequest(0, _prompt(0, 20, cfg.vocab_size), max_new=50)
    assert eng.submit(r)
    eng.step()
    eng.clock.t += 1.0                        # past the deadline
    eng.run()
    assert r.state == "timed_out" and eng.pool.in_use == 0
    assert eng.report()["requests"]["timed_out"] == 1
    eng.drain()
    late = ServeRequest(1, _prompt(1, 8, cfg.vocab_size), max_new=2)
    assert not eng.submit(late) and "draining" in late.why_rejected


def test_warmup_leaves_state_untouched_and_reports_its_time(weights):
    prompts = _prompts(weights[2], n=2)
    for kw in (dict(mode="paged"), dict(mode="dense")):
        cold = [r.out for r in _serve(_engine(weights, **kw), prompts,
                                      ServeRequest)]
        eng = _engine(weights, **kw)
        dt = eng.warmup()
        assert dt >= 0 and eng.report()["compile_s"] == dt
        if eng.pool is not None:
            assert eng.pool.in_use == 0 and eng.pool.hit_tokens == 0
            for layer in eng.pool.pages:
                assert (layer["pos"] == -1).all()
        assert eng.report()["decode_iterations"] == 0
        assert [r.out for r in _serve(eng, prompts, ServeRequest)] == cold


def test_tracker_gets_windowed_rows(weights):
    class Tracker:
        def __init__(self):
            self.rows, self.system = [], []

        def log(self, row, step=None):
            self.rows.append((step, row))

        def log_system(self, row):
            self.system.append(row)

    tr = Tracker()
    eng = _engine(weights, tracker=tr, track_every=2)
    _serve(eng, _prompts(weights[2], n=2), ServeRequest)
    assert tr.rows and tr.system
    assert {"iter", "queue_depth", "active", "completed"} <= set(
        tr.rows[-1][1])
    assert "kv.hit_rate" in tr.system[-1]


def test_serve_engine_dense_slots_match_teacher_forcing(weights):
    cfg = weights[2]
    model = _model(weights)
    eng = ServeEngine(cfg, model, _policy(), n_slots=2, max_seq=64,
                      device="cpu")
    reqs = [Request(i, torch.tensor(_prompt(i, 10 + 3 * i, cfg.vocab_size)),
                    max_new=4) for i in range(2)]
    for r in reqs:
        assert eng.add_request(r)
    assert not eng.add_request(Request(9, torch.tensor([1, 2, 3])))
    while eng.step():
        pass
    ctx = make_run_ctx(cfg, _policy("full"))
    for r in reqs:
        assert r.done and len(r.out) == 4
        toks = r.prompt.tolist()
        for expect in r.out:
            with torch.no_grad():
                logits, _, _ = model(torch.tensor([toks]), ctx)
            assert int(logits[0, -1].argmax()) == expect
            toks.append(expect)


def test_engines_default_to_cuda_and_raise_without_one(weights):
    cfg = weights[2]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncServeEngine(cfg, _model(weights), _policy())
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, _model(weights), _policy())


def test_cpu_run_launches_no_kernel(weights):
    before = dict(ops.launch_counts())
    _serve(_engine(weights), _prompts(weights[2], n=2), ServeRequest)
    assert ops.launch_counts() == before


def test_slo_and_scheduler_are_the_copied_ones():
    r = ServeRequest(0, [1, 2, 3], max_new=2, slo=SLO(ttft_s=0.1))
    assert r.ttft_deadline() == pytest.approx(0.1)
    assert dataclasses.is_dataclass(r)


# ---------------------------------------------------------------------------
# the command-line entry point
# ---------------------------------------------------------------------------
def _main(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(list(argv))
    return rc, buf.getvalue()


def test_launch_serve_exit_codes_on_cpu():
    rc, out = _main("--device", "cpu", "--requests", "3", "--max-new", "4",
                    "--max-seq", "64", "--prompt-len", "12")
    assert rc == 0 and "served 3/3" in out and "kv pages:" in out
    rc, out = _main("--device", "cpu", "--prompt-len", "200", "--max-seq",
                    "128")
    assert rc == 2 and "exceed --max-seq" in out
    rc, out = _main("--device", "cpu", "--mode", "dense", "--requests", "2",
                    "--max-new", "3", "--max-seq", "64", "--prompt-len", "9",
                    "--dtype", "bfloat16", "--no-warmup")
    assert rc == 0 and "dense mode" in out
