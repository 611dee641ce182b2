"""One program per serving step: the engine's pow2 step buckets and its
graph runner (``repro_torch/serve/graphs.py``), held against the reference
``AsyncServeEngine``, whose ``jax.jit`` steps they stand for.

The same prompts and weights (numpy, converted by
``repro_torch.convert.from_reference``) go through the reference (JAX on the
CPU) and the port (``device="cpu"``), fp32, a fixed injected clock, a
reduced 2-layer model.  Greedy streams must be **identical**, last-step
logits within 2e-4.  On the CPU the runner stages every step through the
same static buffers as on the card and calls the step where the card
replays its graph; a capture and its replays run only on the card
(``@pytest.mark.gpu``, and ``python3 chip_smoke.py``'s ``graphs`` phase).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.kernels.registry import bucket_pow2 as ref_bucket_pow2
from repro.models import lm as ref_lm
from repro.serve import AsyncServeEngine as RefAsyncServeEngine
from repro.serve import ServeRequest as RefServeRequest

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pa
from repro_torch.serve import AsyncServeEngine, ServeRequest
from repro_torch.serve.engine import pow2_buckets
from repro_torch.serve.graphs import StepGraphs, uncounted
from repro_torch.serve.kvcache import BlockTable

REF_POLICY = RefPolicy(compute_dtype="float32", remat="none",
                       attn_impl="full")
# 4 slots, so that 3 live rows pad to 4 as in the reference
ENGINE_KW = dict(n_slots=4, max_seq=96, page_size=8, prefill_chunk=16)


class FixedClock:
    """Injected clock: advances 1 ms per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _prompt(seed: int, n: int, vocab: int):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


@pytest.fixture(scope="module")
def weights():
    ref_cfg = ref_reduced(ref_get_config("qwen2-0.5b"))
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(1)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    params = jax.tree.map(redraw, tree)
    return ref_cfg, params, reduced(get_config("qwen2-0.5b"))


def _engine(weights, graphs=True, **kw):
    _, params, cfg = weights
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    model = convert.from_reference(params, cfg, dtype=torch.float32,
                                   device="cpu")
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel")
    return AsyncServeEngine(cfg, model, policy, clock=FixedClock(),
                            graphs=graphs, device="cpu", **kw)


def _ref_engine(weights, **kw):
    ref_cfg, params, _ = weights
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    return RefAsyncServeEngine(ref_cfg, jax.tree.map(jnp.asarray, params),
                               REF_POLICY, clock=FixedClock(), **kw)


def _serve(eng, prompts, cls, max_new=5):
    reqs = [cls(i, list(p), max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


def _prompts(cfg, lens):
    return [_prompt(30 + i, n, cfg.vocab_size) for i, n in enumerate(lens)]


class _Rows:
    """A request's block table, as ``_table_width`` reads it."""

    def __init__(self, pages):
        self.table = BlockTable(list(pages))


# ---------------------------------------------------------------------------
# the buckets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slots,max_seq,page", [(4, 96, 8), (3, 64, 16),
                                                (8, 256, 16)])
def test_row_and_width_buckets_follow_the_reference_rule(weights, slots,
                                                         max_seq, page):
    """Every batch size and table length: the port pads rows to the
    reference's ``min(bucket_pow2(B, 1), n_slots)`` and tables to its
    ``_table_width``, the keys of the width-1 steps show both, and prompts
    bucket as its ``_dense_prefill`` does."""
    kw = dict(n_slots=slots, max_seq=max_seq, page_size=page)
    eng, ref = _engine(weights, **kw), _ref_engine(weights, **kw)
    cap = eng.pool.pages_for(max_seq)
    for B in range(1, slots + 1):
        for need in range(1, cap + 1):
            rows = [_Rows(range(need if i == 0 else 1)) for i in range(B)]
            want_p = ref._table_width(rows)
            assert eng._table_width(rows, span=1) == want_p
            assert eng._table_width(rows, span=need * page) == want_p
            # a chunk row's padded columns may reach past the table
            span = need * page + 3 * page
            assert eng._table_width(rows, span=span) == max(
                want_p, eng.pool.pages_for(span))
    for B in range(1, slots + 1):
        need = 1 + B % cap
        rows = [_Rows(range(need)) for _ in range(B)]
        eng._run_paged(rows, [[0]] * B, [[0]] * B, [[False]] * B, [0] * B)
    want_rows = [min(ref_bucket_pow2(B, floor=1), slots)
                 for B in range(1, slots + 1)]
    assert sorted(k[1] for k in eng.graphs.used.elements()) == want_rows
    assert all(k[0] == "decode" and k[3] == 1 for k in eng.graphs.used)
    assert {min(ref_bucket_pow2(L, floor=16), max_seq)
            for L in range(1, max_seq + 1)} == set(pow2_buckets(max_seq, 16))
    assert set(pow2_buckets(slots)) == set(want_rows)


# ---------------------------------------------------------------------------
# port == reference, bucketed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_padded_paged_engine_matches_reference(weights, graphs):
    """Three live rows (padded to four): greedy streams identical to the
    reference's, then one pure-decode step's logits within 2e-4."""
    prompts = _prompts(weights[2], [17, 26, 35])
    ref_eng, eng = _ref_engine(weights), _engine(weights, graphs)
    ref_reqs = [RefServeRequest(i, list(p), max_new=7)
                for i, p in enumerate(prompts)]
    reqs = [ServeRequest(i, list(p), max_new=7)
            for i, p in enumerate(prompts)]
    for a, b in zip(ref_reqs, reqs):
        ref_eng.submit(a)
        eng.submit(b)
    while not all(r.state == "decode" and len(r.out) >= 3 for r in reqs):
        ref_eng.step()
        eng.step()
    assert [r.out for r in ref_reqs] == [r.out for r in reqs]
    toks = [[r.out[-1]] for r in reqs]
    pos = [[r.prompt_len + len(r.out) - 1] for r in reqs]
    nxt, logits = eng._run_paged(reqs, toks, pos, [[True]] * 3, [0] * 3)
    ref_nxt, ref_logits = ref_eng._run_paged(
        ref_reqs, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.ones((3, 1), bool), jnp.zeros((3,), jnp.int32))
    assert logits.shape == (3, weights[2].padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-4, rtol=2e-4)
    assert nxt == [int(t) for t in ref_nxt[:3]]
    assert ("decode", 4, eng._table_width(reqs, 1), 1) in eng.graphs.used
    # whole streams, on fresh engines
    ref = _serve(_ref_engine(weights), prompts, RefServeRequest, max_new=9)
    got = _serve(_engine(weights, graphs), prompts, ServeRequest, max_new=9)
    assert [r.out for r in ref] == [r.out for r in got]


@pytest.mark.parametrize("graphs", [True, False], ids=["graphs", "eager"])
def test_dense_bucketed_engine_matches_reference(weights, graphs):
    """Dense mode: prompts in four pow2 buckets (16, 32, 64 and the
    capacity 96), each prefill padded to its bucket, then decode steps
    over every slot: streams identical to the reference's."""
    prompts = _prompts(weights[2], [5, 20, 40, 70])
    ref = _serve(_ref_engine(weights, mode="dense"), prompts,
                 RefServeRequest, max_new=6)
    eng = _engine(weights, graphs, mode="dense")
    got = _serve(eng, prompts, ServeRequest, max_new=6)
    assert [r.out for r in ref] == [r.out for r in got]
    assert {k for k in eng.graphs.used if k[0] == "prefill"} == {
        ("prefill", 16), ("prefill", 32), ("prefill", 64), ("prefill", 96)}


@pytest.mark.parametrize("kw", [dict(mode="paged", fused=True),
                                dict(mode="paged", fused=False),
                                dict(mode="dense")],
                         ids=["paged-fused", "paged-unfused", "dense"])
def test_graphs_flag_gives_identical_streams_on_the_cpu(weights, kw):
    prompts = _prompts(weights[2], [9, 33, 21, 50, 12])
    outs = []
    for graphs in (True, False):
        eng = _engine(weights, graphs, **kw)
        eng.warmup(max_tokens=64)
        outs.append([r.out for r in _serve(eng, prompts, ServeRequest)])
        rep = eng.report()["graphs"]
        assert rep["enabled"] is False and rep["graphs"] == 0
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# launch counts and keys
# ---------------------------------------------------------------------------
def test_add_launch_counts_turns_captured_deltas_into_eager_counts():
    """A replay calls no wrapper: ``uncounted`` records what a step adds
    and takes it back out (a capture launches nothing), and adding that
    delta once per replay gives the counts of running the step each time."""
    def step():               # stands for a step whose wrappers launch
        _fa.flash_attention.launches += 2
        _pa.paged_decode_attention.launches += 28
        return "out"

    ops.reset_launch_counts()
    for _ in range(5):
        step()
    eager = ops.launch_counts()
    ops.reset_launch_counts()
    out, delta = uncounted(step)
    assert out == "out" and all(v == 0 for v in ops.launch_counts().values())
    assert delta["flash_attention"] == 2
    assert delta["paged_decode_attention"] == 28
    for _ in range(5):
        ops.add_launch_counts(delta)
    assert ops.launch_counts() == eager
    ops.reset_launch_counts()


def test_step_keys_stay_within_the_bucket_grid(weights):
    cfg = weights[2]
    lens = [7, 15, 30, 44, 61, 70, 9, 25]
    eng = _engine(weights)
    _serve(eng, _prompts(cfg, lens), ServeRequest, max_new=8)
    cap = eng.pool.pages_for(eng.max_seq)
    rows, widths = set(pow2_buckets(eng.n_slots)), set(pow2_buckets(cap))
    kinds = {k[0] for k in eng.graphs.used}
    assert kinds == {"decode", "chunk"}
    for kind, B, P, W in eng.graphs.used:
        assert B in rows
        if kind == "decode":
            assert P in widths and W == 1
        else:
            assert W == eng.prefill_chunk
            assert P in widths or P > cap
    dense = _engine(weights, mode="dense")
    _serve(dense, _prompts(cfg, lens), ServeRequest, max_new=8)
    for key in dense.graphs.used:
        assert key in {("decode", dense.n_slots)} | {
            ("prefill", S) for S in pow2_buckets(dense.max_seq, 16)}


def test_warmup_prepares_every_key_of_the_grid(weights):
    eng = _engine(weights)
    eng.warmup()
    cap = eng.pool.pages_for(eng.max_seq)
    want = {("decode", B, P, 1) for B in pow2_buckets(eng.n_slots)
            for P in pow2_buckets(cap)}
    keys = set(eng.graphs._steps)
    assert want <= keys and len(keys - want) == 1      # and one chunk key
    assert not eng.graphs.used                          # no step served
    dense = _engine(weights, mode="dense")
    dense.warmup()
    assert set(dense.graphs._steps) == {("decode", dense.n_slots)} | {
        ("prefill", S) for S in pow2_buckets(dense.max_seq, 16)}


def test_static_buffers_take_one_copy_and_check_shapes():
    g = StepGraphs(torch.device("cpu"))
    seen = []

    def fn(a, b):
        seen.append((a.clone(), b.clone()))
        return a.sum() + b.sum()

    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b": np.array([7], np.int32)}
    assert int(g.run("k", fn, arrays)) == 22
    arrays["a"] = arrays["a"] * 2
    assert int(g.run("k", fn, arrays)) == 37
    step = g._steps["k"]
    assert step.dev.numel() == 7 and step.graph is None
    assert seen[1][0].data_ptr() != seen[0][0].data_ptr()
    assert g.used["k"] == 2
    with pytest.raises(ValueError, match="shape"):
        g.run("k", fn, {"a": np.zeros((3, 2), np.int32), "b": arrays["b"]})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and "
                    "replayed only on the card (python3 chip_smoke.py's "
                    "graphs phase serves with and without them there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_steps_replay_as_the_eager_engine_serves(weights,
                                                          cuda_device):
    _, params, cfg = weights
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel")
    prompts = _prompts(cfg, [9, 33, 21, 50])
    for mode in ("paged", "dense"):
        outs, counts = [], []
        for graphs in (True, False):
            model = convert.from_reference(params, cfg, dtype=torch.float32,
                                           device=cuda_device)
            eng = AsyncServeEngine(cfg, model, policy, mode=mode,
                                   graphs=graphs, device=cuda_device,
                                   **ENGINE_KW)
            eng.warmup()
            assert (eng.report()["graphs"]["graphs"] > 0) == graphs
            ops.reset_launch_counts()
            outs.append([r.out for r in _serve(eng, prompts, ServeRequest)])
            counts.append(ops.launch_counts())
        assert outs[0] == outs[1] and counts[0] == counts[1]
