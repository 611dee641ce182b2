"""The rest of tensor parallelism in four ``gloo`` processes on the CPU,
held against the reference: reduced recurrentgemma-2b's TP and ZeRO-3 + TP
train steps (the RG-LRU block and windowed attention under ``model``) on
``(data, model) = (2, 2)`` and ``(1, 4)`` against the reference's jitted
single-device step; its dense ``ServeEngine``'s greedy streams on
``(2, 2)`` with a prompt longer than the window (the prefill's K/V re-laid
into a ring cache's length pieces) against the reference's engine; the
paged ``AsyncServeEngine`` (heads over ``model``) on ``(1, 4)`` for
reduced llama3.2-3b with H = K = 6 (H padded to 8: the last rank holds
padded heads only) and with K = 2 (G = 3: a KV head on two ranks), and on
``(1, 2)`` for reduced qwen2-0.5b, against the reference's paged engine;
reduced moonshot-v1-16b-a3b on a four-rank data-only mesh (MoE in the
global batch's order) against the reference's jitted step, at a capacity
that drops tokens, and ``moe_sorted`` with the dp group against the
reference's ``moe_sorted`` on the whole batch.  In-process: the gates of a
channel range that splits a gate block, recurrentgemma's cache specs
(the ``(R, R)`` remainder included) against the reference's, and the
paged engine's refusal of a mesh whose dp axes exceed 1.

One group of four processes runs every job and case
(``rehearse.four_ranks``), started from a thread while this process
computes the reference's side.  The ranks import neither JAX nor the
reference.

Tolerances: train steps those of ``tests/test_torch_tensor_parallel.py``
(loss, aux and grad norm 1e-5 relative; updated parameters 1e-6 where the
reference's first moment is clear of rounding, ``SURE_M``, else within 2
lr); MoE 1e-5 of the output's largest magnitude; gates 1e-6; greedy
streams exactly.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.core import policy as ref_policy
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.serve import AsyncServeEngine as RefAsyncServeEngine
from repro.serve import ServeRequest as RefServeRequest
from repro.serve import engine as ref_engine
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.core import policy as pol
from repro_torch.launch import rehearse
from repro_torch.launch.rehearse import Job
from repro_torch.models import rglru, transformer
from repro_torch.models.lm import LM
from repro_torch.models.transformer import ParallelCtx
from repro_torch.serve.engine import AsyncServeEngine

LR, WD = 1e-3, 0.1
RG, LLAMA, QWEN, MOE = ("recurrentgemma-2b", "llama3.2-3b", "qwen2-0.5b",
                        "moonshot-v1-16b-a3b")
RG_LAYERS = 3                       # (rglru, rglru, attn_local)
TWO_BY_TWO = (("data", 2), ("model", 2))
ONE_BY_FOUR = (("data", 1), ("model", 4))
RG_JOBS = [Job(arch=RG, n_layers=RG_LAYERS, mesh=m, zero=z, lr=LR)
           for m in (TWO_BY_TWO, ONE_BY_FOUR) for z in (0, 3)]
# 0.5 of the reference's 1.25: every expert's capacity drops tokens
MOE_CF = 0.5
MOE_JOBS = [Job(arch=MOE, mesh=(("data", 4),), lr=LR,
                capacity_factor=MOE_CF)]
JOBS = RG_JOBS + MOE_JOBS
MAX_NEW = 6
KV2 = {"n_kv_heads": 2}
# (case, arch, mesh, config overrides)
PAGED = (("paged_llama", LLAMA, ONE_BY_FOUR, None),
         ("paged_llama_kv2", LLAMA, ONE_BY_FOUR, KV2),
         ("paged_qwen", QWEN, (("data", 1), ("model", 2)), None))
RG_MAX_SEQ = 128
# the first moment above which an element's update is held at 1e-6:
# ``rehearse._rel_sure``'s (a gradient clear of rounding, which Adam's first
# step turns into an update of up to lr).  recurrentgemma's embedding rows
# of rare tokens hold clipped gradients of ~2e-7 whose reduction order
# moves them by a few per cent.
SURE_M = 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(arch, n_layers=2, overrides=None):
    return dataclasses.replace(reduced(get_config(arch), n_layers=n_layers),
                               **(overrides or {}))


def _ref_cfg(arch, n_layers=2, overrides=None, capacity_factor=None):
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch),
                                          n_layers=n_layers),
                              **(overrides or {}))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _prompts(vocab, lens):
    r = np.random.RandomState(11)
    return [r.randint(0, vocab, n).tolist() for n in lens]


RG_PROMPTS = _prompts(512, (20, 45, 70, 90))      # 70, 90 > the window 64
PAGED_PROMPTS = _prompts(512, (9, 21, 30, 40))


def _moe_case():
    r = np.random.RandomState(3)
    tree = ref_moe.init_moe(jax.random.PRNGKey(2),
                            _ref_cfg(MOE, capacity_factor=MOE_CF))
    d = reduced(get_config(MOE)).d_model
    return dict({k: np.asarray(tree[k]) for k in ("router", "wi", "wg",
                                                   "wo")},
                kind="moe_dp", mesh=(("data",), (4,)), arch=MOE,
                capacity_factor=MOE_CF,
                x=r.standard_normal((32, d)).astype(np.float32))


MOE_CASE = _moe_case()


@pytest.fixture(scope="module")
def weights():
    out = {job.arch: convert.to_reference(LM.init(job.cfg(), seed=5,
                                                  device="cpu"))
           for job in (RG_JOBS[0], MOE_JOBS[0])}
    for name, arch, _, ov in PAGED:
        out[name] = convert.to_reference(LM.init(_port_cfg(arch,
                                                           overrides=ov),
                                                 seed=5, device="cpu"))
    return out


def _run_group(weights, store):
    cases = {"moe_dp": MOE_CASE,
             "serve_rg": {"kind": "serve", "mesh": _axes(TWO_BY_TWO),
                          "arch": RG, "n_layers": RG_LAYERS,
                          "max_seq": RG_MAX_SEQ, "weights": weights[RG],
                          "prompts": RG_PROMPTS, "max_new": MAX_NEW}}
    # the dense mode's pow2-bucketed prefill: right padding masked
    # (``token_mask``) on each rank's channel pieces
    cases["serve_rg_dense"] = dict(cases["serve_rg"], engine="dense")
    for name, arch, mesh, ov in PAGED:
        cases[name] = {"kind": "serve", "engine": "paged",
                       "mesh": _axes(mesh), "arch": arch,
                       "weights": weights[name], "overrides": ov,
                       "prompts": PAGED_PROMPTS, "max_new": MAX_NEW}
    return rehearse.spawn(rehearse.four_ranks, 4, JOBS, weights, None, None,
                          1, cases, timeout=240, store_dir=store)


def _axes(mesh):
    return tuple(a for a, _ in mesh), tuple(n for _, n in mesh)


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_run_group, weights, store)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference(weights, launched):
    """arch -> (params, metrics, first moments) of the reference's jitted
    single-device step on the whole batch."""
    out = {}
    for job in (RG_JOBS[0], MOE_JOBS[0]):
        ref_cfg = _ref_cfg(job.arch, job.n_layers,
                           capacity_factor=job.capacity_factor)
        policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0)
        opt = ref_adamw.AdamWConfig(lr=LR, weight_decay=WD)
        jp = jax.tree.map(jnp.asarray, weights[job.arch])
        jb = {k: jnp.asarray(v) for k, v in job.batch_at(0).items()}
        state, m = jax.jit(ref_trainer.make_train_step(ref_cfg, policy, opt))(
            ref_trainer.TrainState(jp, ref_adamw.init(jp, opt)), jb)
        out[job.arch] = (_flat(state.params), m, _flat(state.opt.m))
    return out


@pytest.fixture(scope="module")
def runs(launched, reference):
    """The four ranks' results (``reference`` first: both run at once)."""
    return launched.result(timeout=300)


def _port_tree(job, params):
    model = LM(job.cfg(), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    return _flat(convert.to_reference(model))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def _mesh_id(job):
    return "x".join(str(n) for _, n in job.mesh)


@pytest.mark.parametrize("job", JOBS,
                         ids=lambda j: f"{j.arch}-{_mesh_id(j)}-zero{j.zero}")
def test_step_on_four_ranks_matches_the_reference_step(runs, reference,
                                                       weights, job):
    got = runs[0]["train"][JOBS.index(job)]
    p_ref, m_ref, mom_ref = reference[job.arch]
    m = got["metrics"][0]
    for key in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(m[key], float(m_ref[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert m["grad_norm"] > 1.0                          # the clip is active
    p_port, p_old = _port_tree(job, got["params"]), _flat(weights[job.arch])
    assert sorted(p_port) == sorted(p_ref)
    dims = _flat(convert.to_reference(
        LM(job.cfg(), device="cpu"),
        leaf=lambda p: torch.tensor(float(p.dim()))))
    for k in p_ref:
        want = p_ref[k]
        if p_ref[k].ndim >= 2 and np.all(dims[k] == 1):
            want = want + LR * WD * p_old[k]     # ROADMAP queue C
        sure = np.abs(mom_ref[k]) > SURE_M
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * LR + 1e-6), k


def test_steps_count_their_collectives(runs):
    """The RG-LRU steps reduce over ``model`` (the row-parallel
    ``out_proj``, the partial gradients of its gate leaves); the
    data-only MoE step gathers each rank's per-expert counts over
    ``data`` and never names ``model``."""
    for job, got in zip(JOBS, runs[0]["train"]):
        t = got["traffic"]
        if job in RG_JOBS:
            assert t["model/all_reduce"]["calls"] > 0, job
        else:
            assert not any(k.startswith("model") for k in t), job
            assert t["data/all_gather"]["calls"] > 0, job
            assert t["data/all_gather"]["ranks"] == 4


def test_moe_sorted_in_the_global_order_matches_the_whole_batch(runs):
    """``moe_sorted`` with the dp group on four ranks' rows against the
    reference's on the whole batch, at a capacity that drops tokens: the
    same y row by row, the same aux, and a per-rank order would differ."""
    case = MOE_CASE
    ref_cfg = _ref_cfg(MOE, capacity_factor=MOE_CF)
    params = {k: jnp.asarray(case[k]) for k in ("router", "wi", "wg", "wo")}
    y, aux = ref_moe.moe_sorted(params, jnp.asarray(case["x"]), ref_cfg,
                                compute_dtype=jnp.float32)
    y = np.asarray(y)
    n = y.shape[0] // 4
    local = np.concatenate([np.asarray(ref_moe.moe_sorted(
        params, jnp.asarray(case["x"][r * n:(r + 1) * n]), ref_cfg,
        compute_dtype=jnp.float32)[0]) for r in range(4)])
    assert np.abs(local - y).max() > 1e-3 * np.abs(y).max()
    got = [r["cases"]["moe_dp"] for r in runs]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], y[r * n:(r + 1) * n],
                                   atol=1e-5 * np.abs(y).max(), rtol=1e-5)
        np.testing.assert_allclose(g["aux"], float(aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_hybrid_streams_on_2x2_equal_the_reference_engine(runs, weights):
    """recurrentgemma's dense ``ServeEngine`` on ``(2, 2)``: the RG-LRU on
    its channel pieces, the ring caches' length over ``model``, prompts
    past the window; the streams are the reference's engine's."""
    cfg = _ref_cfg(RG, RG_LAYERS)
    eng = ref_engine.ServeEngine(
        cfg, jax.tree.map(jnp.asarray, weights[RG]),
        RefPolicy(compute_dtype="float32", attn_impl="xla"), n_slots=4,
        max_seq=RG_MAX_SEQ)
    reqs = [ref_engine.Request(i, jnp.asarray(p, jnp.int32), MAX_NEW)
            for i, p in enumerate(RG_PROMPTS)]
    for r in reqs:
        assert eng.add_request(r)
    while any(not r.done for r in reqs):
        eng.step()
    want = [list(r.out) for r in reqs]
    for r in runs:
        assert r["cases"]["serve_rg"] == want


def test_hybrid_dense_async_engine_on_2x2_serves_the_streams_without_a_mesh(
        runs, weights):
    """``AsyncServeEngine(mode="dense")`` for recurrentgemma on ``(2, 2)``:
    its bucketed prefill pads the prompts, and the RG-LRU pieces keep the
    masked-prefill rule (a = 1, no input on padded steps); the streams are
    the same engine's without a mesh (held to the reference in
    ``tests/test_torch_recurrent_serve.py``)."""
    want = rehearse.serve_streams(RG, weights[RG], RG_PROMPTS, MAX_NEW,
                                  engine="dense", n_layers=RG_LAYERS,
                                  max_seq=RG_MAX_SEQ)
    for r in runs:
        assert r["cases"]["serve_rg_dense"] == want


@pytest.mark.parametrize("name,arch,mesh,ov", PAGED,
                         ids=[p[0] for p in PAGED])
def test_paged_streams_equal_the_reference_paged_engine(runs, weights, name,
                                                        arch, mesh, ov):
    ticks = iter(range(1 << 62))
    eng = RefAsyncServeEngine(
        _ref_cfg(arch, overrides=ov), jax.tree.map(jnp.asarray,
                                                   weights[name]),
        RefPolicy(compute_dtype="float32", attn_impl="full"), n_slots=4,
        max_seq=64, page_size=16, prefill_chunk=16, mode="paged",
        clock=lambda: next(ticks) * 1e-3)
    reqs = [RefServeRequest(i, list(p), max_new=MAX_NEW)
            for i, p in enumerate(PAGED_PROMPTS)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    want = [list(r.out) for r in reqs]
    n = int(np.prod([s for _, s in mesh]))
    for rank, r in enumerate(runs):
        got = r["cases"][name]
        assert (got == want) if rank < n else got is None


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------
class _FakeAxis:
    """One rank of a ``tp``-rank model axis in one process: its gather
    returns a given whole tensor (checking this rank's piece of it), its
    split narrows to this rank's piece."""

    def __init__(self, tp, rank, whole):
        self.tp, self.tp_rank, self.whole = tp, rank, whole
        self.pctx = ParallelCtx(mesh=self)      # for ``cut``
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.zeros(1, tp)

    def get_local_rank(self, axis):
        return self.tp_rank if axis == "model" else 0

    def _piece(self, t, dim):
        n = t.shape[dim] // self.tp
        return t.narrow(dim, self.tp_rank * n, n)

    def cut(self, t, dim, full):
        return self.pctx.cut(t, dim, full)

    def gather(self, x, dim):
        assert torch.equal(x, self._piece(self.whole, dim))
        return self.whole

    def split(self, x, dim):
        return self._piece(x, dim)


@pytest.mark.parametrize("tp", [2, 4, 5, 16])
def test_rank_gates_equal_the_whole_gates_sliced(tp):
    """``rglru.rank_gates`` on each rank's channels: at ``tp`` = 2 and 4
    the pieces cover whole gate blocks (the leaves cut), at 5 and 16 they
    split one (W = 320, blocks of 40: the gathered path); every rank's
    gates equal the whole gates' slice at 1e-6."""
    cfg = reduced(get_config(RG))
    W = cfg.rglru.lru_width
    gen = torch.Generator().manual_seed(0)
    params = rglru.RGLRU(cfg, generator=gen)
    with torch.no_grad():
        for w in (params.ba, params.bx):
            w.copy_(torch.randn(w.shape, generator=gen) * 0.1)
    x = torch.randn(2, 7, W, generator=gen)
    want = rglru.rglru_gates(params, x, cfg.rglru.c)
    assert rglru.gate_blocks_split(tp) == (tp in (2, 4))
    n = W // tp
    for rank in range(tp):
        axis = _FakeAxis(tp, rank, x)
        got = rglru.rank_gates(params, x[..., rank * n:(rank + 1) * n],
                               cfg.rglru.c, axis, W)
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g.detach().numpy(), w[..., rank * n:(rank + 1) * n]
                .detach().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("model_n", [2, 4])
def test_recurrentgemma_cache_specs_equal_the_reference(model_n):
    """``cache_specs`` on the reference's stacked tree and
    ``stack_cache_specs`` on the port's per-layer caches equal the
    reference's specs, the ``(R, R)`` remainder (a segment that repeats
    once, whose batch entry the reference lays on the state's width)
    included; ``placed_cache_specs`` differs from them there only, where
    it lays the batch first and the channels over ``model``."""
    ref_cfg, cfg = ref_get_config(RG), get_config(RG)
    caches = jax.eval_shape(lambda: ref_transformer.init_stack_cache(
        ref_cfg, 8, 256))
    axes = {"data": 8 // model_n, "model": model_n}
    rp, pp = RefPolicy(), PolicyConfig()
    want = jax.tree.map(tuple, ref_policy.cache_specs(caches, rp, axes),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert pol.cache_specs(caches, pp, axes) == want
    port = transformer.init_stack_cache(cfg, 8, 256, device="meta")
    per_layer = pol.stack_cache_specs(cfg, port, pp, axes)
    placed = pol.placed_cache_specs(port, pp, axes)
    segs = transformer.plan_segments(cfg.pattern)
    assert segs[-1] == (("rglru", "rglru"), 1)
    layer = 0
    for si, (unit, k) in enumerate(segs):
        for _ in range(k):
            for slot in range(len(unit)):
                spec = want[f"seg{si}"][f"slot{slot}"]
                row = {n: s[1:] for n, s in spec.items()} if k > 1 else spec
                assert per_layer[layer] == row, (si, slot)
                if k > 1:
                    assert placed[layer] == row
                else:
                    assert placed[layer] == {"conv": ("data", None, "model"),
                                             "state": ("data", "model")}
                    assert row["state"] == (None, "data")
                layer += 1


def test_a_paged_engine_refuses_a_mesh_whose_dp_axes_exceed_one():
    """The reference runs one replicated program there; the port's paged
    engine used to accept such a mesh and ignore it."""

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(2, 1)

    cfg = reduced(get_config(LLAMA))
    model = LM.init(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AsyncServeEngine(cfg, model, PolicyConfig(compute_dtype="float32"),
                         mode="paged", mesh=Mesh(), graphs=False,
                         device="cpu")
