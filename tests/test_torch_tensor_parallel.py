"""Tensor and expert parallelism in four ``gloo`` processes on the CPU, held
against the reference: ``sharded_flash`` on ``(data, model) = (2, 2)`` and
on ``(1, 4)`` with H = 6 (padded to 8) against ``full_attention``;
``sharded_decode`` over full and ring caches (a new token's slot on each
rank) and where the cache's length does not split (None) against
``decode_attention``; ``ssd_sharded`` with the heads split and not against
``ssd_chunked``; ``_moe_ep`` with and without FSDP-split experts against
``moe_sorted`` on each data shard; TP and ZeRO-3 + TP train steps of
reduced llama3.2-3b, mamba2-780m (the plain SSD on the CPU) and
moonshot-v1-16b-a3b against the reference's jitted single-device step on
the whole batch; a reduced llama ``ServeEngine``'s greedy streams on
``(2, 2)`` against the reference's unsharded engine's.  In-process:
``cache_specs`` and ``logits_spec`` against the reference's, and the
one-rank departure.

One group of four processes runs every job and case
(``rehearse.four_ranks``), started from a thread while this process
computes the reference's side; each rank has a group timeout, the spawn a
join timeout.  The ranks import neither JAX nor the reference.

The reference's expert-parallel step takes each data shard's capacity and
the mean of the shards' load-balance terms (``repro/models/moe.py:229-
246``): on ``data`` = 2 that is its single-device step with
``grad_accum=2`` on the whole batch (a microbatch a shard, the loss the
microbatches' mean), which moonshot's jobs are held to.

Tolerances: attention 3e-5 (``tests/test_sharded.py``), decode 1e-5, SSD
2e-4, MoE 1e-5 (of the output's largest magnitude for its absolute part,
as ``tests/test_torch_moe.py`` scales: a random moonshot's MoE output is of
order 100, ROADMAP queue C); train steps those of
``tests/test_torch_parallel.py`` (loss and grad norm 1e-5 relative;
updated parameters 1e-6 where the
reference's |g| > 1e-6, else within 2 lr); greedy streams exactly.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.core import policy as ref_policy
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.serve import engine as ref_engine
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.core import policy as pol
from repro_torch.launch import rehearse
from repro_torch.launch.mesh import one_rank
from repro_torch.launch.rehearse import Job
from repro_torch.models import attention, moe, ssm
from repro_torch.models.lm import LM
from repro_torch.models.transformer import ParallelCtx
from repro_torch.train import sharding, trainer

LR, WD = 1e-3, 0.1
MESH = (("data", 2), ("model", 2))
ARCHS = ("llama3.2-3b", "mamba2-780m", "moonshot-v1-16b-a3b")
JOBS = [Job(arch=a, mesh=MESH, zero=z, lr=LR) for a in ARCHS for z in (0, 3)]
# the reference's expert-parallel step is its single-device step with a
# microbatch a data shard
ACCUM = {"moonshot-v1-16b-a3b": 2}
SERVE_ARCH = "llama3.2-3b"
MAX_NEW = 6
R = np.random.RandomState(0)


def _normal(*shape, scale=1.0):
    return (R.standard_normal(shape) * scale).astype(np.float32)


def _ring(cur, W):
    """Ring-slot positions after ``cur`` tokens (slot s: p = s mod W)."""
    pos = np.full((len(cur), W), -1, np.int32)
    for b, c in enumerate(cur):
        for p in range(max(0, c - W), c):
            pos[b, p % W] = p
    return pos


def _full(cur, W):
    pos = np.full((len(cur), W), -1, np.int32)
    for b, c in enumerate(cur):
        pos[b, :c] = np.arange(c)
    return pos


def _decode_case(mesh, W, cur, window, H=4, K=2, D=16):
    B = len(cur)
    return {"kind": "decode", "mesh": mesh, "window": window,
            "q": _normal(B, 1, H, D), "k_new": _normal(B, 1, K, D),
            "v_new": _normal(B, 1, K, D), "k": _normal(B, W, K, D),
            "v": _normal(B, W, K, D),
            "pos": (_ring if window else _full)(cur, W),
            "positions": np.asarray(cur, np.int32)[:, None]}


def _ssd_case(mesh, H, B=4, S=64, P=8, N=16):
    return {"kind": "ssd", "mesh": mesh, "chunk": 32,
            "x": _normal(B, S, H, P),
            "dt": np.log1p(np.exp(_normal(B, S, H))).astype(np.float32),
            "A": -np.exp(_normal(H)), "B": _normal(B, S, 1, N, scale=0.5),
            "C": _normal(B, S, 1, N, scale=0.5)}


TWO_BY_TWO, ONE_BY_FOUR = (("data", "model"), (2, 2)), (("data", "model"),
                                                          (1, 4))
MOE_ARCH = "moonshot-v1-16b-a3b"


def _moe_params():
    tree = ref_moe.init_moe(jax.random.PRNGKey(1),
                            ref_reduced(ref_get_config(MOE_ARCH)))
    return {k: np.asarray(tree[k]) for k in ("router", "wi", "wg", "wo")}


def _cases():
    d = reduced(get_config(MOE_ARCH)).d_model
    moe_in = dict(_moe_params(), x=_normal(32, d), arch=MOE_ARCH)
    return {
        "flash_2x2": {"kind": "flash", "mesh": TWO_BY_TWO,
                      "q": _normal(4, 64, 4, 32), "k": _normal(4, 64, 2, 32),
                      "v": _normal(4, 64, 2, 32)},
        "flash_1x4_h6": {"kind": "flash", "mesh": ONE_BY_FOUR,
                         "q": _normal(2, 64, 6, 32),
                         "k": _normal(2, 64, 3, 32),
                         "v": _normal(2, 64, 3, 32)},
        # W = 16 over 2: slots 0-7 and 8-15, a new token on each rank
        "decode_full": _decode_case(TWO_BY_TWO, 16, [3, 12, 9, 5], 0),
        # a ring of 8 (window 8): slots cur % 8 on both ranks
        "decode_ring": _decode_case(TWO_BY_TWO, 8, [10, 13, 4, 15], 8),
        "decode_w6_tp4": _decode_case(ONE_BY_FOUR, 6, [2, 5], 0),
        "decode_w4_tp4": _decode_case(ONE_BY_FOUR, 4, [2, 3], 0),
        "ssd_h4_tp2": _ssd_case(TWO_BY_TWO, 4),
        "ssd_h6_tp4": _ssd_case(ONE_BY_FOUR, 6),
        "moe_ep": dict(moe_in, kind="moe", mesh=TWO_BY_TWO, fsdp=False),
        "moe_ep_fsdp": dict(moe_in, kind="moe", mesh=TWO_BY_TWO, fsdp=True),
        # (pod, data) do not span the world: one group per model coset
        "group_pod_data": {"kind": "group", "axes": ("pod", "data"),
                           "mesh": (("pod", "data", "model"), (1, 2, 2))},
    }


CASES = _cases()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    r = np.random.RandomState(7)
    return [r.randint(0, vocab, 9 + 6 * i).tolist() for i in range(4)]


@pytest.fixture(scope="module")
def weights():
    return {a: convert.to_reference(LM.init(Job(arch=a).cfg(), seed=5,
                                            device="cpu")) for a in ARCHS}


def _run_group(weights, store):
    cases = dict(CASES)
    cases["serve"] = {"kind": "serve", "mesh": TWO_BY_TWO,
                      "arch": SERVE_ARCH, "weights": weights[SERVE_ARCH],
                      "prompts": _prompts(Job(arch=SERVE_ARCH).cfg()
                                          .vocab_size),
                      "max_new": MAX_NEW}
    cases["serve_dense"] = dict(cases["serve"], engine="dense")
    return rehearse.spawn(rehearse.four_ranks, 4, JOBS, weights, None, None,
                          1, cases, timeout=240, store_dir=store)


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
    single-device step on the whole batch (``ACCUM`` microbatches)."""
    out = {}
    for arch in ARCHS:
        job = Job(arch=arch, mesh=MESH, lr=LR)
        ref_cfg = ref_reduced(ref_get_config(arch))
        policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0,
                           grad_accum=ACCUM.get(arch, 1))
        opt = ref_adamw.AdamWConfig(lr=LR, weight_decay=WD)
        jp = jax.tree.map(jnp.asarray, weights[arch])
        jb = {k: jnp.asarray(v) for k, v in job.batch_at(0).items()}
        state, m = jax.jit(ref_trainer.make_train_step(ref_cfg, policy, opt))(
            ref_trainer.TrainState(jp, ref_adamw.init(jp, opt)), jb)
        out[arch] = (_flat(state.params), m, _flat(state.opt.m))
    return out


@pytest.fixture(scope="module")
def runs(launched, reference):
    """The four ranks' results (``reference`` first: both run at once)."""
    return launched.result(timeout=300)


def _cases_of(runs, name):
    return [r["cases"][name] for r in runs]


def _coords(shape):
    """Each rank's (data, model) coordinate on a row-major mesh."""
    return [divmod(r, shape[1]) for r in range(shape[0] * shape[1])]


def _rows(a, shape, data):
    n = a.shape[0] // shape[0]
    return a[data * n:(data + 1) * n]


# ---------------------------------------------------------------------------
# the paths, case by case
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["flash_2x2", "flash_1x4_h6"])
def test_sharded_flash_matches_full_attention(runs, name):
    case = CASES[name]
    want = np.asarray(ref_attention.full_attention(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v")), causal=True))
    shape = case["mesh"][1]
    for (data, _), got in zip(_coords(shape), _cases_of(runs, name)):
        np.testing.assert_allclose(got, _rows(want, shape, data),
                                   atol=3e-5, rtol=3e-5)


def _ref_decode(case):
    """The reference's dense decode step: the new token written at its
    slot (ring: ``cur % W``), then ``decode_attention``."""
    W = case["k"].shape[1]
    cur = case["positions"][:, 0]
    slot = cur % W if case["window"] else cur
    b = np.arange(len(cur))
    k, v, pos = case["k"].copy(), case["v"].copy(), case["pos"].copy()
    k[b, slot], v[b, slot], pos[b, slot] = (case["k_new"][:, 0],
                                            case["v_new"][:, 0], cur)
    out = ref_attention.decode_attention(
        jnp.asarray(case["q"]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos), window=case["window"])
    return np.asarray(out), k, v, pos


@pytest.mark.parametrize("name", ["decode_full", "decode_ring"])
def test_sharded_decode_matches_decode_attention(runs, name):
    case = CASES[name]
    want, k, v, pos = _ref_decode(case)
    shape = case["mesh"][1]
    W = k.shape[1]
    n = W // shape[1]
    owners = set()
    for (data, model), got in zip(_coords(shape), _cases_of(runs, name)):
        np.testing.assert_allclose(got["out"], _rows(want, shape, data),
                                   atol=1e-5, rtol=1e-5)
        sl = slice(model * n, (model + 1) * n)
        for got_t, want_t in ((got["k"], k), (got["v"], v),
                              (got["pos"], pos)):
            np.testing.assert_array_equal(got_t,
                                          _rows(want_t, shape, data)[:, sl])
        cur = _rows(case["positions"], shape, data)[:, 0]
        slots = cur % W if case["window"] else cur
        owners |= {int(s) // n for s in slots}
    assert owners == set(range(shape[1]))       # each rank wrote a token


@pytest.mark.parametrize("name", ["decode_w6_tp4", "decode_w4_tp4"])
def test_sharded_decode_declines_where_the_cache_does_not_split(runs, name):
    """W % tp or W < 2 tp: None (the caller's dense path), the reference's
    conditions, on every rank."""
    assert all(got is None for got in _cases_of(runs, name))
    W, tp = CASES[name]["k"].shape[1], CASES[name]["mesh"][1][1]
    assert not attention.cache_w_split(W, tp)


@pytest.mark.parametrize("name", ["ssd_h4_tp2", "ssd_h6_tp4"])
def test_ssd_sharded_matches_ssd_chunked(runs, name):
    case = CASES[name]
    y, h = ref_ssm.ssd_chunked(*(jnp.asarray(case[n]) for n in (
        "x", "dt", "A", "B", "C")), chunk=case["chunk"])
    shape = case["mesh"][1]
    for (data, _), got in zip(_coords(shape), _cases_of(runs, name)):
        np.testing.assert_allclose(got["y"], _rows(np.asarray(y), shape,
                                                   data), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(got["h"], _rows(np.asarray(h), shape,
                                                   data), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("name", ["moe_ep", "moe_ep_fsdp"])
def test_moe_ep_matches_moe_sorted_on_each_data_shard(runs, name):
    case = CASES[name]
    ref_cfg = ref_reduced(ref_get_config(MOE_ARCH))
    params = {k: jnp.asarray(case[k]) for k in ("router", "wi", "wg", "wo")}
    shape = case["mesh"][1]
    auxes = []
    want_y = []
    for data in range(shape[0]):
        y, aux = ref_moe.moe_sorted(params, jnp.asarray(_rows(
            case["x"], shape, data)), ref_cfg, compute_dtype=jnp.float32)
        want_y.append(np.asarray(y))
        auxes.append(float(aux))
    for (data, _), got in zip(_coords(shape), _cases_of(runs, name)):
        np.testing.assert_allclose(got["y"], want_y[data],
                                   atol=1e-5 * np.abs(want_y[data]).max(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["aux"], np.mean(auxes), rtol=1e-5)


def test_a_group_over_axes_that_do_not_span_the_world(runs):
    """``hierarchy.axis_group`` over (pod, data) of a (1, 2, 2) mesh: each
    rank sums with the rank of its own ``model`` coordinate only."""
    got = _cases_of(runs, "group_pod_data")
    for rank, g in enumerate(got):
        model = g["coord"][2]
        assert g["size"] == 2
        assert g["sum"] == sum(r for r, h in enumerate(got)
                               if h["coord"][2] == model)
        assert rank % 2 == model


def test_constrain_is_this_ranks_piece():
    """``policy.constrain``: the whole tensor without a mesh or a spec,
    this rank's piece under ``spec`` with one (ROADMAP, the decision)."""

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(2, 2)

        def get_local_rank(self, axis):
            return {"data": 1, "model": 0}[axis]

    x = torch.arange(8.0).reshape(4, 2)
    assert pol.constrain(x, None) is x and pol.constrain(x, ("data",)) is x
    np.testing.assert_array_equal(
        pol.constrain(x, ("data", "model"), Mesh()).numpy(), [[4.0], [6.0]])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def _port_tree(job, params):
    model = LM(job.cfg(), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    return _flat(convert.to_reference(model))


@pytest.mark.parametrize("job", JOBS, ids=lambda j: f"{j.arch}-zero{j.zero}")
def test_tp_step_on_four_ranks_matches_the_reference_step(runs, reference,
                                                          weights, job):
    got = runs[0]["train"][JOBS.index(job)]
    p_ref, m_ref, mom_ref = reference[job.arch]
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(m_ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(m_ref["grad_norm"]),
                               rtol=1e-5)
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
        sure = np.abs(mom_ref[k]) > 1e-7 / float(m_ref["grad_norm"])
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * LR + 1e-6), k


def test_tp_steps_count_their_model_axis_collectives(runs):
    """Every TP step moves activations over ``model``; ZeRO-3's gathers
    and reduce-scatters stay on ``data``; MoE's aux is averaged over both
    axes at once."""
    for job, got in zip(JOBS, runs[0]["train"]):
        t = got["traffic"]
        assert t["model/all_reduce"]["calls"] > 0, job
        assert t["model/all_reduce"]["ranks"] == 2
        if job.zero == 3:
            assert t["data/all_gather"]["calls"] > 0
            assert t["data/reduce_scatter"]["calls"] > 0
        if job.arch == MOE_ARCH:
            assert t["data+model/all_reduce"]["ranks"] == 4


def test_greedy_streams_on_2x2_equal_the_reference_engine(runs, weights):
    cfg = ref_reduced(ref_get_config(SERVE_ARCH))
    prompts = _prompts(cfg.vocab_size)
    eng = ref_engine.ServeEngine(
        cfg, jax.tree.map(jnp.asarray, weights[SERVE_ARCH]),
        RefPolicy(compute_dtype="float32", attn_impl="xla"), n_slots=4,
        max_seq=64)
    reqs = [ref_engine.Request(i, jnp.asarray(p, jnp.int32), MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.add_request(r)
    while any(not r.done for r in reqs):
        eng.step()
    want = [list(r.out) for r in reqs]
    for got in _cases_of(runs, "serve"):
        assert got == want


def test_dense_async_engine_on_2x2_serves_the_streams_without_a_mesh(
        runs, weights):
    """``AsyncServeEngine(mode="dense")`` on ``(2, 2)`` (slots over ``data``,
    the cache's length over ``model``): its streams are the same engine's
    without a mesh (held to the reference in
    ``tests/test_torch_recurrent_serve.py``)."""
    want = rehearse.serve_streams(SERVE_ARCH, weights[SERVE_ARCH],
                                  _prompts(Job(arch=SERVE_ARCH).cfg()
                                           .vocab_size), MAX_NEW,
                                  engine="dense")
    for got in _cases_of(runs, "serve_dense"):
        assert got == want


# ---------------------------------------------------------------------------
# in-process: the specs and the one-rank departure
# ---------------------------------------------------------------------------
SPEC_ARCHS = ("llama3.2-3b", "qwen2-0.5b", "mamba2-780m", MOE_ARCH)


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_cache_and_logits_specs_equal_the_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    caches = jax.eval_shape(lambda: ref_transformer.init_stack_cache(
        ref_cfg, 8, 256))
    port_caches = [dict(layer) for layer in transformer_caches(cfg)]
    for model_n in (1, 2, 4):
        axes = {"data": 8 // model_n if model_n < 8 else 1,
                "model": model_n}
        rp, pp = RefPolicy(), PolicyConfig()
        want = jax.tree.map(tuple, ref_policy.cache_specs(caches, rp, axes),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
        got = pol.cache_specs(caches, pp, axes)
        assert got == want, (arch, axes)
        # the port's per-layer caches: the same specs, stack entry dropped
        per_layer = pol.stack_cache_specs(cfg, port_caches, pp, axes)
        stacked = want["seg0"]["slot0"]
        for row in per_layer:
            assert row == {n: s[1:] for n, s in stacked.items()}
        for batch in (1, 2, 8, 16):
            assert pol.logits_spec(pp, axes, batch) == tuple(
                ref_policy.logits_spec(rp, axes, batch))


def transformer_caches(cfg):
    from repro_torch.models import transformer
    return transformer.init_stack_cache(cfg, 8, 256, device="meta")


def test_a_one_rank_mesh_runs_the_tensor_and_expert_parallel_paths():
    """The departure (ROADMAP): a mesh whose tp axis has size 1 takes the
    tensor- and expert-parallel paths, where the reference's rule leaves
    them at size 2: the specs name the axis (``tp_min=1``), MoE takes
    ``"ep"``, ``sharded_decode`` partial-and-combines, every *copy* and
    *reduce* runs on the one-rank group, and the step equals the no-mesh
    step."""
    cfg = reduced(get_config(MOE_ARCH))
    policy = PolicyConfig(compute_dtype="float32", zero_stage=0,
                          attn_impl="kernel")
    axes = {"data": 1, "model": 1}
    meta = LM(cfg, device="meta")
    assert not any("model" in sharding.spec_axes(s) for s in
                   pol.param_specs(meta, cfg, policy, axes).values())
    ps, _ = sharding.specs(meta, cfg, policy, axes)
    assert ps["stack.blocks.0.moe.wi"] == ("model", None, None)
    assert pol.cache_spec("seg0/slot0/k", (2, 8, 64, 4, 16), policy, axes,
                          tp_min=1)[2] == "model"

    class RefMesh:                    # the reference's rule reads .shape
        shape = axes
    assert ref_trainer.make_run_ctx(ref_reduced(ref_get_config(MOE_ARCH)),
                                    RefPolicy(), RefMesh()).moe_impl == \
        "sorted"
    with one_rank(device="cpu") as mesh:
        ctx = trainer.make_run_ctx(cfg, policy, mesh)
        assert ctx.moe_impl == "ep" and ctx.pctx.tp_on and ctx.pctx.tp == 1
        pctx = ParallelCtx(mesh=mesh)
        case = CASES["decode_full"]
        cache = {n: torch.from_numpy(case[n].copy()) for n in ("k", "v",
                                                               "pos")}
        out, _ = attention.sharded_decode(
            *(torch.from_numpy(case[n]) for n in ("q", "k_new", "v_new")),
            cache, torch.from_numpy(case["positions"]), pctx=pctx, W=16)
        np.testing.assert_allclose(out.numpy(), _ref_decode(case)[0],
                                   atol=1e-5, rtol=1e-5)
        assert pctx.traffic.report()["model/all_reduce"]["calls"] == 3
        state = trainer.init_state(cfg, policy, seed=0, device="cpu",
                                   mesh=mesh)
        plain = trainer.init_state(cfg, policy, seed=0, device="cpu")
        step = trainer.make_train_step(cfg, policy, mesh=mesh)
        batch = Job(arch=MOE_ARCH).batch_at(0)
        _, got = step(state, batch)
        _, want = trainer.make_train_step(cfg, policy)(plain, batch)
        traffic = step.traffic.report()
    assert float(got["loss"]) == float(want["loss"])
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-6)
    assert traffic["model/all_reduce"]["calls"] > 0
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), dict(
            plain.model.named_parameters())[n].detach().numpy(), atol=1e-6,
            err_msg=n)


def test_tp_cut_pads_heads_and_keeps_pieces():
    """``ParallelCtx.cut``: a whole leaf is zero-padded to a multiple of
    the axis and cut; a piece passes; anything else raises."""

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(1, 4)

        def get_local_rank(self, axis):
            return 3

    pctx = ParallelCtx(mesh=Mesh())
    w = torch.arange(6.0)
    np.testing.assert_array_equal(pctx.cut(w, 0, 6).numpy(), [0.0, 0.0])
    assert pctx.cut(torch.ones(2), 0, 8).shape == (2,)
    with pytest.raises(ValueError, match="neither"):
        pctx.cut(torch.ones(3), 0, 8)
    assert ssm._cache_tp_dim((2, 3, 384), 4) == 2
    assert moe.default_capacity(128, 8, 2, 1.25) == 40
