"""Port vs reference: the MoE FFN (``repro_torch/models/moe.py`` against
``repro/models/moe.py``) and the two MoE archs through the LM, the train
step and the serving engine.

The same numpy inputs (made from a seed) go through the JAX function and its
port, everything on the CPU in fp32 at reduced widths.  Tolerances: the
module's outputs 2e-5 (the reference's own MoE tolerance,
``tests/test_models.py``, where the outputs are of order 1; here the
experts' fan-in init over the expert axis makes them of order 100, so the
2e-5 is taken of the output's max-abs, ``close``), its gradients against ``jax.grad`` 5e-4 of each
leaf's max-abs, the LM's logits 2e-4 (``tests/test_torch_models.py``), the
train step's loss and gradients 1e-5 (``tests/test_torch_train.py``), and
greedy streams token for token.

The reference's own MoE test runs at ``capacity_factor=8``, where nothing
drops; here the drop path is held to the reference's ``moe_sorted`` with
drops that happen, and each such test asserts that they did.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.optim import adamw as ref_adamw
from repro.serve import AsyncServeEngine as RefAsyncServeEngine
from repro.serve import ServeRequest as RefServeRequest
from repro.train import trainer as ref_trainer
from repro.train.trainer import make_run_ctx as ref_make_run_ctx

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models import moe
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.serve import AsyncServeEngine, ServeRequest
from repro_torch.train import trainer
from repro_torch.train.trainer import make_run_ctx

MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]
F32 = jnp.float32
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread: these models are small, and beside the
    other test workers' threads PyTorch's parallel regions stalled each
    test 10-30 times over (as in ``tests/test_torch_vision.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=2e-5, err_msg=""):
    """|got - want| <= tol * (max|want| + |want|), elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                               rtol=tol, err_msg=err_msg)


def _cfgs(arch):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


def _redraw(r, a):
    """``mean(a) + randn * (std(a) or 0.1)``: a leaf redrawn by numpy, with
    its init spread (norm scales move off 1)."""
    a = np.asarray(a)
    std = float(a.std()) or 0.1
    return (float(a.mean()) + r.standard_normal(a.shape) * std).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def numpy_params(arch, seed=0):
    """The reduced arch's parameter tree in the reference's layout (the
    port's init, laid out as ``init_lm`` lays it: the same leaves and
    spreads), every leaf redrawn by numpy.  Shared between tests: read
    only."""
    r = np.random.RandomState(seed)
    tree = convert.to_reference(LM(_cfgs(arch)[1]))
    return jax.tree.map(lambda a: _redraw(r, a), tree)


def _layer(arch, seed=0):
    """(ref cfg, an MoE layer's leaves as a dict of jnp arrays, cfg, the
    port's ``MoE`` holding the same values)."""
    ref_cfg, cfg = _cfgs(arch)
    mod = moe.MoE(cfg)
    r = np.random.RandomState(seed)
    rp: dict = {}
    with torch.no_grad():
        for name, p in mod.named_parameters():
            a = _redraw(r, p.numpy())
            p.copy_(torch.from_numpy(a))
            node, *path, leaf = [rp] + name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(a)
    return ref_cfg, rp, cfg, mod


def _x(T, d, seed=1):
    """Hidden states with a direction that all tokens share, as a model's
    have: the router then loads some experts past the mean, and the
    default capacity drops assignments."""
    r = np.random.RandomState(seed)
    return (r.standard_normal((T, d)) + r.standard_normal(d)).astype(
        np.float32)


def _drops(idx, E, C):
    """Assignments past capacity C: what the sorted path drops."""
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=E)
    return int(np.maximum(counts - C, 0).sum())


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference(arch):
    ref_cfg, rp, cfg, mod = _layer(arch)
    x = _x(64, cfg.d_model)
    wg, wi, waux = jax.jit(ref_moe.route, static_argnums=2)(
        jnp.asarray(x), rp["router"], cfg.moe.top_k)
    g, i, aux = moe.route(torch.from_numpy(x), mod.router, cfg.moe.top_k)
    assert np.array_equal(i.numpy(), np.asarray(wi))
    close(g, wg)
    np.testing.assert_allclose(aux.item(), float(waux), **TOL)
    assert g.dtype == torch.float32 and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dense_oracle_and_apply_moe_with_shared_experts(arch):
    ref_cfg, rp, cfg, mod = _layer(arch)
    x = _x(2 * 24, cfg.d_model, seed=2)
    want, waux = jax.jit(lambda p, xx: ref_moe.moe_dense(
        p, xx, ref_cfg, F32))(rp, jnp.asarray(x))
    got, aux = moe.moe_dense(mod, torch.from_numpy(x), cfg, torch.float32)
    close(got, want)
    np.testing.assert_allclose(aux.item(), float(waux), **TOL)
    x3 = x.reshape(2, 24, cfg.d_model)
    assert cfg.moe.n_shared_experts
    for impl in ("dense", "sorted"):
        want, waux = jax.jit(lambda p, xx: ref_moe.apply_moe(
            p, xx, ref_cfg, compute_dtype=F32, impl=impl))(
            rp, jnp.asarray(x3))
        got, aux = moe.apply_moe(mod, torch.from_numpy(x3), cfg,
                                 compute_dtype=torch.float32, impl=impl)
        assert got.shape == x3.shape
        close(got, want)
        np.testing.assert_allclose(aux.item(), float(waux), **TOL)


@pytest.mark.parametrize("arch,T,capacity", [
    ("moonshot-v1-16b-a3b", 96, None), ("moonshot-v1-16b-a3b", 96, 9),
    ("llama4-scout-17b-a16e", 96, None), ("llama4-scout-17b-a16e", 96, 11)])
def test_sorted_matches_reference_and_drops_past_capacity(arch, T, capacity):
    """At the default capacity (1.25 x the mean load) and at a smaller one,
    both past the busiest experts' loads: assignments are dropped (asserted)
    and the port drops the same ones."""
    ref_cfg, rp, cfg, mod = _layer(arch)
    m = cfg.moe
    x = _x(T, cfg.d_model, seed=3)
    C = capacity or moe.default_capacity(T, m.n_experts, m.top_k,
                                         m.capacity_factor)
    assert C == ref_moe.default_capacity(T, m.n_experts, m.top_k,
                                         m.capacity_factor) or capacity
    _, idx, _ = jax.jit(ref_moe.route, static_argnums=2)(
        jnp.asarray(x), rp["router"], m.top_k)
    assert _drops(idx, m.n_experts, C) > 0
    want, waux = jax.jit(lambda p, xx: ref_moe.moe_sorted(
        p, xx, ref_cfg, compute_dtype=F32, capacity=capacity))(
        rp, jnp.asarray(x))
    got, aux = moe.moe_sorted(mod, torch.from_numpy(x), cfg,
                              compute_dtype=torch.float32, capacity=capacity)
    close(got, want)
    np.testing.assert_allclose(aux.item(), float(waux), **TOL)
    # a capacity past every load drops nothing: the sorted path is the
    # dense oracle then
    full, _ = moe.moe_sorted(mod, torch.from_numpy(x), cfg,
                             compute_dtype=torch.float32, capacity=T)
    dense, _ = moe.moe_dense(mod, torch.from_numpy(x), cfg, torch.float32)
    close(full, dense.detach().numpy())
    assert not np.allclose(got.detach().numpy(), full.detach().numpy(),
                           atol=1e-3 * np.abs(full.detach().numpy()).max())


@pytest.mark.parametrize("sliced_weights", [False, True],
                         ids=["all-weights", "slice-weights"])
def test_expert_slices_sum_to_the_whole(sliced_weights):
    """``expert_slice`` (the EP path's per-rank call) against the
    reference's, and the slices' outputs summed against the whole, with
    drops (capacity 8 of 96 tokens)."""
    ref_cfg, rp, cfg, mod = _layer("moonshot-v1-16b-a3b")
    x = _x(96, cfg.d_model, seed=4)
    E, C = cfg.moe.n_experts, 8
    whole, _ = moe.moe_sorted(mod, torch.from_numpy(x), cfg,
                              compute_dtype=torch.float32, capacity=C)
    total = torch.zeros_like(whole)
    for e0 in range(0, E, E // 4):
        sl = (e0, E // 4)
        rps, mods = rp, mod
        if sliced_weights:
            rps = dict(rp, **{k: rp[k][e0:e0 + E // 4]
                              for k in ("wi", "wg", "wo")})
            mods = moe.MoE(cfg, device="cpu")
            mods.load_state_dict(mod.state_dict())
            for k in ("wi", "wg", "wo"):
                setattr(mods, k, torch.nn.Parameter(
                    getattr(mod, k).detach()[e0:e0 + E // 4].clone()))
        want, _ = jax.jit(lambda p, xx: ref_moe.moe_sorted(
            p, xx, ref_cfg, compute_dtype=F32, capacity=C,
            expert_slice=sl))(rps, jnp.asarray(x))
        got, _ = moe.moe_sorted(mods, torch.from_numpy(x), cfg,
                                compute_dtype=torch.float32, capacity=C,
                                expert_slice=sl)
        close(got, want)
        total += got.detach()
    close(total, whole.detach().numpy())


@pytest.mark.parametrize("arch,capacity", [
    ("moonshot-v1-16b-a3b", None), ("moonshot-v1-16b-a3b", 9),
    ("llama4-scout-17b-a16e", 11)])
def test_sorted_gradients_match_jax_grad(arch, capacity):
    """The input's and every parameter's gradient (router, wi, wg, wo) of a
    weighted sum of ``moe_sorted``'s output plus its aux, against
    ``jax.grad``: 5e-4 of each leaf's max-abs.

    With ``top_k == 1`` (scout) the renormalised gate is p / p = 1: in exact
    arithmetic no gradient reaches the router through it, and each side
    returns its own fp32 rounding residue there (ulps of dL/dgate / p, of
    the size of the true gradients).  The router's gradient is then held
    on the aux term alone, which is where its gradient comes from."""
    ref_cfg, rp, cfg, mod = _layer(arch)
    T = 96
    x = _x(T, cfg.d_model, seed=5)
    w = _x(T, cfg.d_model, seed=6)
    gated = cfg.moe.top_k > 1

    def f(p, xx, y_weight=1.0):
        y, aux = ref_moe.moe_sorted(p, xx, ref_cfg, compute_dtype=F32,
                                    capacity=capacity)
        return y_weight * jnp.sum(y * w) + 3.0 * aux

    def g(xx, y_weight=1.0):
        y, aux = moe.moe_sorted(mod, xx, cfg, compute_dtype=torch.float32,
                                capacity=capacity)
        mod.zero_grad()
        (y_weight * torch.sum(y * torch.from_numpy(w)) + 3.0 * aux
         ).backward()

    names = ("router", "wi", "wg", "wo")
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {n: rp[n] for n in names}, jnp.asarray(x))
    want = {n: np.asarray(gp[n]) for n in names}
    want["x"] = np.asarray(gx)
    tx = torch.from_numpy(x).requires_grad_()
    g(tx)
    got = {n: getattr(mod, n).grad.numpy().copy() for n in names}
    got["x"] = tx.grad.numpy()
    if not gated:
        want["router"] = np.asarray(jax.jit(jax.grad(f))(
            {n: rp[n] for n in names}, jnp.asarray(x), 0.0)["router"])
        g(torch.from_numpy(x), 0.0)
        got["router"] = mod.router.grad.numpy()
    for n, v in want.items():
        scale = np.abs(v).max()
        assert scale > 0, n
        np.testing.assert_allclose(got[n], v, atol=5e-4 * scale, rtol=0,
                                   err_msg=n)


def test_router_stays_fp32_in_a_bf16_model_and_through_casts():
    """``LM.init(dtype=bf16)`` and ``LM.cast_weights_``, the port's one cast
    of a model, keep the router fp32 (``MoE.FP32_LEAVES``)."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    model = LM.init(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    blk = model.stack.blocks[0]
    assert blk.moe.router.dtype == torch.float32
    assert blk.moe.wi.dtype == blk.moe.shared.wo.dtype == torch.bfloat16
    model32 = LM.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    before = model32.stack.blocks[1].moe.router.detach().clone()
    model32.cast_weights_(torch.bfloat16)
    assert model32.stack.blocks[1].moe.wo.dtype == torch.bfloat16
    assert torch.equal(model32.stack.blocks[1].moe.router, before)
    assert model32.stack.blocks[1].moe.router.dtype == torch.float32


def test_expert_init_spread_follows_the_reference():
    """The reference draws ``wi`` / ``wg`` / ``wo`` (E, d, f) with
    ``dense_init``'s fan-in taken from the leading axis, the expert count:
    std ~ 1 / sqrt(E) (0.88 of it under the +-2 sigma truncation), not
    1 / sqrt(d) (ROADMAP queue C).  The port draws them alike, so its
    random-weight runs on the card see the same scale."""
    ref_cfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    want = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg)
    got = moe.MoE(cfg, generator=torch.Generator().manual_seed(0))
    E = cfg.moe.n_experts
    for n in ("router", "wi", "wg", "wo"):
        ref_std = float(np.asarray(want[n]).std())
        np.testing.assert_allclose(getattr(got, n).std().item(), ref_std,
                                   rtol=0.05, err_msg=n)
    np.testing.assert_allclose(got.wi.std().item(), 0.88 / np.sqrt(E),
                               rtol=0.05)
    np.testing.assert_allclose(got.router.std().item(),
                               0.88 / np.sqrt(cfg.d_model), rtol=0.05)


def test_ep_raises_naming_the_roadmap_and_unknown_impls_are_refused():
    """``impl="ep"`` is expert parallelism over a mesh's tp axis: without a
    ``ParallelCtx`` it raises; on a one-rank ``(data, model)`` mesh it is
    the sorted path (one rank holds every expert); unknown impls are
    refused."""
    from repro_torch.launch.mesh import one_rank
    from repro_torch.models.transformer import ParallelCtx
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    mod = moe.MoE(cfg, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    with pytest.raises(ValueError, match="ParallelCtx"):
        moe.apply_moe(mod, x, cfg, impl="ep")
    want, want_aux = moe.apply_moe(mod, x, cfg, compute_dtype=torch.float32)
    with one_rank(device="cpu") as mesh:
        got, aux = moe.apply_moe(mod, x, cfg, compute_dtype=torch.float32,
                                 impl="ep", pctx=ParallelCtx(mesh=mesh))
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    with pytest.raises(ValueError, match="MoE impl"):
        moe.apply_moe(mod, x, cfg, impl="einsum")


# ---------------------------------------------------------------------------
# the LM and one train step
# ---------------------------------------------------------------------------
REF_FULL = RefPolicy(compute_dtype="float32", remat="none", attn_impl="full")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_forward_logits_and_aux_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    params = numpy_params(arch, seed=7)
    model = convert.from_reference(params, cfg, device="cpu")
    toks = np.random.RandomState(8).randint(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    ctx = ref_make_run_ctx(ref_cfg, REF_FULL, None)
    want, _, waux = jax.jit(lambda p, t: ref_lm.forward(p, t, ref_cfg, ctx))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel")
    with torch.no_grad():
        got, _, aux = model(torch.from_numpy(toks),
                            make_run_ctx(cfg, policy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_the_reference_jitted_step(arch):
    """fp32, remat per block, from the same weights and batch (2 x 64
    tokens: the sorted path drops there, asserted through the first
    layer's routes), the reference's jitted ``make_train_step`` against the
    port's: loss, aux and grad norm 1e-5 relative; every gradient within
    1e-5 of its leaf's max-abs, the reference's read off its first moments
    (after one step m = (1 - b1) c g, c the clip factor); the updated
    parameters as ``tests/test_torch_train.py`` holds them: 1e-6 wherever
    the gradient's tolerance bounds the first AdamW step's move within 5e-7
    (see below), 2 lr everywhere."""
    ref_cfg, cfg = _cfgs(arch)
    params = numpy_params(arch, seed=9)
    shape = ShapeConfig("t", 64, 2, "train")
    batch = make_batch(cfg, shape, step=1)
    lr, wd, b1 = 1e-3, 0.1, 0.9
    ref_policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0)
    ref_opt = ref_adamw.AdamWConfig(lr=lr, weight_decay=wd, b1=b1)
    jp = jax.tree.map(jnp.asarray, params)
    wstate, wm = jax.jit(ref_trainer.make_train_step(
        ref_cfg, ref_policy, ref_opt))(
        ref_trainer.TrainState(jp, ref_adamw.init(jp, ref_opt)),
        {k: jnp.asarray(v) for k, v in batch.items()})

    model = convert.from_reference(params, cfg, device="cpu")
    policy = PolicyConfig(compute_dtype="float32", remat="block",
                          attn_impl="kernel", zero_stage=0)
    m, blk = cfg.moe, model.stack.blocks[0]
    with torch.no_grad():
        x0 = model.embed_inputs(torch.from_numpy(batch["inputs"]),
                                make_run_ctx(cfg, policy), None)
        _, idx, _ = moe.route(blk.norm1(x0).reshape(-1, cfg.d_model),
                              blk.moe.router, m.top_k)
    C = moe.default_capacity(shape.tokens, m.n_experts, m.top_k,
                             m.capacity_factor)
    assert _drops(idx.numpy(), m.n_experts, C) > 0
    opt = AdamWConfig(lr=lr, weight_decay=wd, b1=b1)
    state = trainer.TrainState.create(model, policy, opt)
    state, met = trainer.make_train_step(cfg, policy, opt)(state, batch)

    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(wm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(met["aux"]) > 0
    c, eps = min(1.0, 1.0 / float(wm["grad_norm"])), 1e-8   # clip factor
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    g_port = flat(convert.to_reference(model, leaf=lambda p: p.grad))
    g_ref = {k: v / ((1 - b1) * c) for k, v in flat(wstate.opt.m).items()}
    p_port, p_ref = flat(convert.to_reference(model)), flat(wstate.params)
    p_old = flat(params)
    assert sorted(g_port) == sorted(g_ref) == sorted(p_ref)
    assert any("router" in k for k in g_ref)
    for k in g_ref:
        scale = np.abs(g_ref[k]).max()
        np.testing.assert_allclose(g_port[k], g_ref[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
        want = p_ref[k]
        if "norm" in k and "stack" in k:      # stacked 1-D leaves
            want = want + lr * wd * p_old[k]
        # the first step moves a parameter by lr c g / (c |g| + eps): a
        # gradient known to within tol moves it by up to lr eps c tol /
        # (c (|g| - tol) + eps)^2; 1e-6 is asserted where that is <= 5e-7
        tol = 1e-5 * scale
        gap = c * np.maximum(np.abs(g_ref[k]) - tol, 0.0) + eps
        sure = lr * eps * c * tol / gap ** 2 <= 5e-7
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * lr + 1e-6), k


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
ENGINE_KW = dict(n_slots=4, max_seq=96, page_size=8, prefill_chunk=16)


class FixedClock:
    """Injected clock: advances 1 ms per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


class _Drops:
    """Wraps ``moe.route`` to count the assignments the sorted path drops
    (past ``default_capacity`` of each call's token count)."""

    def __init__(self, cfg):
        self.m, self.n = cfg.moe, 0

    def __call__(self, x2d, router_w, top_k, dp_group=None):
        assert dp_group is None     # the capacity below is one call's
        out = _ROUTE(x2d, router_w, top_k)
        m = self.m
        C = moe.default_capacity(x2d.shape[0], m.n_experts, top_k,
                                 m.capacity_factor)
        self.n += _drops(out[1].numpy(), m.n_experts, C)
        return out


_ROUTE = moe.route


def _serve(eng, prompts, cls, max_new):
    reqs = [cls(i, list(p), max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("kw", [dict(mode="paged", fused=True),
                                dict(mode="dense")],
                         ids=["paged", "dense"])
def test_greedy_streams_identical_to_reference(kw, monkeypatch):
    """Reduced moonshot, 3 prompts padded to 4 rows, through the port's
    ``AsyncServeEngine`` (its step graphs' CPU path) and the reference's:
    identical streams, with assignments dropped in the port's steps."""
    arch = "moonshot-v1-16b-a3b"
    ref_cfg, cfg = _cfgs(arch)
    params = numpy_params(arch, seed=11)
    prompts = [[int(t) for t in np.random.RandomState(40 + i).randint(
        0, cfg.vocab_size, n)] for i, n in enumerate((21, 34, 45))]
    ref = RefAsyncServeEngine(ref_cfg, jax.tree.map(jnp.asarray, params),
                              REF_FULL, clock=FixedClock(), **ENGINE_KW, **kw)
    want = _serve(ref, prompts, RefServeRequest, max_new=6)
    drops = _Drops(cfg)
    monkeypatch.setattr(moe, "route", drops)
    model = convert.from_reference(params, cfg, device="cpu")
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel")
    eng = AsyncServeEngine(cfg, model, policy, clock=FixedClock(),
                           device="cpu", **ENGINE_KW, **kw)
    assert _serve(eng, prompts, ServeRequest, max_new=6) == want
    assert drops.n > 0
