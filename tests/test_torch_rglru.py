"""The Griffin slice of the port against the reference: the RG-LRU scan's
plain version (the CPU side of kernel B5), the gates, the recurrent block,
the sliding-window attention of ``attn_local`` blocks with its ring-buffer
caches, and the conversion of both recurrent archs' weights.

Inputs and weights are made with numpy from a seed and handed to both
sides.  The reference's Pallas RG-LRU kernel runs in interpret mode, as its
own tests run it.  Tolerances: the scan at 2e-5 (fp32, the log-depth scan
multiplies in another order than the sequential kernel); the block and the
attention paths at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attention
from repro.models import lm as ref_lm
from repro.models import rglru as ref_rglru

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.models import attention, rglru as rg
from repro_torch.models.lm import LM

TOL_SCAN = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "recurrentgemma-2b"


def _redraw(tree, seed):
    """Every leaf redrawn by numpy: ``mean + randn * (std or 0.1)``."""
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def _cfgs(n_layers=3):
    return (ref_reduced(ref_get_config(ARCH), n_layers=n_layers),
            reduced(get_config(ARCH), n_layers=n_layers))


def _scan_inputs(B, S, W, seed=0):
    r = np.random.RandomState(seed)
    log_a = -np.log1p(np.exp(r.standard_normal((B, S, W)))).astype(
        np.float32)
    gated = r.standard_normal((B, S, W)).astype(np.float32)
    return log_a, gated


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,W,bs", [
    (2, 128, 64, 32), (1, 64, 256, 64), (3, 96, 32, 32), (1, 128, 8, 16)])
def test_rglru_plain_matches_reference(B, S, W, bs):
    log_a, gated = _scan_inputs(B, S, W)
    got = rglru_plain(torch.from_numpy(log_a), torch.from_numpy(gated))
    want = ref_ops.rglru(jnp.asarray(log_a), jnp.asarray(gated),
                         block_seq=bs, impl="pallas", interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_SCAN)


def test_rglru_initial_state_and_wrapper_on_cpu():
    log_a, gated = _scan_inputs(2, 77, 24, seed=1)
    h0 = np.random.RandomState(2).standard_normal((2, 24)).astype(np.float32)
    before = dict(ops.launch_counts())
    got = rglru(torch.from_numpy(log_a), torch.from_numpy(gated),
                h0=torch.from_numpy(h0))
    want = ref_rglru.rglru_scan(jnp.asarray(log_a), jnp.asarray(gated),
                                h0=jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_SCAN)
    la, g = torch.from_numpy(log_a), torch.from_numpy(gated)
    assert torch.equal(ops.rglru(la, g), ops.rglru(la, g, impl="plain"))
    assert torch.equal(ref.rglru_ref(la, g), rglru_plain(la, g))
    assert ops.launch_counts() == before        # CPU: the plain version ran
    with pytest.raises(ValueError):
        rglru(la, g[:, :5])
    with pytest.raises(ValueError):
        rglru(la, g, h0=torch.zeros(2, 5))


# ---------------------------------------------------------------------------
# the gates and the recurrent block
# ---------------------------------------------------------------------------
def _block(seed=0):
    ref_cfg, cfg = _cfgs()
    params = _redraw(ref_rglru.init_rglru(jax.random.PRNGKey(seed), ref_cfg),
                     seed)
    mod = rg.RGLRU(cfg)
    with torch.no_grad():
        for n, p in mod.named_parameters(recurse=False):
            p.copy_(torch.from_numpy(params[n]))
    return ref_cfg, jax.tree.map(jnp.asarray, params), cfg, mod


def test_rglru_fp32_leaves_survive_the_cast():
    model = LM.init(_cfgs()[1], seed=0, device="cpu")
    model.cast_weights_(torch.bfloat16)
    blk = model.stack.blocks[0].rglru
    assert blk.in_gate.dtype == blk.out_proj.dtype == torch.bfloat16
    for n in rg.RGLRU.FP32_LEAVES:
        assert getattr(blk, n).dtype == torch.float32, n


def test_rglru_gates_match_reference():
    ref_cfg, rp, cfg, mod = _block()
    x = np.random.RandomState(3).standard_normal(
        (2, 7, cfg.rglru.lru_width)).astype(np.float32)
    with torch.no_grad():
        got = rg.rglru_gates(mod, torch.from_numpy(x), cfg.rglru.c)
    want = ref_rglru.rglru_gates(rp, jnp.asarray(x), ref_cfg.rglru.c)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_apply_rglru_prefill_and_decode_match_reference(masked):
    """Prefill output and built cache (with right padding: token_mask), then
    three decode steps from each side's own cache."""
    ref_cfg, rp, cfg, mod = _block()
    B, S = 2, 30
    x = np.random.RandomState(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(S)[None, :] < np.asarray([[S], [19]])
    y2, c2 = ref_rglru.apply_rglru(
        rp, jnp.asarray(x), ref_cfg, compute_dtype=jnp.float32,
        build_cache=True,
        token_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        y, c = rg.apply_rglru(
            mod, torch.from_numpy(x), cfg, compute_dtype=torch.float32,
            build_cache=True,
            token_mask=None if mask is None else torch.from_numpy(mask))
    real = np.ones((B, S), bool) if mask is None else mask
    np.testing.assert_allclose(y.numpy()[real], np.asarray(y2)[real], **TOL)
    for n in ("conv", "state"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(c2[n]), **TOL)
    cache = rg.init_rglru_cache(cfg, B)
    want_c = ref_rglru.init_rglru_cache(ref_cfg, B)
    for n in cache:
        assert cache[n].dtype == torch.float32 and \
            want_c[n].dtype == jnp.float32
        cache[n].copy_(c[n])
    rc = jax.tree.map(lambda a: a.astype(jnp.float32), c2)
    r = np.random.RandomState(4)
    for _ in range(3):
        xt = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y2, rc = ref_rglru.apply_rglru(rp, jnp.asarray(xt), ref_cfg,
                                       compute_dtype=jnp.float32, cache=rc)
        with torch.no_grad():
            y, out = rg.apply_rglru(mod, torch.from_numpy(xt), cfg,
                                    compute_dtype=torch.float32, cache=cache)
        assert out is cache                 # updated in place
        np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL)
    for n in ("conv", "state"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(rc[n]), **TOL)


# ---------------------------------------------------------------------------
# sliding-window attention and its ring caches
# ---------------------------------------------------------------------------
def _local(seed=0):
    ref_cfg, cfg = _cfgs()
    params = _redraw(ref_attention.init_attention(jax.random.PRNGKey(seed),
                                                  ref_cfg), seed)
    mod = attention.Attention(cfg)
    with torch.no_grad():
        for n, p in mod.named_parameters(recurse=False):
            p.copy_(torch.from_numpy(params[n]))
    return ref_cfg, jax.tree.map(jnp.asarray, params), cfg, mod


def _pos(B, s, e):
    return np.tile(np.arange(s, e, dtype=np.int32), (B, 1))


def _ref_apply(rp, x, ref_cfg, pos, **kw):
    return ref_attention.apply_attention(
        rp, jnp.asarray(x), ref_cfg, local=True, positions=jnp.asarray(pos),
        compute_dtype=jnp.float32, **kw)


def _apply(mod, x, cfg, pos, **kw):
    with torch.no_grad():
        return attention.apply_attention(
            mod, torch.from_numpy(np.ascontiguousarray(x)), cfg, local=True,
            positions=torch.from_numpy(np.ascontiguousarray(pos)),
            compute_dtype=torch.float32, **kw)


def _ring_equal(got, want):
    """``pos`` array-equal; k/v equal at the live slots."""
    pos = np.asarray(want["pos"])
    np.testing.assert_array_equal(got["pos"].numpy(), pos)
    for n in ("k", "v"):
        np.testing.assert_allclose(got[n].numpy()[pos >= 0],
                                   np.asarray(want[n])[pos >= 0], **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "padded"])
def test_local_prefill_ring_cache_and_wrapping_decode(masked):
    """S = 100 > window 64: the windowed prefill through ops.attention (the
    plain version on the CPU) against the reference's local_flash_xla, the
    ring cache built from it (with and without kv_mask), then decode steps
    whose ring slots wrap."""
    ref_cfg, rp, cfg, mod = _local()
    assert cfg.local_window == 64
    B, S = 2, 100
    x = np.random.RandomState(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = _pos(B, 0, S)
    mask = None
    if masked:
        mask = np.arange(S)[None, :] < np.asarray([[S], [83]])
    kv = dict(kv_mask=None if mask is None else jnp.asarray(mask))
    o2, c2 = _ref_apply(rp, x, ref_cfg, pos, cache="init", **kv)
    o, c = _apply(mod, x, cfg, pos, cache="init", kv_mask=None if mask is None
                  else torch.from_numpy(mask))
    real = np.ones((B, S), bool) if mask is None else mask
    np.testing.assert_allclose(o.numpy()[real], np.asarray(o2)[real], **TOL)
    _ring_equal(c, c2)
    lengths = real.sum(1)
    r = np.random.RandomState(6)
    for i in range(3):
        xt = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pt = (lengths + i).astype(np.int32)[:, None]
        o2, c2 = _ref_apply(rp, xt, ref_cfg, pt, cache=c2)
        o, c = _apply(mod, xt, cfg, pt, cache=c)
        np.testing.assert_allclose(o.numpy(), np.asarray(o2), **TOL)
        _ring_equal(c, c2)


def test_local_chunked_prefill_ring_branch():
    """Prompt chunks into a ring made by init_decode_cache(local=True):
    chunks of 40 > window - 40 make the ring wrap inside a chunk."""
    ref_cfg, rp, cfg, mod = _local(seed=1)
    B, max_seq = 1, 160
    cache = attention.init_decode_cache(cfg, B, max_seq, local=True,
                                        dtype=torch.float32)
    rc = ref_attention.init_decode_cache(ref_cfg, B, max_seq, local=True,
                                         dtype=jnp.float32)
    assert cache["k"].shape == rc["k"].shape == (B, 64, 1, cfg.head_dim)
    x = np.random.RandomState(7).standard_normal(
        (B, 120, cfg.d_model)).astype(np.float32)
    for s, e in ((0, 40), (40, 80), (80, 120)):
        o2, rc = _ref_apply(rp, x[:, s:e], ref_cfg, _pos(B, s, e), cache=rc)
        o, cache = _apply(mod, x[:, s:e], cfg, _pos(B, s, e), cache=cache)
        np.testing.assert_allclose(o.numpy(), np.asarray(o2), **TOL)
        _ring_equal(cache, rc)


def test_local_attention_kernel_and_full_paths_agree():
    """attn_impl "kernel" (ops.attention with the window) and "full" (the
    masked oracle) give the same prefill."""
    _, _, cfg, mod = _local(seed=2)
    x = np.random.RandomState(8).standard_normal(
        (1, 90, cfg.d_model)).astype(np.float32)
    pos = _pos(1, 0, 90)
    a, _ = _apply(mod, x, cfg, pos, impl="kernel")
    b, _ = _apply(mod, x, cfg, pos, impl="full")
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", [("mamba2-780m", 3),
                                           ("recurrentgemma-2b", 8)])
def test_convert_round_trips_recurrent_archs(arch, n_layers):
    """from_reference -> to_reference is exact; recurrentgemma's eight
    layers stack as the reference's two segments, (R, R, A) x 2 (a leading
    layer axis) and (R, R), as the full model's (R, R, A) x 8 and (R, R)."""
    ref_cfg = ref_reduced(ref_get_config(arch), n_layers=n_layers)
    cfg = reduced(get_config(arch), n_layers=n_layers)
    params = _redraw(ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg), 0)
    if arch == ARCH:
        assert sorted(params["stack"]) == ["seg0", "seg1"]
    model = convert.from_reference(params, cfg, device="cpu")
    back = convert.to_reference(model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])
