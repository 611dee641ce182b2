"""The Mamba-2 slice of the port against the reference: the SSD scan's plain
version (the CPU side of kernel B4), the decode step, the causal conv and
the whole mixer.

Inputs are made with numpy from a seed and handed to both sides.  The
reference's Pallas SSD kernel runs in interpret mode, as its own tests run
it.  Tolerances: the SSD scan at 2e-4 (fp32, but the chunked dual form sums
in another order than the kernel's, and its exponentials compound over a
chunk); the conv and the decode step at 1e-5; the mixer at 2e-4 wherever the
scan is inside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import ssm as ref_ssm

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.models import ssm
from repro_torch.models.lm import LM

TOL_SCAN = dict(atol=2e-4, rtol=2e-4)
TOL = dict(atol=1e-5, rtol=1e-5)
SSD_CASES = [
    # B, S, H, P, G, N, chunk -- tests/test_kernels.py
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 8, 32, 2, 16, 16),
    (1, 256, 2, 64, 1, 64, 64),
    (3, 96, 4, 16, 4, 16, 32),    # said to be ragged there: 96 = 3 x 32
    (3, 100, 4, 16, 4, 16, 32),   # ragged: against the padding oracle
]


def _ssd_inputs(B, S, H, P, G, N, seed=0):
    r = np.random.RandomState(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(r.standard_normal(H)).astype(np.float32)
    Bm = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
def test_ssd_plain_matches_reference(B, S, H, P, G, N, chunk):
    ins = _ssd_inputs(B, S, H, P, G, N)
    y, h = ssd_plain(*_t(*ins), chunk=chunk)
    if S % chunk == 0:
        y2, h2 = ref_ops.ssd(*_j(*ins), chunk=chunk, impl="pallas",
                             interpret=True)
    else:   # the reference's kernel asserts S % chunk == 0; the oracle pads
        y2, h2 = ref_ref.ssd_ref(*_j(*ins), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL_SCAN)
    np.testing.assert_allclose(h.numpy(), np.asarray(h2), **TOL_SCAN)


def test_ssd_chunk_independence_and_initial_state():
    """Chunk 32 and 128 give the same scan (the duality), and a given h0
    gives what the reference's ``ssd_chunked(h0=...)`` gives."""
    ins = _ssd_inputs(1, 128, 4, 16, 1, 32)
    y32, h32 = ssd_plain(*_t(*ins), chunk=32)
    y128, h128 = ssd_plain(*_t(*ins), chunk=128)
    np.testing.assert_allclose(y32.numpy(), y128.numpy(), **TOL_SCAN)
    np.testing.assert_allclose(h32.numpy(), h128.numpy(), **TOL_SCAN)
    h0 = np.random.RandomState(3).standard_normal(
        (1, 4, 32, 16)).astype(np.float32)
    y, h = ssd(*_t(*ins), chunk=32, h0=torch.from_numpy(h0))
    y2, h2 = ref_ssm.ssd_chunked(*_j(*ins), chunk=32, h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL_SCAN)
    np.testing.assert_allclose(h.numpy(), np.asarray(h2), **TOL_SCAN)


def test_ssd_matches_sequential_decode_steps():
    """The chunked dual form equals the port's step-by-step recurrence."""
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 16, 2, 8, 1, 4))
    y_k, h_k = ops.ssd(x, dt, A, Bm, Cm, chunk=8)
    h = torch.zeros((1, 2, 4, 8))
    ys = []
    for t in range(16):
        y, h = ssm.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   h)
        ys.append(y)
    np.testing.assert_allclose(y_k.numpy(), torch.stack(ys, 1).numpy(),
                               **TOL_SCAN)
    np.testing.assert_allclose(h_k.numpy(), h.numpy(), **TOL_SCAN)


def test_ssd_decode_step_matches_reference():
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, 4, 8, 2, 6, seed=5)
    h = np.random.RandomState(6).standard_normal((2, 4, 6, 8)).astype(
        np.float32)
    got = ssm.ssd_decode_step(*_t(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                  h))
    want = ref_ssm.ssd_decode_step(*_j(x[:, 0], dt[:, 0], A, Bm[:, 0],
                                       Cm[:, 0], h))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_ssd_wrapper_checks_and_counts_no_cpu_launch():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 20, 4, 8, 2, 4))
    before = dict(ops.launch_counts())
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=8)
    y2, h2 = ops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="plain")
    assert torch.equal(y, y2) and torch.equal(h, h2)
    r1 = ref.ssd_ref(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(r1[0].numpy(), y.numpy(), **TOL_SCAN)
    assert ops.launch_counts() == before        # CPU: the plain version ran
    with pytest.raises(ValueError):
        ssd(x, dt[:, :5], A, Bm, Cm)
    with pytest.raises(ValueError):
        ssd(x, dt, A, Bm[:, :, :1].expand(1, 20, 3, 4), Cm)
    with pytest.raises(ValueError):
        ops.ssd(x, dt, A, Bm, Cm, impl="pallas")


# ---------------------------------------------------------------------------
# the causal conv and the mixer
# ---------------------------------------------------------------------------
def test_causal_conv1d_matches_reference():
    r = np.random.RandomState(1)
    x = r.standard_normal((2, 9, 6)).astype(np.float32)
    w = r.standard_normal((4, 6)).astype(np.float32)
    cache = r.standard_normal((2, 3, 6)).astype(np.float32)
    length = np.asarray([9, 5], np.int32)
    for kw in (dict(), dict(cache=cache), dict(length=length)):
        got = ssm.causal_conv1d(*_t(x, w), **{k: torch.from_numpy(v)
                                              for k, v in kw.items()})
        want = ref_ssm.causal_conv1d(*_j(x, w), **{k: jnp.asarray(v)
                                                   for k, v in kw.items()})
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _mixer(seed=0):
    """The reduced mamba2 config (chunk 32), the reference's ``init_ssm``
    leaves redrawn by numpy, and the port's ``SSM`` holding them."""
    ref_cfg = ref_reduced(ref_get_config("mamba2-780m"))
    cfg = reduced(get_config("mamba2-780m"))
    tree = ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg)
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    params = jax.tree.map(redraw, tree)
    mod = ssm.SSM(cfg)
    with torch.no_grad():
        for n, p in mod.named_parameters(recurse=False):
            p.copy_(torch.from_numpy(params[n]))
        mod.norm.scale.copy_(torch.from_numpy(params["norm"]["scale"]))
    return ref_cfg, jax.tree.map(jnp.asarray, params), cfg, mod


def _close_tree(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_apply_ssm_prefill_and_decode_match_reference(masked):
    """Prefill output and built cache (with right padding: token_mask), then
    three decode steps from each side's own cache."""
    ref_cfg, rp, cfg, mod = _mixer()
    B, S = 2, 40                      # S is not a multiple of chunk 32
    x = np.random.RandomState(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(S)[None, :] < np.asarray([[S], [27]])
    kw = dict(compute_dtype=jnp.float32, build_cache=True)
    y2, c2 = ref_ssm.apply_ssm(rp, jnp.asarray(x), ref_cfg, **kw,
                               token_mask=None if mask is None
                               else jnp.asarray(mask))
    with torch.no_grad():
        y, c = ssm.apply_ssm(mod, torch.from_numpy(x), cfg,
                             compute_dtype=torch.float32, build_cache=True,
                             token_mask=None if mask is None
                             else torch.from_numpy(mask))
    real = np.ones((B, S), bool) if mask is None else mask
    np.testing.assert_allclose(y.numpy()[real], np.asarray(y2)[real],
                               **TOL_SCAN)
    _close_tree(c, c2, TOL_SCAN)
    # decode from caches of the slot layout (fp32 conv tails)
    cache = ssm.init_ssm_cache(cfg, B)
    for n in cache:
        cache[n].copy_(c[n])
    rc = jax.tree.map(lambda a: a.astype(jnp.float32), c2)
    r = np.random.RandomState(4)
    for _ in range(3):
        xt = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y2, rc = ref_ssm.apply_ssm(rp, jnp.asarray(xt), ref_cfg,
                                   compute_dtype=jnp.float32, cache=rc)
        with torch.no_grad():
            y, out = ssm.apply_ssm(mod, torch.from_numpy(xt), cfg,
                                   compute_dtype=torch.float32, cache=cache)
        assert out is cache                 # updated in place
        np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL_SCAN)
    _close_tree(cache, rc, TOL_SCAN)


def test_apply_ssm_decode_step_matches_reference_from_one_cache():
    """One decode step from the same cache on both sides: 1e-5."""
    ref_cfg, rp, cfg, mod = _mixer(seed=1)
    r = np.random.RandomState(7)
    cache = ssm.init_ssm_cache(cfg, 2)
    for n in cache:
        cache[n].copy_(torch.from_numpy(
            r.standard_normal(tuple(cache[n].shape)).astype(np.float32)))
    # copies: on the CPU jnp.asarray may alias the tensors' memory, which
    # the port's step below updates in place while the reference's
    # (dispatched asynchronously) may still be reading it
    rc = {n: jnp.array(t.numpy()) for n, t in cache.items()}
    xt = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    y2, rc = ref_ssm.apply_ssm(rp, jnp.asarray(xt), ref_cfg,
                               compute_dtype=jnp.float32, cache=rc)
    with torch.no_grad():
        y, _ = ssm.apply_ssm(mod, torch.from_numpy(xt), cfg,
                             compute_dtype=torch.float32, cache=cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **TOL)
    _close_tree(cache, rc, TOL)


def test_init_ssm_cache_matches_reference_layout():
    ref_cfg = ref_reduced(ref_get_config("mamba2-780m"))
    cfg = reduced(get_config("mamba2-780m"))
    want = ref_ssm.init_ssm_cache(ref_cfg, 3)
    got = ssm.init_ssm_cache(cfg, 3)
    assert sorted(got) == sorted(want)
    for n in want:
        assert tuple(got[n].shape) == want[n].shape
        assert got[n].dtype == torch.float32 and want[n].dtype == jnp.float32


def test_ssd_sharded_waits_for_the_parallel_layer():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 8, 2, 4, 1, 4))
    with pytest.raises(NotImplementedError, match="item 7"):
        ssm.ssd_sharded(x, dt, A, Bm, Cm, chunk=8, mesh=object(),
                        dp_axes=("data",), tp_axis="model")


def test_ssm_fp32_leaves_survive_a_bf16_model():
    """A_log, D and dt_bias are fp32 in a bf16 model and after the engines'
    one-time cast, as the reference keeps them."""
    cfg = reduced(get_config("mamba2-780m"))
    mod = ssm.SSM(cfg, dtype=torch.bfloat16)
    assert mod.in_x.dtype == torch.bfloat16
    for n in ssm.SSM.FP32_LEAVES:
        assert getattr(mod, n).dtype == torch.float32, n
    model = LM.init(cfg, seed=0, device="cpu").cast_weights_(torch.bfloat16)
    blk = model.stack.blocks[0].ssm
    assert blk.in_z.dtype == blk.conv_x_w.dtype == torch.bfloat16
    assert blk.norm.scale.dtype == torch.float32
    for n in ssm.SSM.FP32_LEAVES:
        assert getattr(blk, n).dtype == torch.float32, n
