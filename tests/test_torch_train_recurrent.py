"""Port vs reference: training the recurrent archs -- recurrentgemma-2b's
RG-LRU blocks (``RGLRUFn``: the forward scan, then the hand-written reverse
scan) and its sliding-window attention blocks (``FlashAttentionFn`` under a
window), and the attention backward at its head dim of 256.

The same numpy inputs (made from a seed) go through the JAX function and its
``repro_torch`` counterpart, everything on the CPU in fp32; on CPU tensors
the kernel wrappers run their plain versions (``rglru_plain`` forward,
``rglru_bwd_plain`` backward), so ``attn_impl="kernel"`` exercises the
differentiable Functions.  Tolerances are stated per test with their reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.kernels.ref import attention_ref as ref_attention_ref
from repro.models import lm as ref_lm
from repro.models import rglru as ref_rglru
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels.rglru import (RGLRUFn, rglru_bwd, rglru_bwd_plain,
                                       rglru_plain)
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer

ARCH = "recurrentgemma-2b"
# S = 192 > the reduced window of 64, so the window masks in every
# attention block
SHAPE = ShapeConfig("t", 192, 2, "train")
POLICY = PolicyConfig(compute_dtype="float32", remat="block",
                      attn_impl="kernel", zero_stage=0)


def numpy_params(ref_cfg, seed=0):
    """The reference's parameter tree with every leaf redrawn by numpy
    (weights keep their init spread, biases and norm scales move off their
    init)."""
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def _cfgs(n_layers):
    return (ref_reduced(ref_get_config(ARCH), n_layers=n_layers),
            reduced(get_config(ARCH), n_layers=n_layers))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# (1) one whole train step against the reference's jitted step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", [3, 6])
def test_train_step_matches_the_reference_jitted_step(n_layers):
    """Reduced recurrentgemma-2b, (R, R, A) once (3 layers: one segment,
    nothing stacked) and twice (6 layers: the reference stacks the segment),
    fp32, remat per block, clip active, from the same weights and batch: the
    reference's jitted step with attn_impl="xla" against the port's through
    RGLRUFn and FlashAttentionFn.

    Tolerances, those of the llama3.2-3b step test
    (``tests/test_torch_train.py``): loss and grad norm 1e-5 relative;
    gradients 1e-5 of each leaf's max-abs (fp32, different reduction
    orders: the reference differentiates its associative scan, the port
    runs the reverse scan).  Updated parameters 1e-6 where |g| > 1e-6, else
    |difference| <= 2 lr (the first AdamW step's g / (|g| + eps) flips with
    rounding there).  1-D leaves of a stacked segment -- the norm scales and
    the RG-LRU's ``conv_b``, ``ba``, ``bx`` and ``lam`` -- are (repeats, W)
    in the reference, which decays them (ndim >= 2); the port's are 1-D and,
    by the same rule on its own tensors, are not: there the port's value is
    the reference's plus lr * weight_decay * old value (ROADMAP queue C)."""
    ref_cfg, cfg = _cfgs(n_layers)
    assert cfg.local_window < SHAPE.seq_len
    params = numpy_params(ref_cfg, seed=5)
    batch = make_batch(cfg, SHAPE, step=2)
    lr, wd = 1e-3, 0.1
    ref_policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0)
    ref_opt = ref_adamw.AdamWConfig(lr=lr, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_state = ref_trainer.TrainState(jp, ref_adamw.init(jp, ref_opt))
    wstate, wm = jax.jit(ref_trainer.make_train_step(
        ref_cfg, ref_policy, ref_opt))(ref_state, jb)
    wgrads = jax.jit(jax.grad(lambda p: ref_trainer.make_loss_fn(
        ref_cfg, ref_policy)(p, jb)[0]))(jp)

    model = convert.from_reference(params, cfg, device="cpu")
    old = convert.to_reference(model)
    dims = _flat(convert.to_reference(
        model, leaf=lambda p: torch.tensor(float(p.dim()))))
    state = trainer.TrainState.create(model, POLICY,
                                      AdamWConfig(lr=lr, weight_decay=wd))
    before = dict(ops.launch_counts())
    state, m = trainer.make_train_step(
        cfg, POLICY, AdamWConfig(lr=lr, weight_decay=wd))(state, batch)
    assert ops.launch_counts() == before        # CPU: the plain versions ran

    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["grad_norm"]) > 1.0                  # the clip is active
    g_port = _flat(convert.to_reference(model, leaf=lambda p: p.grad))
    g_ref = _flat(wgrads)
    p_port, p_ref, p_old = (_flat(convert.to_reference(model)),
                            _flat(wstate.params), _flat(old))
    assert sorted(g_port) == sorted(g_ref) == sorted(p_ref)
    assert any("lam" in k for k in g_ref)
    stacked_1d = {k for k in p_ref if p_ref[k].ndim >= 2 and
                  np.all(dims[k] == 1)}
    assert bool(stacked_1d) == (n_layers == 6)
    for k in g_ref:
        scale = np.abs(g_ref[k]).max()
        np.testing.assert_allclose(g_port[k], g_ref[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
        want = p_ref[k]
        if k in stacked_1d:
            want = want + lr * wd * p_old[k]
        sure = np.abs(g_ref[k]) > 1e-6
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * lr + 1e-6), k


# ---------------------------------------------------------------------------
# (2) the RG-LRU's gradients
# ---------------------------------------------------------------------------
def _scan_inputs(B, S, W, seed=0):
    r = np.random.RandomState(seed)
    log_a = -np.log1p(np.exp(r.standard_normal((B, S, W)))).astype(
        np.float32)
    gated, dy = (r.standard_normal((B, S, W)).astype(np.float32)
                 for _ in range(2))
    h0 = r.standard_normal((B, W)).astype(np.float32)
    return log_a, gated, dy, h0


def _close_rel(got, want, tol, what):
    """Within ``tol`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 300])
def test_rglru_gradients_match_jax_grad_and_autograd(S, with_h0):
    """RGLRUFn on the CPU (rglru_plain forward, rglru_bwd_plain backward)
    against jax.grad of the reference's rglru_scan_chunked (64-step chunks
    where S is a multiple of 64; it scans whole otherwise) and rglru_scan,
    and against torch autograd of rglru_plain: 1e-5 of each gradient's
    max-abs (fp32; the three scans sum in different orders)."""
    B, W = 2, 24
    log_a, gated, dy, h0 = _scan_inputs(B, S, W, seed=S)
    h0 = h0 if with_h0 else None
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (log_a, gated) + ((h0,) if with_h0 else ())]
    out = RGLRUFn.apply(*leaves[:2], leaves[2] if with_h0 else None)
    got = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), leaves)

    def ref_loss(fn):
        def f(la, g, *h):
            return jnp.sum(fn(la, g, h0=h[0] if h else None) * dy)
        return f
    jargs = [jnp.asarray(a) for a in (log_a, gated)] + \
        ([jnp.asarray(h0)] if with_h0 else [])
    argnums = tuple(range(len(jargs)))
    wants = {
        "rglru_scan_chunked": jax.jit(jax.grad(ref_loss(
            lambda la, g, h0: ref_rglru.rglru_scan_chunked(
                la, g, chunk=64, h0=h0)), argnums=argnums))(*jargs),
        "rglru_scan": jax.jit(jax.grad(ref_loss(ref_rglru.rglru_scan),
                                       argnums=argnums))(*jargs)}
    leaves2 = [x.detach().clone().requires_grad_() for x in leaves]
    wants["autograd of rglru_plain"] = torch.autograd.grad(
        (rglru_plain(*leaves2[:2], h0=leaves2[2] if with_h0 else None)
         * torch.from_numpy(dy)).sum(), leaves2, allow_unused=True,
        materialize_grads=True)
    for source, want in wants.items():
        for a, b, name in zip(got, want, ("d log_a", "d gated", "d h0")):
            _close_rel(a.numpy(), np.asarray(b), 1e-5, f"{name} vs {source}")


def test_rglru_bwd_wrapper_runs_the_plain_reverse_scan_on_cpu():
    log_a, gated, dy, h0 = (torch.from_numpy(a) for a in
                            _scan_inputs(2, 100, 16, seed=3))
    hs = rglru_plain(log_a, gated, h0=h0)
    before = dict(ops.launch_counts())
    for h in (None, h0):
        got = rglru_bwd(log_a, hs, dy, h0=h)
        want = rglru_bwd_plain(log_a, hs, dy, h0=h)
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
        assert (got[2] is None) == (h is None)
    assert ops.launch_counts() == before
    assert "rglru_bwd" in ops.launch_counts()
    with pytest.raises(ValueError):
        rglru_bwd(log_a, hs[:, :5], dy)
    # ops.rglru takes RGLRUFn where autograd needs a gradient
    x = gated.clone().requires_grad_()
    assert type(ops.rglru(log_a, x).grad_fn).__name__ == "RGLRUFnBackward"
    assert ops.rglru(log_a, gated).grad_fn is None


# ---------------------------------------------------------------------------
# (3) the plain attention backward at recurrentgemma-2b's head dim
# ---------------------------------------------------------------------------
D256_CASES = [
    # B, S, T, H, K, causal, window: G = 10 (recurrentgemma's MQA heads)
    (1, 256, 256, 10, 1, True, 64),     # the window masks
    (2, 130, 130, 10, 1, True, 64),     # B = 2, ragged
    (1, 200, 200, 4, 2, True, 50),      # GQA G = 2
]


@pytest.mark.parametrize("B,S,T,H,K,causal,window", D256_CASES)
def test_plain_backward_at_d256_matches_jax_grad_of_the_oracle(
        B, S, T, H, K, causal, window):
    """FlashAttentionFn on the CPU (the plain stats forward and backward)
    against jax.grad of the reference's oracle at D = 256: 5e-4, the
    reference's gradient tolerance (``tests/test_kernels_bwd.py``)."""
    r = np.random.RandomState(7)
    q, ct = (r.standard_normal((B, S, H, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (r.standard_normal((B, T, K, 256)).astype(np.float32)
            for _ in range(2))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fab.flash_attention_vjp(*leaves, causal, window, 0.0)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    want = jax.grad(lambda q, k, v: jnp.sum(ref_attention_ref(
        q, k, v, causal=causal, window=window) * ct), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


# ---------------------------------------------------------------------------
# (4) activation checkpointing
# ---------------------------------------------------------------------------
def test_remat_leaves_loss_and_gradients_unchanged():
    """remat="block" recomputes each block's forward in the backward pass
    (torch.utils.checkpoint): on the CPU the recompute runs the same
    operations on the same values, so the loss and every gradient are
    exactly those of remat="none"."""
    ref_cfg, cfg = _cfgs(3)
    params = numpy_params(ref_cfg, seed=6)
    batch = make_batch(cfg, SHAPE, step=1)
    out = {}
    for remat in ("none", "block"):
        model = convert.from_reference(params, cfg, device="cpu")
        policy = dataclasses.replace(POLICY, remat=remat)
        grads, loss, _ = trainer._accum_grads(
            trainer.make_loss_fn(cfg, policy), model,
            trainer._device_batch(batch, "cpu"), 1)
        out[remat] = (float(loss), grads)
    assert out["none"][0] == out["block"][0]
    for n, g in out["none"][1].items():
        assert torch.equal(g, out["block"][1][n]), n


# ---------------------------------------------------------------------------
# (5) the launcher
# ---------------------------------------------------------------------------
def test_launch_train_runs_recurrentgemma_on_cpu(capsys):
    rc = launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                            "--steps", "2", "--batch", "2", "--seq", "96",
                            "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "training recurrentgemma-2b-reduced" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_make_train_step_builds_mamba2_through_ssdfn():
    """The SSM blocks train through SSDFn (the SSD forward kernel and the
    hand-written SSD backward; ``tests/test_torch_train_ssm.py`` holds them
    against the reference): one reduced step on the CPU runs the plain
    versions and gives every parameter a finite gradient."""
    cfg = reduced(get_config("mamba2-780m"), n_layers=2)
    step = trainer.make_train_step(cfg, POLICY)
    state = trainer.init_state(cfg, POLICY, seed=0, device="cpu")
    before = dict(ops.launch_counts())
    state, m = step(state, make_batch(cfg, ShapeConfig("t", 64, 2, "train"),
                                      step=0))
    assert ops.launch_counts() == before
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for n, p in state.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
