"""Port vs reference: the training slice -- losses, AdamW, the schedule, the
synthetic data, one whole train step, the port's counterparts of
``tests/test_system.py``'s training tests, and the training launcher.

The same numpy inputs (made from a seed) go through the JAX function and its
``repro_torch`` counterpart, everything on the CPU in fp32 unless a test says
otherwise; on CPU tensors the kernel wrappers run their plain versions, so
``attn_impl="kernel"`` exercises the differentiable attention Function.
Tolerances are stated per test with their reason.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.configs.base import ShapeConfig as RefShape
from repro.data import SyntheticDataset as RefDataset
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import SyntheticDataset, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.lm import lm_loss
from repro_torch.optim import (AdamWConfig, AdamWState, ScheduleConfig,
                               adamw, lr_at)
from repro_torch.train import trainer

SHAPE = ShapeConfig("t", 64, 4, "train")
BASE = PolicyConfig(compute_dtype="float32", remat="none",
                    attn_impl="kernel", zero_stage=0)


def numpy_params(ref_cfg, seed=0):
    """The reference's parameter tree with every leaf redrawn by numpy
    (weights keep their init spread, norm scales move off 1)."""
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def _cfgs(arch="llama3.2-3b"):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


def _batch(B=2, S=32, V=40, D=16, seed=0, masked=False):
    r = np.random.RandomState(seed)
    return (r.standard_normal((B, S, D)).astype(np.float32),
            (r.standard_normal((V, D)) * 0.5).astype(np.float32),
            r.randint(0, V, (B, S)).astype(np.int32),
            (r.rand(B, S) > 0.3).astype(np.float32) if masked else None)


# ---------------------------------------------------------------------------
# losses (fp32; 1e-5: the same reductions in another order)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    x, _, labels, mask = _batch(masked=masked)
    logits = (x[..., :10] @ np.random.RandomState(1).standard_normal(
        (10, 40)).astype(np.float32)) * 2
    jm = None if mask is None else jnp.asarray(mask)
    want, gwant = jax.value_and_grad(lambda lg: ref_layers.softmax_xent(
        lg, jnp.asarray(labels), jm))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = layers.softmax_xent(t, torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gwant), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("masked,chunk", [(False, 8), (True, 4), (True, 32)])
def test_chunked_softmax_xent_values_and_grads_match_reference(masked, chunk):
    x, table, labels, mask = _batch(masked=masked)
    jm = None if mask is None else jnp.asarray(mask)
    want, (gx, gt) = jax.value_and_grad(
        lambda x, t: ref_layers.chunked_softmax_xent(
            x, t, jnp.asarray(labels), chunk=chunk,
            compute_dtype=jnp.float32, mask=jm), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    got = layers.chunked_softmax_xent(tx, tt, torch.from_numpy(labels),
                                      chunk=chunk,
                                      compute_dtype=torch.float32, mask=tm)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-6,
                               rtol=1e-5)
    # and the unchunked path of the port gives the same (the recomputing
    # backward is autograd's gradient)
    ux = torch.from_numpy(x).requires_grad_()
    ut = torch.from_numpy(table).requires_grad_()
    ref = layers.softmax_xent(layers.unembed(ut, ux, torch.float32),
                              torch.from_numpy(labels), tm)
    ref.backward()
    np.testing.assert_allclose(tx.grad.numpy(), ux.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), ut.grad.numpy(), atol=1e-6)


def test_chunked_softmax_xent_bf16_close_to_fp32():
    """bf16 logits round at ~3 significant digits: 1e-2 of the loss."""
    x, table, labels, _ = _batch()
    args = (torch.from_numpy(x), torch.from_numpy(table),
            torch.from_numpy(labels))
    a = layers.chunked_softmax_xent(*args, chunk=8,
                                    compute_dtype=torch.bfloat16)
    b = layers.chunked_softmax_xent(*args, chunk=8,
                                    compute_dtype=torch.float32)
    assert a.dtype == torch.float32
    assert abs(float(a) - float(b)) < 1e-2 * float(b)
    with pytest.raises(ValueError):
        layers.chunked_softmax_xent(*args, chunk=5)


@pytest.mark.parametrize("chunk", [0, 16])
def test_lm_loss_matches_reference(chunk):
    ref_cfg, cfg = _cfgs()
    params = numpy_params(ref_cfg)
    model = convert.from_reference(params, cfg, device="cpu")
    batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), step=3)
    ref_ctx = ref_trainer.make_run_ctx(
        ref_cfg, RefPolicy(compute_dtype="float32", remat="none",
                           attn_impl="full"))
    want, wm = ref_lm.lm_loss(jax.tree.map(jnp.asarray, params),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              ref_cfg, ref_ctx, xent_chunk=chunk)
    ctx = trainer.make_run_ctx(cfg, BASE)
    got, gm = lm_loss(model, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, ctx,
                      xent_chunk=chunk)
    assert sorted(gm) == ["aux", "loss", "xent"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gm["xent"].item(), float(wm["xent"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------
SHAPES = {"w": (6, 5), "b": (5,), "t": (2, 3, 4)}


def _opt_inputs(seed=3):
    r = np.random.RandomState(seed)
    f = np.float32
    params = {n: r.standard_normal(s).astype(f) for n, s in SHAPES.items()}
    grads = {n: (3 * r.standard_normal(s)).astype(f)   # norm > 1: clipped
             for n, s in SHAPES.items()}
    m = {n: (0.1 * r.standard_normal(s)).astype(f) for n, s in SHAPES.items()}
    v = {n: (0.01 * r.rand(*s)).astype(f) for n, s in SHAPES.items()}
    return params, grads, m, v


@pytest.mark.parametrize("masters", [False, True])
def test_adamw_apply_matches_reference(masters):
    """Step 4 -> 5 from identical state, clip active, decay only on ndim
    >= 2; with masters the parameters and gradients are bf16.  Moments and
    fp32 values at 1e-6 (one fp32 rounding apart); bf16 parameters within
    one bf16 step (8e-3 relative) of the reference's."""
    params, grads, m, v = _opt_inputs()
    pdt, jdt = ((torch.bfloat16, jnp.bfloat16) if masters
                else (torch.float32, jnp.float32))
    j = lambda d, dt=jnp.float32: {n: jnp.asarray(a).astype(dt)  # noqa: E731
                                   for n, a in d.items()}
    ref_state = ref_adamw.AdamWState(
        step=jnp.asarray(4, jnp.int32), m=j(m), v=j(v),
        master=j(params) if masters else None)
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    wp, ws, wmet = ref_adamw.apply(j(params, jdt), j(grads, jdt), ref_state,
                                   ref_cfg)

    t = lambda d, dt=torch.float32: {n: torch.from_numpy(a).to(dt)  # noqa
                                     for n, a in d.items()}
    state = AdamWState(step=4, m=t(m), v=t(v),
                       master=t(params) if masters else None)
    gp = t(params, pdt)
    _, state, met = adamw.apply(gp, t(grads, pdt), state,
                                AdamWConfig(lr=1e-3, weight_decay=0.1,
                                            grad_clip=1.0))
    assert state.step == int(ws.step) == 5
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(wmet["grad_norm"]), rtol=1e-6)
    assert float(met["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(met["lr"]), float(wmet["lr"]))
    for n in SHAPES:
        for got, want in ((state.m[n], ws.m[n]), (state.v[n], ws.v[n])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6, err_msg=n)
        want_p = np.asarray(wp[n].astype(jnp.float32))
        if masters:
            np.testing.assert_allclose(state.master[n].numpy(),
                                       np.asarray(ws.master[n]), atol=1e-6,
                                       rtol=1e-6, err_msg=n)
            np.testing.assert_allclose(gp[n].float().numpy(), want_p,
                                       rtol=8e-3, err_msg=n)
        else:
            np.testing.assert_allclose(gp[n].numpy(), want_p, atol=1e-6,
                                       rtol=1e-6, err_msg=n)


def test_adamw_init_and_clip_match_reference():
    params, grads, _, _ = _opt_inputs(4)
    st = adamw.init({n: torch.from_numpy(a).bfloat16()
                     for n, a in params.items()}, master_weights=True)
    assert st.step == 0 and st.master["w"].dtype == torch.float32
    assert all(float(x.abs().sum()) == 0 for x in st.m.values())
    got, norm = adamw.clip_by_global_norm(
        {n: torch.from_numpy(a) for n, a in grads.items()}, 1.0)
    want, wnorm = ref_adamw.clip_by_global_norm(
        {n: jnp.asarray(a) for n, a in grads.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(kind):
    cfg = ScheduleConfig(kind=kind, peak_lr=1e-3, warmup_steps=10,
                         total_steps=100, min_ratio=0.1)
    ref_cfg = ref_schedule.ScheduleConfig(kind=kind, peak_lr=1e-3,
                                          warmup_steps=10, total_steps=100,
                                          min_ratio=0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150):
        np.testing.assert_allclose(lr_at(s, cfg),
                                   float(ref_schedule.lr_at(s, ref_cfg)),
                                   rtol=1e-6, err_msg=f"{kind} step {s}")


def test_schedule_shapes():
    cfg = ScheduleConfig(kind="cosine", peak_lr=1e-3, warmup_steps=10,
                         total_steps=100, min_ratio=0.1)
    assert lr_at(0, cfg) == 0.0
    assert lr_at(10, cfg) == pytest.approx(1e-3)
    assert lr_at(100, cfg) == pytest.approx(1e-4, rel=1e-2)
    assert lr_at(55, cfg) < 1e-3


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-3b", "llava-next-mistral-7b"])
def test_synthetic_batches_equal_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    shape, ref_shape = ShapeConfig("t", 48, 4, "train"), RefShape("t", 48, 4,
                                                                  "train")
    ds, ref_ds = SyntheticDataset(cfg, shape, 7), RefDataset(ref_cfg,
                                                             ref_shape, 7)
    assert ds.batch_bytes() == ref_ds.batch_bytes()
    for step, shard, n in ((0, 0, 1), (5, 1, 2), (9, 3, 4)):
        got = ds.batch_at(step, shard=shard, n_shards=n)
        want = ref_ds.batch_at(step, shard=shard, n_shards=n)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# one whole train step against the reference's jitted step
# ---------------------------------------------------------------------------
def test_train_step_matches_the_reference_jitted_step():
    """reduced llama3.2-3b, fp32, remat per block, clip active, from the same
    weights and batch: the reference's jitted step with attn_impl="xla"
    against the port's with the differentiable kernel path.

    Tolerances: loss and grad norm 1e-5 relative; gradients 1e-5 of each
    leaf's max-abs (fp32, different reduction orders).  Updated parameters
    1e-6 where |g| > 1e-6.  Where the gradient is smaller, the first AdamW
    step's update g / (|g| + eps) flips with rounding, so only
    |difference| <= 2 lr is asserted there.  Per-layer norm scales are
    1-D here and (layers, d) once the reference stacks them, so the
    reference decays them (ndim >= 2) and the port, by the same rule on its
    own tensors, does not: the port's value is the reference's plus
    lr * weight_decay * old value."""
    ref_cfg, cfg = _cfgs()
    params = numpy_params(ref_cfg, seed=5)
    batch = make_batch(cfg, SHAPE, step=2)
    lr, wd = 1e-3, 0.1
    ref_policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0)
    ref_opt = ref_adamw.AdamWConfig(lr=lr, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (wloss, _), wgrads = jax.value_and_grad(
        ref_trainer.make_loss_fn(ref_cfg, ref_policy), has_aux=True)(jp, jb)
    ref_state = ref_trainer.TrainState(jp, ref_adamw.init(jp, ref_opt))
    wstate, wm = jax.jit(ref_trainer.make_train_step(
        ref_cfg, ref_policy, ref_opt))(ref_state, jb)

    policy = dataclasses.replace(BASE, remat="block")
    model = convert.from_reference(params, cfg, device="cpu")
    old = convert.to_reference(model)
    state = trainer.TrainState.create(model, policy,
                                      AdamWConfig(lr=lr, weight_decay=wd))
    state, m = trainer.make_train_step(
        cfg, policy, AdamWConfig(lr=lr, weight_decay=wd))(state, batch)

    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(wloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["grad_norm"]) > 1.0                  # the clip is active
    grads = convert.to_reference(model, leaf=lambda p: p.grad)
    new = convert.to_reference(model)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    g_port, g_ref = flat(grads), flat(wgrads)
    p_port, p_ref, p_old = flat(new), flat(wstate.params), flat(old)
    assert sorted(g_port) == sorted(g_ref) == sorted(p_ref)
    for k in g_ref:
        scale = np.abs(g_ref[k]).max()
        np.testing.assert_allclose(g_port[k], g_ref[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
        want = p_ref[k]
        if "norm" in k and "stack" in k:      # stacked 1-D leaves
            want = want + lr * wd * p_old[k]
        sure = np.abs(g_ref[k]) > 1e-6
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * lr + 1e-6), k
    m_port = flat(convert.to_reference(model, convert.by_name(model,
                                                               state.opt.m)))
    for k, v in flat(wstate.opt.m).items():
        np.testing.assert_allclose(m_port[k], v, atol=1e-7,
                                   rtol=1e-4, err_msg=k)


def test_make_train_step_refuses_a_mesh():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="item 7"):
        trainer.make_train_step(cfg, BASE, mesh=object())
    with pytest.raises(NotImplementedError, match="int8_ef"):
        trainer.make_train_step(cfg, dataclasses.replace(
            BASE, grad_compression="int8_ef"), mesh=object())


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_system.py's training tests
# ---------------------------------------------------------------------------
def _state(cfg, policy, lr=1e-3):
    return trainer.init_state(cfg, policy, AdamWConfig(lr=lr), seed=0,
                              device="cpu")


def test_training_reduces_loss():
    _, cfg = _cfgs()
    state = _state(cfg, BASE)
    step = trainer.make_train_step(cfg, BASE, AdamWConfig(lr=1e-3))
    losses = []
    for i in range(8):
        state, m = step(state, make_batch(cfg, SHAPE, step=i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_accum_matches_full_batch():
    """2-way accumulation == single large batch (same data)."""
    _, cfg = _cfgs("qwen2-0.5b")
    p2 = dataclasses.replace(BASE, grad_accum=2)
    s1, s2 = _state(cfg, BASE), _state(cfg, p2)
    batch = make_batch(cfg, SHAPE)
    s1, m1 = trainer.make_train_step(cfg, BASE, AdamWConfig(lr=1e-3))(s1,
                                                                     batch)
    s2, m2 = trainer.make_train_step(cfg, p2, AdamWConfig(lr=1e-3))(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=1e-5)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5)


def test_remat_does_not_change_loss_or_gradients():
    _, cfg = _cfgs()
    batch = make_batch(cfg, SHAPE)
    out = {}
    for remat in ("none", "block"):
        p = dataclasses.replace(BASE, remat=remat)
        state = _state(cfg, p)
        _, m = trainer.make_train_step(cfg, p, AdamWConfig(lr=1e-3))(state,
                                                                     batch)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]))
    assert out["none"][0] == pytest.approx(out["block"][0], abs=1e-5)
    assert out["none"][1] == pytest.approx(out["block"][1], rel=1e-5)


def test_bf16_close_to_fp32():
    _, cfg = _cfgs("qwen2-0.5b")
    batch = make_batch(cfg, SHAPE)
    losses = {}
    for dt in ("float32", "bfloat16"):
        p = dataclasses.replace(BASE, compute_dtype=dt)
        _, m = trainer.make_train_step(cfg, p, AdamWConfig(lr=1e-3))(
            _state(cfg, p), batch)
        losses[dt] = float(m["loss"])
    assert abs(losses["bfloat16"] - losses["float32"]) < 0.05


def test_bf16_parameters_keep_fp32_masters():
    _, cfg = _cfgs()
    p = dataclasses.replace(BASE, param_dtype="bfloat16")
    state = _state(cfg, p)
    assert state.opt.master is not None
    assert state.model.embed.dtype == torch.bfloat16
    state, m = trainer.make_train_step(cfg, p, AdamWConfig(lr=1e-3))(
        state, make_batch(cfg, SHAPE))
    assert np.isfinite(float(m["loss"]))
    for n, prm in state.model.named_parameters():
        assert torch.equal(prm, state.opt.master[n].to(torch.bfloat16)), n


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(list(argv))
    return rc, out.getvalue()


def test_launch_train_runs_on_cpu_and_raises_without_a_device():
    rc, out = _main("--device", "cpu", "--arch", "llama3.2-3b", "--reduced",
                    "--steps", "3", "--batch", "2", "--seq", "32",
                    "--log-every", "1")
    assert rc == 0, out
    assert out.count("loss") == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _main("--reduced", "--steps", "3")
    with pytest.raises(NotImplementedError, match="item 8"):
        _main("--device", "cpu", "--reduced", "--track")


def test_launch_train_fail_at_then_resume(tmp_path):
    ck = str(tmp_path / "ck")
    common = ("--device", "cpu", "--reduced", "--steps", "4", "--batch", "2",
              "--seq", "16", "--ckpt", ck)
    rc, out = _main(*common, "--fail-at", "2")
    assert rc == 17 and "simulated failure at step 2" in out
    rc, out = _main(*common, "--resume", "auto")
    assert rc == 0 and "resumed from step 2" in out
