"""Port vs reference: the vision models' losses and gradients
(``vision_loss`` against ``jax.value_and_grad`` of
``repro.models.vision.vision_loss``) at full width and depth, batch 2 at
64 px, and the step that trains them (``trainer.make_step`` with
``trainer.paper_loss_fn``).

Both sides run in float64 (the reference under ``jax.enable_x64``): at this
size float32 rounding alone moves some of ResNet-50's gradients by a large
share of their max-abs (``test_float32_rounding_alone_moves_the_gradients``
pins it), so no float32 limit could tell a wrong backward from rounding.  The
loss and every gradient must agree within 5e-4 of the leaf's max-abs (the
backward tolerance of ``tests/test_kernels_bwd.py``).  A leaf whose
gradient is zero in exact arithmetic (a BN bias whose output reaches the
loss only through linear maps and another BN, which removes any constant:
MobileNetV2's ``project.bn.bias`` leaves) carries rounding alone on both
sides; such leaves are held below 1e-9 of the largest gradient instead.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_bench as ref_pb
from repro.models import vision as ref_vision

from repro_torch import convert
from repro_torch.configs import paper_bench as pb
from repro_torch.configs.base import PolicyConfig
from repro_torch.models import vision
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer

CFGS = {"resnet50": (ref_pb.RESNET50, pb.RESNET50),
        "mobilenetv2": (ref_pb.MOBILENETV2, pb.MOBILENETV2),
        "yolov5l": (ref_pb.YOLOV5L, pb.YOLOV5L)}
GRAD_TOL = 5e-4           # of each leaf's max-abs, float64 on both sides
ZERO_TOL = 1e-9           # of the largest gradient, for zero-by-design leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's float64 convolutions on one CPU thread: PyTorch's depthwise
    convolution in float64 opens a parallel region per small slice of work,
    and beside the other test workers' threads those regions stalled
    MobileNetV2's forward for minutes (one thread: 0.1 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(arch, size=64, B=2, seed=1):
    """The images and labels, or YOLO's three target maps (B, H/s, W/s,
    255) at strides 8, 16, 32, as numpy float64."""
    r = np.random.RandomState(seed)
    out = {"images": r.standard_normal((B, size, size, 3))}
    if arch == "yolov5l":
        out["targets"] = [r.standard_normal((B, size // s, size // s, 255))
                          for s in (8, 16, 32)]
    else:
        out["labels"] = r.randint(0, 1000, (B,)).astype(np.int32)
    return out


def _torch(batch, dtype=torch.float64):
    def put(v):
        t = torch.from_numpy(v)
        return t.to(dtype) if t.is_floating_point() else t

    return {k: [put(x) for x in v] if isinstance(v, list) else put(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", list(CFGS))
def test_loss_and_gradients_match_jax(arch):
    ref_cfg, cfg = CFGS[arch]
    batch = _batch(arch)
    with jax.enable_x64(True):
        params = jax.jit(lambda k: ref_vision.init_vision(
            k, ref_cfg, jnp.float64))(jax.random.PRNGKey(0))
        jb = jax.tree.map(jnp.asarray, batch)
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, b: ref_vision.vision_loss(p, b, ref_cfg)))(params, jb)
        params = jax.tree.map(np.asarray, params)
        want = convert.flatten_tree(jax.tree.map(np.asarray, want))
    model = convert.vision_from_reference(params, cfg, dtype=torch.float64,
                                          device="cpu")
    loss = vision.vision_loss(model, _torch(batch))
    loss.backward()
    want_loss = float(want_loss)
    assert abs(float(loss.detach()) - want_loss) <= GRAD_TOL * abs(want_loss)
    got = convert.flatten_tree(
        convert.vision_to_reference(model, lambda p: p.grad))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    zero = []
    for name, w in want.items():
        w_max = float(np.abs(w).max())
        if w_max <= ZERO_TOL * scale:
            zero.append(name)
            assert float(np.abs(got[name]).max()) <= ZERO_TOL * scale, name
            continue
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_TOL * w_max, (name, err, w_max)
    # only BN biases can be zero by design (MobileNetV2's 17 project.bn
    # biases: between them and the next BN everything is linear)
    assert all(n.endswith("bn.bias") for n in zero), zero


def test_float32_rounding_alone_moves_the_gradients():
    """Why the comparisons above run in float64: ResNet-50's own float32
    gradients at batch 2 x 64 px differ from its float64 ones, from the same
    weights and batch, by more than the 5e-4 limit on some leaves (batch
    statistics over 8 values a channel in its last stage)."""
    m32 = vision.init_vision(pb.RESNET50, seed=0, device="cpu")
    m64 = copy.deepcopy(m32).double()
    batch = _batch("resnet50")
    grads = []
    for model, dt in ((m32, torch.float32), (m64, torch.float64)):
        vision.vision_loss(model, _torch(batch, dt)).backward()
        grads.append({n: p.grad.double()
                      for n, p in model.named_parameters()})
    worst = max(float((grads[0][n] - g).abs().max() / g.abs().max())
                for n, g in grads[1].items())
    assert worst > GRAD_TOL


def test_step_decays_conv_and_dense_weights_only():
    """``make_step`` applies ``adamw.apply``'s rule: decay where ``ndim >=
    2`` (conv and fc weights), not on BN scales and biases or fc's bias.
    With every gradient zero the moments stay zero, so decay is the whole
    update."""
    model = vision.init_vision(pb.MOBILENETV2, seed=0, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamWConfig(lr=1e-2, weight_decay=0.5)
    state = trainer.TrainState.create(model, PolicyConfig(), opt)

    def zero_loss(m, batch):
        loss = sum((p * 0).sum() for p in m.parameters())
        return loss, {"loss": loss}

    step = trainer.make_step(zero_loss, opt)
    state, metrics = step(state, _batch("mobilenetv2", size=32))
    assert float(metrics["grad_norm"]) == 0.0
    for n, p in model.named_parameters():
        want = before[n] * (1 - 1e-2 * 0.5) if p.ndim >= 2 else before[n]
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)
    assert state.opt.step == 1


@pytest.mark.parametrize("arch,size", [("mobilenetv2", 32),
                                       ("yolov5l", 64)])
def test_loss_falls_over_three_steps_on_one_batch(arch, size):
    """The card's ``paper_bench`` phase at a small size on the CPU: three
    steps of ``paper_loss_fn`` on one fixed batch, fp32, AdamW."""
    cfg = CFGS[arch][1]
    model = vision.init_vision(cfg, seed=0, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    state = trainer.TrainState.create(model, PolicyConfig(), opt)
    step = trainer.make_step(trainer.paper_loss_fn(cfg, PolicyConfig()), opt)
    batch = _torch(_batch(arch, size), torch.float32)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
