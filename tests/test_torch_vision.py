"""Port vs reference: the paper's three vision models (``repro_torch.models.
vision`` against ``repro/models/vision.py``) at full width and depth on the
CPU -- forward outputs, parameter counts, the SAME-padding rule, max pooling
and the converter.  Gradients are in ``tests/test_torch_vision_grads.py``
(a file of their own, so that ``--dist loadfile`` runs the two on different
workers).

The forward comparisons run in float64 on both sides (the reference under
``jax.enable_x64``, its init cast to float64; the port converted from the
same numpy weights): with batch statistics over as few as 8 values a
channel (batch 2, a 2 x 2 map), float32 rounding alone moves the outputs by
up to 3.4e-4 of their max-abs (YOLOv5-L's stride-32 head at 64 px, port
float32 against port float64), more than the 1e-4 of max-abs each model
must meet here.  In float64 a wrong pad, variance or layout shows at O(1).
Each reference model is initialised once and each reference output
computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import paper_bench as ref_pb
from repro.models import vision as ref_vision

from repro_torch import convert
from repro_torch.configs import paper_bench as pb
from repro_torch.models import vision

CFGS = {"resnet50": (ref_pb.RESNET50, pb.RESNET50),
        "mobilenetv2": (ref_pb.MOBILENETV2, pb.MOBILENETV2),
        "yolov5l": (ref_pb.YOLOV5L, pb.YOLOV5L)}
# batch 2 at an even and an odd size (YOLO's strides need a multiple of 32)
SIZES = {"resnet50": (64, 57), "mobilenetv2": (64, 57), "yolov5l": (64, 96)}
FWD_TOL = 1e-4            # of max-abs, float64 on both sides


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


@pytest.fixture(scope="module")
def zoo():
    """arch -> (reference params as float64 numpy, the port's float64
    model), built on first use."""
    return {}


def _setup(zoo, arch):
    if arch not in zoo:
        ref_cfg, cfg = CFGS[arch]
        with jax.enable_x64(True):
            params = jax.jit(lambda k: ref_vision.init_vision(
                k, ref_cfg, jnp.float64))(jax.random.PRNGKey(0))
            params = jax.tree.map(np.asarray, params)
        zoo[arch] = (params, convert.vision_from_reference(
            params, cfg, dtype=torch.float64, device="cpu"))
    return zoo[arch]


def _images(size, seed=1):
    return np.random.RandomState(seed).standard_normal((2, size, size, 3))


@pytest.mark.parametrize("arch,size", [(a, s) for a in CFGS
                                       for s in SIZES[a]])
def test_forward_matches_the_reference(zoo, arch, size):
    params, model = _setup(zoo, arch)
    x = _images(size)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x: ref_vision.apply_vision(
            p, x, CFGS[arch][0]))(params, jnp.asarray(x))
        want = [np.asarray(w) for w in jax.tree.leaves(want)]
    with torch.no_grad():
        got = vision.apply_vision(model, torch.from_numpy(x))
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= FWD_TOL * float(np.abs(w).max()), (arch, size, err)


@pytest.mark.parametrize("arch,paper,tol", [("mobilenetv2", 3.4e6, 0.05),
                                            ("resnet50", 25.6e6, 0.01),
                                            ("yolov5l", 47e6, 0.02)])
def test_param_count_equals_the_reference_and_table_ii(zoo, arch, paper,
                                                       tol):
    params, model = _setup(zoo, arch)
    n = vision.param_count(model)
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert abs(n - paper) / paper < tol


@pytest.mark.parametrize("arch", list(CFGS))
def test_converter_round_trips_every_leaf(zoo, arch):
    params, model = _setup(zoo, arch)
    back = convert.flatten_tree(convert.vision_to_reference(model))
    want = convert.flatten_tree(params)
    assert set(back) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(back[name], w)


def test_converter_rejects_a_missing_leaf(zoo):
    params, _ = _setup(zoo, "mobilenetv2")
    cut = dict(params, head={"w": params["head"]["w"]})
    with pytest.raises(ValueError, match="head.bn"):
        convert.vision_from_reference(cut, pb.MOBILENETV2, device="cpu")


@pytest.mark.parametrize("k", [1, 3, 5, 6, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [16, 17])
def test_same_padding_matches_xla(k, stride, size):
    """``vision.conv`` against ``jax.lax.conv_general_dilated(..., "SAME")``
    (float64, a 16 x 17 or 17 x 16 input: both parities in one call)."""
    r = np.random.RandomState(k * 10 + stride)
    x = r.standard_normal((1, size, 33 - size, 3))
    w = r.standard_normal((k, k, 3, 4))
    with jax.enable_x64(True):
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = vision.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_same_pads_of_the_published_layers():
    assert vision.same_pads(224, 7, 2) == (2, 3)      # ResNet's stem
    assert vision.same_pads(112, 3, 2) == (0, 1)      # its max pool
    assert vision.same_pads(56, 3, 2) == (0, 1)       # any 3x3 / 2, even
    assert vision.same_pads(640, 6, 2) == (2, 2)      # YOLO's stem
    assert vision.same_pads(20, 5, 1) == (2, 2)       # SPPF's pool
    assert vision.same_pads(57, 3, 2) == (1, 1)


def test_symmetric_padding_fails_at_the_resnet_stem():
    """PyTorch's ``padding=k // 2`` is not SAME: at ResNet's 7 x 7 stride-2
    stem on an even input it pads (3, 3) where SAME pads (2, 3), and the
    output shifts by a pixel."""
    r = np.random.RandomState(0)
    x = r.standard_normal((1, 32, 32, 3))
    w = r.standard_normal((7, 7, 3, 8))
    with jax.enable_x64(True):
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=3).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 0.5 * np.abs(want).max()


@pytest.mark.parametrize("k,stride,size", [(3, 2, 112), (3, 2, 57),
                                           (5, 1, 20)])
def test_max_pool_matches_reduce_window(k, stride, size):
    """SAME padding filled with -inf: ResNet's 3 x 3 / 2 pool, and SPPF's
    5 x 5 / 1 (on values below zero, where a zero fill would win)."""
    x = np.random.RandomState(size).standard_normal((2, size, size, 3)) - 3
    with jax.enable_x64(True):
        want = np.asarray(jax.lax.reduce_window(
            jnp.asarray(x), -jnp.inf, jax.lax.max, (1, k, k, 1),
            (1, stride, stride, 1), "SAME"))
    got = vision.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), k,
                          stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_batch_norm_uses_the_biased_variance():
    """``bn`` normalises by the biased variance over (N, H, W), as
    ``jnp.var`` does."""
    x = np.random.RandomState(3).standard_normal((2, 3, 2, 2)) * 2 + 1
    bn = vision.BN(3, dtype=torch.float64, device="cpu")
    got = bn(torch.from_numpy(x)).detach().numpy()
    mu = x.mean(axis=(0, 2, 3), keepdims=True)
    var = x.var(axis=(0, 2, 3), keepdims=True)          # ddof 0
    np.testing.assert_allclose(got, (x - mu) / np.sqrt(var + 1e-5),
                               rtol=0, atol=1e-12)


def test_init_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vision.init_vision(pb.MOBILENETV2)
    model = vision.init_vision(pb.MOBILENETV2, device="cpu")
    assert model.device.type == "cpu"
    assert all(p.dtype == torch.float32 for p in model.parameters())
