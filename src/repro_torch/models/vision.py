"""The paper's vision benchmarks (Table II), held against
``repro/models/vision.py``:

  * ``ResNet50``    -- bottleneck v1.5, [3, 4, 6, 3] (reference ``:68-111``);
  * ``MobileNetV2`` -- inverted residuals, width 1.0 (``:116-173``);
  * ``YOLOv5L``     -- the CSP backbone, SPPF, PAN neck and three 1x1 anchor
                       heads of the reference's YOLOv5-L analog (``:178-270``).

The primitives mirror ``:29-66``:

  * ``conv`` pads as XLA's ``"SAME"`` does: per spatial dim ``out = ceil(in
    / s)``, ``total = max((out - 1) * s + k - in, 0)``, ``total // 2`` before
    and the rest after.  That is not PyTorch's symmetric ``padding=``: a 3x3
    stride-2 conv on an even input pads (0, 1), ResNet's 7x7 stem on 224
    pads (2, 3).  Symmetric pads go to ``F.conv2d``'s ``padding``; the
    others to ``F.pad`` first;
  * ``bn`` is batch norm in batch-statistics mode: mean and *biased*
    variance over (N, H, W), eps 1e-5, no running statistics
    (``F.batch_norm(..., training=True)`` with no running buffers);
  * max pooling pads SAME with -inf.

Images come in NHWC ``(B, H, W, 3)`` as the reference's batches do, and
YOLO's outputs go back out NHWC ``(B, H/8, W/8, 255)`` ... as its targets
are laid out.  Inside, activations are NCHW (contiguous).  On the H100 in
fp32, channels_last (activations and weights) was no faster for ResNet-50,
slower for MobileNetV2 and 5 % faster for YOLOv5-L, timed in turns
(``scripts/probe_variant.py vision_layout``), so one layout serves all
three.  Conv weights are OIHW (the
reference's HWIO, transposed by ``convert.vision_from_reference``; a
depthwise ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)`` with ``groups=C``); the
``fc`` weight keeps the reference's ``(in, classes)``.  Parameter names
mirror the reference's pytree (``stage0.1.c2.bn.scale``), so
``param_count`` and the converter line up leaf by leaf.  The models compute
in fp32, as the reference does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_bench import VisionConfig
from repro_torch.models.lm import require_device


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def same_pads(size: int, k: int, s: int):
    """(before, after) of XLA's ``"SAME"`` padding for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(x, k: int, s: int):
    """The SAME pads of an NCHW ``x`` as ``((top, bottom), (left, right))``."""
    return same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)


def conv(x, w, stride: int = 1, groups: int = 1):
    """``x`` NCHW, ``w`` OIHW, XLA's SAME padding."""
    (t, b), (l, r) = _pads(x, w.shape[2], stride)
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l), groups=groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride, groups=groups)


def max_pool(x, k: int, stride: int):
    """``reduce_window(max)`` with SAME padding filled with -inf."""
    (t, b), (l, r) = _pads(x, k, stride)
    if t == b and l == r:
        return F.max_pool2d(x, k, stride, padding=(t, l))
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), k, stride)


def relu6(x):
    return torch.clamp(F.relu(x), max=6.0)


def _conv_init(gen, cout, cin, k, *, dtype, device):
    """He normal, ``std = sqrt(2 / fan_in)`` with ``fan_in = k * k * cin``."""
    w = torch.randn((cout, cin, k, k), generator=gen, device=device,
                    dtype=torch.float32)
    return nn.Parameter((w * math.sqrt(2.0 / (k * k * cin))).to(dtype))


class BN(nn.Module):
    def __init__(self, c, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))

    def forward(self, x, eps: float = 1e-5):
        return F.batch_norm(x, None, None, self.scale, self.bias,
                            training=True, eps=eps)


class ConvBN(nn.Module):
    """``conv_bn`` / ``apply_conv_bn``; ``groups == cin == cout`` is the
    depthwise conv."""

    def __init__(self, gen, cin, cout, k, *, groups=1, dtype, device):
        super().__init__()
        self.groups = groups
        self.w = _conv_init(gen, cout, cin // groups, k, dtype=dtype,
                            device=device)
        self.bn = BN(cout, dtype=dtype, device=device)

    def forward(self, x, stride: int = 1,
                act: Optional[Callable] = F.relu):
        y = self.bn(conv(x, self.w, stride, self.groups))
        return act(y) if act is not None else y


class Dense(nn.Module):
    """The classifier: ``w (in, classes)`` at N(0, 0.01^2), ``b`` zeros."""

    def __init__(self, gen, cin, cout, *, dtype, device):
        super().__init__()
        w = torch.randn((cin, cout), generator=gen, device=device,
                        dtype=torch.float32)
        self.w = nn.Parameter((w * 0.01).to(dtype))
        self.b = nn.Parameter(torch.zeros(cout, dtype=dtype, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class _Vision(nn.Module):
    """What the three models share: the config, the device and the NHWC
    entry."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, images):
        return self.apply_nchw(images.permute(0, 3, 1, 2).contiguous())


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------
_R50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class Bottleneck(nn.Module):
    def __init__(self, gen, cin, width, proj, **kw):
        super().__init__()
        self.c1 = ConvBN(gen, cin, width, 1, **kw)
        self.c2 = ConvBN(gen, width, width, 3, **kw)
        self.c3 = ConvBN(gen, width, width * 4, 1, **kw)
        if proj:
            self.proj = ConvBN(gen, cin, width * 4, 1, **kw)

    def forward(self, y, stride):
        h = self.c1(y)
        h = self.c2(h, stride)
        h = self.c3(h, act=None)
        sc = self.proj(y, stride, act=None) if hasattr(self, "proj") else y
        return F.relu(h + sc)


class ResNet50(_Vision):
    def __init__(self, cfg: VisionConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__(cfg)
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBN(generator, 3, 64, 7, **kw)
        cin = 64
        for si, (width, blocks, _) in enumerate(_R50_STAGES):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(generator, cin, width, bi == 0, **kw))
                cin = width * 4
            setattr(self, f"stage{si}", nn.ModuleList(stage))
        self.fc = Dense(generator, cin, cfg.num_classes, **kw)

    def apply_nchw(self, x):
        y = max_pool(self.stem(x, 2), 3, 2)
        for si, (_, _, stride) in enumerate(_R50_STAGES):
            for bi, blk in enumerate(getattr(self, f"stage{si}")):
                y = blk(y, stride if bi == 0 else 1)
        return self.fc(y.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------
# (expansion t, out channels c, repeats n, stride s) -- the published table
_MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class InvertedResidual(nn.Module):
    def __init__(self, gen, cin, t, c, stride, **kw):
        super().__init__()
        hidden = cin * t
        self.stride = stride
        if t != 1:
            self.expand = ConvBN(gen, cin, hidden, 1, **kw)
        self.dw = ConvBN(gen, hidden, hidden, 3, groups=hidden, **kw)
        self.project = ConvBN(gen, hidden, c, 1, **kw)

    def forward(self, y):
        h = self.expand(y, act=relu6) if hasattr(self, "expand") else y
        h = self.dw(h, self.stride, act=relu6)
        h = self.project(h, act=None)
        if self.stride == 1 and y.shape[1] == h.shape[1]:
            h = h + y
        return h


class MobileNetV2(_Vision):
    def __init__(self, cfg: VisionConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__(cfg)
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBN(generator, 3, 32, 3, **kw)
        cin, blocks = 32, []
        for t, c, n, s in _MBV2:
            for i in range(n):
                blocks.append(InvertedResidual(generator, cin, t, c,
                                               s if i == 0 else 1, **kw))
                cin = c
        self.blocks = nn.ModuleList(blocks)
        self.head = ConvBN(generator, cin, 1280, 1, **kw)
        self.fc = Dense(generator, 1280, cfg.num_classes, **kw)

    def apply_nchw(self, x):
        y = self.stem(x, 2, act=relu6)
        for blk in self.blocks:
            y = blk(y)
        y = self.head(y, act=relu6)
        return self.fc(y.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# YOLOv5-L analog (CSP backbone + PAN neck + anchor heads)
# ---------------------------------------------------------------------------
class _CSPBottleneck(nn.Module):
    def __init__(self, gen, mid, **kw):
        super().__init__()
        self.a = ConvBN(gen, mid, mid, 1, **kw)
        self.b = ConvBN(gen, mid, mid, 3, **kw)


class C3(nn.Module):
    """``_csp_block`` / ``_apply_csp``: split, n bottlenecks on one path,
    concatenate (the bottleneck path first), fuse."""

    def __init__(self, gen, cin, cout, n, **kw):
        super().__init__()
        mid = cout // 2
        self.cv1 = ConvBN(gen, cin, mid, 1, **kw)
        self.cv2 = ConvBN(gen, cin, mid, 1, **kw)
        self.cv3 = ConvBN(gen, 2 * mid, cout, 1, **kw)
        self.m = nn.ModuleList(_CSPBottleneck(gen, mid, **kw)
                               for _ in range(n))

    def forward(self, x, shortcut=True):
        a = self.cv1(x, act=F.silu)
        for m in self.m:
            h = m.b(m.a(a, act=F.silu), act=F.silu)
            a = a + h if shortcut else h
        b = self.cv2(x, act=F.silu)
        return self.cv3(torch.cat([a, b], 1), act=F.silu)


class SPPF(nn.Module):
    def __init__(self, gen, c, **kw):
        super().__init__()
        self.cv1 = ConvBN(gen, c, c // 2, 1, **kw)
        self.cv2 = ConvBN(gen, c * 2, c, 1, **kw)

    def forward(self, y):
        h = self.cv1(y, act=F.silu)
        p1 = max_pool(h, 5, 1)
        p2 = max_pool(p1, 5, 1)
        p3 = max_pool(p2, 5, 1)
        return self.cv2(torch.cat([h, p1, p2, p3], 1), act=F.silu)


class DetectHead(nn.Module):
    """A 1x1 conv with bias: He-normal ``w``, zero ``b``."""

    def __init__(self, gen, c, no, *, dtype, device):
        super().__init__()
        self.w = _conv_init(gen, no, c, 1, dtype=dtype, device=device)
        self.b = nn.Parameter(torch.zeros(no, dtype=dtype, device=device))

    def forward(self, f):
        return F.conv2d(f, self.w, self.b)


# YOLOv5-L: depth_multiple = 1.0, width_multiple = 1.0
_Y5L_W = (64, 128, 256, 512, 1024)
_Y5L_D = (3, 6, 9, 3)


def _up2(x):
    """Nearest 2x upsampling (``jax.image.resize(..., "nearest")`` at an
    exact 2x: output pixel i reads input pixel i // 2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv5L(_Vision):
    def __init__(self, cfg: VisionConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__(cfg)
        kw = dict(dtype=dtype, device=device)
        g, W, D = generator, _Y5L_W, _Y5L_D
        self.stem = ConvBN(g, 3, W[0], 6, **kw)
        for i in range(4):
            setattr(self, f"down{i}", ConvBN(g, W[i], W[i + 1], 3, **kw))
            setattr(self, f"csp{i}", C3(g, W[i + 1], W[i + 1], D[i], **kw))
        self.sppf = SPPF(g, W[4], **kw)
        self.up1_cv = ConvBN(g, W[4], W[3], 1, **kw)
        self.up1_csp = C3(g, W[3] * 2, W[3], D[3], **kw)
        self.up2_cv = ConvBN(g, W[3], W[2], 1, **kw)
        self.up2_csp = C3(g, W[2] * 2, W[2], D[3], **kw)
        self.dn1_cv = ConvBN(g, W[2], W[2], 3, **kw)
        self.dn1_csp = C3(g, W[2] + W[2], W[3], D[3], **kw)
        self.dn2_cv = ConvBN(g, W[3], W[3], 3, **kw)
        self.dn2_csp = C3(g, W[3] + W[3], W[4], D[3], **kw)
        no = 3 * (5 + cfg.num_classes)
        for i, c in enumerate((W[2], W[3], W[4])):
            setattr(self, f"head{i}", DetectHead(g, c, no, **kw))

    def apply_nchw(self, x):
        y = self.stem(x, 2, act=F.silu)
        feats = []
        for i in range(4):
            y = getattr(self, f"down{i}")(y, 2, act=F.silu)
            y = getattr(self, f"csp{i}")(y)
            feats.append(y)
        y = self.sppf(y)
        c3, c4 = feats[1], feats[2]
        # top-down
        u1 = self.up1_cv(y, act=F.silu)
        f4 = self.up1_csp(torch.cat([_up2(u1), c4], 1), shortcut=False)
        u2 = self.up2_cv(f4, act=F.silu)
        f3 = self.up2_csp(torch.cat([_up2(u2), c3], 1), shortcut=False)
        # bottom-up
        d1 = self.dn1_cv(f3, 2, act=F.silu)
        f4b = self.dn1_csp(torch.cat([d1, u2], 1), shortcut=False)
        d2 = self.dn2_cv(f4b, 2, act=F.silu)
        f5b = self.dn2_csp(torch.cat([d2, u1], 1), shortcut=False)
        return [getattr(self, f"head{i}")(f).permute(0, 2, 3, 1)
                for i, f in enumerate((f3, f4b, f5b))]


# ---------------------------------------------------------------------------
# registry + losses
# ---------------------------------------------------------------------------
VISION_MODELS = {"resnet50": ResNet50, "mobilenetv2": MobileNetV2,
                 "yolov5l": YOLOv5L}


def init_vision(cfg: VisionConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> _Vision:
    """Random weights drawn on ``device`` from ``seed`` (the counterpart of
    ``init_vision(key, cfg)``): He-normal convs, N(0, 0.01^2) ``fc``, BN
    scale 1 and bias 0."""
    dev = require_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return VISION_MODELS[cfg.arch](cfg, generator=gen, dtype=dtype,
                                   device=dev)


def apply_vision(model: _Vision, images):
    """Classifier logits (B, classes), or YOLO's three NHWC head outputs."""
    return model(images)


def classification_loss(model: _Vision, batch):
    logp = F.log_softmax(model(batch["images"]).float(), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()


def detection_loss(model: _Vision, batch):
    """The mean-square surrogate over the three heads (reference
    ``:299-307``)."""
    loss = 0.0
    for o, tgt in zip(model(batch["images"]), batch["targets"]):
        loss = loss + (o.float() - tgt).square().mean()
    return loss


def vision_loss(model: _Vision, batch):
    if model.cfg.arch == "yolov5l":
        return detection_loss(model, batch)
    return classification_loss(model, batch)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
