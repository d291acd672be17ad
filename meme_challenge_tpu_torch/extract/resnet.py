"""Caffe-style ResNet backbone for the bottom-up-attention detector (torch).

The port of ``meme_challenge_tpu/extract/resnet.py``. Parity target:
``build_bua_resnet_backbone`` of the reference subrepo
(configs/bua-caffe/*.yaml: DEPTH 101/152, OUT_FEATURES ["res4"],
RES5_DILATION 2), the Caffe-era Faster R-CNN layout:

- conv1 7×7/2 + BN + ReLU + maxpool 3×3/2
- res2 (3 blocks, 256), res3 (4/8 blocks, 512), res4 (23/36 blocks, 1024)
  as the stride-16 backbone feeding the RPN;
- res5 (3 blocks, 2048, dilation 2) lives in the ROI head, applied per
  region after ROI pooling.

BatchNorm is an affine weight/bias with no running statistics (detectron2
``FrozenBN``; the Caffe checkpoints bake the statistics into it). The
reference's detectron2 recipe freezes it and the stem (FREEZE_AT 3); the
detector train step (``detector_train.py``) does not: it differentiates and
updates every parameter, these included, as the JAX package's step does.
Modules run in NCHW, and
their parameters carry detectron2's key layout
(``stem.conv1.weight``, ``stem.conv1.norm.{weight,bias}``,
``res4.22.conv2.weight``, ``res2.0.shortcut.norm.bias``): the norm is a
child of its conv, as in detectron2, so the reference checkpoint loads as it
stands.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

RESNET_STAGES = {
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBN(nn.Module):
    """Affine-only normalization (Caffe BN folded into weight/bias); both
    are parameters that the detector train step trains."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class ConvNorm(nn.Conv2d):
    """Bias-free convolution followed by its ``norm`` child (FrozenBN)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         dilation=dilation, bias=False)
        self.norm = FrozenBN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck with a projection shortcut on stage entry.

    Caffe ordering: the stride is on the FIRST 1×1 conv (torch-style ResNets
    stride the 3×3; the Caffe checkpoints need stride-on-1×1). A strided 1×1
    conv pads nothing, as flax's ``SAME`` gives it at any size.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        if in_channels != out_channels or stride != 1:
            self.shortcut = ConvNorm(in_channels, out_channels, 1,
                                     stride=stride)
        else:
            self.shortcut = None
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1,
                              stride=stride)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3,
                              padding=dilation, dilation=dilation)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + shortcut)


class ResNetStage(nn.Sequential):
    """``num_blocks`` bottlenecks, keyed ``0 .. num_blocks-1``; the first
    takes ``first_stride``."""

    def __init__(self, num_blocks: int, in_channels: int, out_channels: int,
                 bottleneck_channels: int, first_stride: int = 2,
                 dilation: int = 1):
        super().__init__(*[
            Bottleneck(in_channels if i == 0 else out_channels, out_channels,
                       bottleneck_channels,
                       stride=first_stride if i == 0 else 1,
                       dilation=dilation)
            for i in range(num_blocks)])


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, stride=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        # flax max_pool pads with −inf, as max_pool2d does
        return F.max_pool2d(x, 3, stride=2, padding=1)


class CaffeResNetBackbone(nn.Module):
    """conv1 → res2/3/4; returns the stride-16 res4 map
    [B, 1024, H/16, W/16]."""

    def __init__(self, depth: int = 101):
        super().__init__()
        n2, n3, n4, _ = RESNET_STAGES[depth]
        self.stem = Stem()
        self.res2 = ResNetStage(n2, 64, 256, 64, first_stride=1)
        self.res3 = ResNetStage(n3, 256, 512, 128, first_stride=2)
        self.res4 = ResNetStage(n4, 512, 1024, 256, first_stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res4(self.res3(self.res2(self.stem(x))))


class Res5Head(ResNetStage):
    """res5 stage applied to pooled ROI features (BUACaffeRes5ROIHeads).

    RES5_DILATION 2 with stride 1 on entry: the 14×14 pooled map keeps its
    spatial size; the features are the global average over the map (2048-d),
    what UNITER consumes.
    """

    def __init__(self, depth: int = 101, dilation: int = 2):
        _, _, _, n5 = RESNET_STAGES[depth]
        super().__init__(n5, 1024, 2048, 512,
                         first_stride=1 if dilation > 1 else 2,
                         dilation=dilation)
