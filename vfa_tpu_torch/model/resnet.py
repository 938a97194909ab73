"""ResNet-18/34 feature pyramid with GroupNorm(16) (port of
`vfa_tpu/model/resnet.py`).

Reference: `vfa/model/resnet.py` — BasicBlock with GN(16), stem conv7x7/s2
+ GN + maxpool3x3/s2, returning the /8, /16, /32 pyramid. NCHW inside;
module names follow the reference state-dict keys (`base.layerX.Y.*`).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
from torch import nn

GN_EPS = 1e-5


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(16, channels, eps=GN_EPS)


class BasicBlock(nn.Module):
    """Two 3x3 convs with GN and a residual add (`vfa/model/resnet.py:26-57`)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = group_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = group_norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                group_norm(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class ResNetGN(nn.Module):
    """ResNet trunk returning (feats8, feats16, feats32), NCHW.
    `layers` is (2, 2, 2, 2) for resnet18, (3, 4, 6, 3) for resnet34.
    `fused_stem` runs the stem's GN + ReLU + max-pool through
    `ops.stem.gn_relu_pool` (same forward, the hand-written backward that
    keeps only conv1's output); the parameters stay under `bn1`, so the
    state dict is the same. VFA_FUSED_STEM=1/0 overrides the attribute, as
    in the JAX package."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 fused_stem: bool = False):
        super().__init__()
        self.fused_stem = fused_stem
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = group_norm(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers), start=1):
            stride = 1 if stage == 1 else 2
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes)
                mods.append(BasicBlock(inplanes, planes, s, ds))
                inplanes = planes
            setattr(self, f"layer{stage}", nn.Sequential(*mods))

    def fused_stem_on(self) -> bool:
        env = os.environ.get("VFA_FUSED_STEM")
        return env != "0" if env is not None else self.fused_stem

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.conv1(x)
        if self.fused_stem_on():
            from vfa_tpu_torch.ops.stem import gn_relu_pool

            x = gn_relu_pool(x, self.bn1.weight, self.bn1.bias,
                             self.bn1.num_groups, self.bn1.eps)
        else:
            x = self.maxpool(torch.relu(self.bn1(x)))
        x = self.layer1(x)
        f8 = self.layer2(x)
        f16 = self.layer3(f8)
        f32 = self.layer4(f16)
        return f8, f16, f32
