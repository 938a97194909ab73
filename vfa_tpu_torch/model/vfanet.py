"""VFANet, the multiview BEV detection model (port of
`vfa_tpu/model/vfanet.py`, compiled-rig path).

In-graph ImageNet normalization, ResNet-GN pyramid, per-scale 1x1 laterals
(128/256/512 -> 256) + GN + ReLU, per-scale rig sampling fused with the
collapse Linear(256*nl -> 256) and summed over cameras and scales in fp32,
a fuse block (3x3 conv + BN + ReLU, dilated-2 3x3 conv + BN + ReLU), and
CenterNet-style heads. In training mode the two BatchNorms normalize with
batch statistics and update their running buffers as flax does. Module
names follow the reference `.pth` keys (`vfa/model/vfanet.py:14-149`).
The public edge keeps the JAX layouts:
images (B, N, H, W, 3); outputs as at `vfa_tpu/model/vfanet.py:321-331`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.model.resnet import ResNetGN, group_norm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


class VFACollapse(nn.Module):
    """Holds the per-scale collapse Linear(256*nl -> 256) under the
    reference's `vfaX.collapse.*` keys; input index c*nl + l (c-major,
    `vfa/model/vfa_op.py:120`)."""

    def __init__(self, nl: int, channels: int = 256):
        super().__init__()
        self.collapse = nn.Linear(channels * nl, channels)


class BatchNorm2dBiased(nn.BatchNorm2d):
    """BatchNorm2d whose running variance is updated with the biased batch
    variance, as flax `nn.BatchNorm` does (`nn.BatchNorm2d` uses the
    unbiased one), so a train step leaves the same running statistics as
    the JAX model. flax momentum 0.9 is `momentum=0.1` here. Same
    parameters and buffers as `nn.BatchNorm2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class VFANet(nn.Module):
    """rig_impl: 'cuda' samples through the hand-written rig kernels
    (`ops/rig_cuda.py`; the plain versions for CPU tensors), 'plain' through
    the plain PyTorch versions (`ops/rig.py`). The fused stem is switched
    on as in the JAX package: VFA_FUSED_STEM=1, or `ResNetGN(fused_stem=
    True)` (see `model/resnet.py`)."""

    def __init__(self, cfg: DatasetConfig, base: str = "resnet18",
                 angle_range: int = 360, rig_impl: str = "cuda"):
        super().__init__()
        if base not in RESNET_LAYERS:
            raise ValueError(
                f"Unrecognized model, expect `resnet18` or `resnet34`, got {base}.")
        if cfg.mode not in ("2D", "3D"):
            raise ValueError(f"mode error, expect `2D` or `3D`, got {cfg.mode}")
        if rig_impl not in ("cuda", "plain"):
            raise ValueError(f"rig_impl must be 'cuda' or 'plain', got {rig_impl}")
        self.cfg = cfg
        self.rig_impl = rig_impl
        nl = cfg.num_layers
        self.base = ResNetGN(RESNET_LAYERS[base])
        self.lat8 = nn.Conv2d(128, 256, 1)
        self.lat16 = nn.Conv2d(256, 256, 1)
        self.lat32 = nn.Conv2d(512, 256, 1)
        self.bn8 = group_norm(256)
        self.bn16 = group_norm(256)
        self.bn32 = group_norm(256)
        self.vfa8 = VFACollapse(nl)
        self.vfa16 = VFACollapse(nl)
        self.vfa32 = VFACollapse(nl)
        self.fuse = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1),
            BatchNorm2dBiased(256, eps=1e-5, momentum=0.1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=2, dilation=2),
            BatchNorm2dBiased(256, eps=1e-5, momentum=0.1), nn.ReLU())
        self.map_classifier = nn.Sequential(
            nn.Conv2d(256, 1, 3, padding=4, dilation=4, bias=False))
        self.tytx_pred = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1), group_norm(256), nn.ReLU(),
            nn.Conv2d(256, 2, 3, padding=1, bias=False))
        if cfg.mode == "3D":
            self.orient_pred = nn.Sequential(
                nn.Conv2d(256, angle_range, 3, padding=4, dilation=4, bias=False))
            self.thtwtl_pred = nn.Sequential(
                nn.Conv2d(256, 256, 3, padding=1), group_norm(256), nn.ReLU(),
                nn.Conv2d(256, 3, 3, padding=1, bias=False))
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def bev_features(self, images: torch.Tensor, rig) -> torch.Tensor:
        """images (B, N, H, W, 3) in [0, 1] -> BEV features (B, L, W, 256)."""
        if rig is None:
            raise NotImplementedError(
                "the dynamic voxel path (rig=None, --no_rig) is not ported "
                "yet; pass a CameraRig (ROADMAP.md Queue 1 item 3)")
        if self.rig_impl == "cuda":
            from vfa_tpu_torch.ops.rig_cuda import rig_sample_scale_cuda as sample
        else:
            from vfa_tpu_torch.ops.rig import rig_sample_scale as sample
        B, N = images.shape[:2]
        x = (images.reshape(B * N, *images.shape[2:]) - self.img_mean) / self.img_std
        f8, f16, f32 = self.base(x.permute(0, 3, 1, 2))
        L, W = rig.grid_shape
        ortho = torch.zeros((B, L * W, 256), dtype=torch.float32,
                            device=images.device)
        for sr, f, lat, bn, vfa in (
                (rig.scales[0], f8, self.lat8, self.bn8, self.vfa8),
                (rig.scales[1], f16, self.lat16, self.bn16, self.vfa16),
                (rig.scales[2], f32, self.lat32, self.bn32, self.vfa32)):
            lat5 = torch.relu(bn(lat(f))).permute(0, 2, 3, 1)
            lat5 = lat5.reshape(B, N, *lat5.shape[1:])
            lin = vfa.collapse
            ortho = ortho + sample(lat5, sr, lin.weight.t(), lin.bias,
                                   out_dtype=torch.float32, camera_sum=True)
        return ortho.reshape(B, L, W, 256).to(f8.dtype)

    def forward(self, images: torch.Tensor, rig) -> Dict[str, torch.Tensor]:
        """Returns heatmap (B, 1, L, W), loc_offset (B, L, W, 2) and, in 3D
        mode, dim_offset (B, L, W, 3), rotation (B, L, W, angle_range)."""
        ortho = self.bev_features(images, rig).permute(0, 3, 1, 2)
        fused = self.fuse(ortho)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        pred = {
            "heatmap": self.map_classifier(fused),
            "loc_offset": nhwc(self.tytx_pred(ortho)),
        }
        if self.cfg.mode == "3D":
            pred["dim_offset"] = nhwc(self.thtwtl_pred(ortho))
            pred["rotation"] = nhwc(self.orient_pred(fused))
        return pred


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init from an explicit generator, with torch's default
    bounds: conv/linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    norm affine (1, 0), BatchNorm running stats (0, 1). Values are drawn on
    the CPU so a seed gives the same weights on every device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (mod.weight, mod.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                            * bound)
        elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
    return model
