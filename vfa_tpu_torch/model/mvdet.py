"""MVDet, multiview detection by feature perspective transformation (Hou,
Zheng, Gould, ECCV 2020; github.com/hou-yz/MVDet,
`multiview_detector/models/persp_trans_detector.py`, `PerspTransDetector`,
with its own `models/resnet.py`).

Each camera's image goes through the ImageNet normalisation and a
ResNet-18 trunk with BatchNorm whose last two stages dilate instead of
striding (torchvision's `replace_stride_with_dilation=[False, True, True]`:
512 channels at /8). `project` runs the image head (`img_classifier`:
head and foot maps) on each camera's features, its first 1x1 convolution
before the bilinear upsampling to a quarter of the calibration's image
size (the two commute: the upsampling's weights sum to 1 on each axis),
and warps the features onto the ground plane's grid by the camera's
homography (kornia's `warp_perspective`: the features upsampled the same
way, then bilinear, zeros outside the map, at the positions of
`geometry.ground_positions`; `ops/projection.py`, one CUDA launch for
bf16 serving); the cameras' warped maps and a 2-channel
coordinate map, concatenated, go through the map head (`map_classifier`:
3x3 convolutions at dilations 1, 2 and 4), which scores each cell.
Upstream's final resize of the score map to the grid is the identity here:
the grid is the dataset's BEV grid, whose cells are upstream's 4 x 4
world-grid units (Wildtrack's and MultiviewX's).

Module names are upstream's state-dict keys: the trunk as `base_pt1`
(conv1, bn1, relu, maxpool, layer1-3) and `base_pt2` (layer4). Serving runs
in eval mode, the BatchNorms on their running statistics. Spans:
`forward`, `backbone`, `projection` (the warp and the coordinate map; the
image head's `heads` inside it), `heads` (the map head).

Edges: images (B, N, H, W, 3) in [0, 1], positions (N, L, W, 2); returns
heatmap (B, 1, L, W), the map head's raw scores, and img_heatmap
(B, N, 2, h, w).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from vfa_tpu_torch import observability
from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.model.resnet import batch_norm, resnet_stages
from vfa_tpu_torch.model.vfanet import IMAGENET_MEAN, IMAGENET_STD, RESNET_LAYERS
from vfa_tpu_torch.ops.projection import project_world, project_world_plain

BASE = "resnet18"             # upstream's trunk
DILATE = (False, True, True)  # stages 2-4: dilate instead of striding
FEATURES = 512       # the trunk's channels at /8
IMG_REDUCE = 4       # the upsampled maps: the calibration's image size over this
GRID_REDUCE = 4      # a map cell's side in world-grid units


class MVDet(nn.Module):
    def __init__(self, cfg: DatasetConfig):
        super().__init__()
        if tuple(cfg.cube_size[:2]) != (GRID_REDUCE, GRID_REDUCE):
            raise ValueError(f"the BEV grid's cells are {cfg.cube_size[:2]} world-grid units, "
                             f"MVDet's map cells {GRID_REDUCE}")
        self.cfg = cfg
        self.upsample_shape = tuple(int(s / IMG_REDUCE) for s in cfg.image_size)
        stages = resnet_stages(RESNET_LAYERS[BASE], batch_norm, dilate=DILATE)
        self.base_pt1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), batch_norm(64), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2, 1), *stages[:3])
        self.base_pt2 = nn.Sequential(stages[3])
        self.img_classifier = nn.Sequential(
            nn.Conv2d(FEATURES, 64, 1), nn.ReLU(inplace=True),
            nn.Conv2d(64, 2, 1, bias=False))
        self.map_classifier = nn.Sequential(
            nn.Conv2d(FEATURES * cfg.num_cam + 2, 512, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(512, 512, 3, padding=2, dilation=2), nn.ReLU(inplace=True),
            nn.Conv2d(512, 1, 3, padding=4, dilation=4, bias=False))
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD), persistent=False)
        self.register_buffer("coord_map", coord_map(*cfg.grid_shape), persistent=False)

    def trunk(self, images: torch.Tensor) -> torch.Tensor:
        """images (M, H, W, 3) in [0, 1] -> the /8 features (M, 512, h8, w8)."""
        mean, std = (t.to(images.dtype) for t in (self.img_mean, self.img_std))
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        with observability.span("backbone"):
            return self.base_pt2(self.base_pt1(x))

    def image_head(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (M, C, h8, w8) -> the head and foot maps (M, 2, h, w): the
        first 1x1 convolution with its bias on the /8 features, then the
        bilinear upsampling (align_corners=False), the ReLU and the second
        1x1, in the features' dtype. The 64 channels go from channels-last
        to NCHW first: the upsampling and the second 1x1 take 7.5 ms so at
        batch 32 on an H100, 19.5 ms channels-last."""
        x = self.img_classifier[0](feats).contiguous()
        x = F.interpolate(x, self.upsample_shape, mode="bilinear", align_corners=False)
        return self.img_classifier[2](self.img_classifier[1](x))

    def project(self, feats: torch.Tensor, positions: torch.Tensor):
        """feats (B, N, C, h8, w8), positions (N, L, W, 2) -> the world
        features (B, N*C + 2, L, W) in the features' dtype and the image
        head's maps (B, N, 2, h, w). The image head on every camera at
        once, then every camera's warped features (`ops/projection.py`: one
        kernel launch when `_one_launch`, else the library composition),
        then the coordinate map."""
        B, N, C = feats.shape[:3]
        L, W = positions.shape[1:3]
        with observability.span("heads"):
            img = self.image_head(feats.flatten(0, 1)).unflatten(0, (B, N))
        world = feats.new_empty((B, N * C + 2, L, W))
        project = project_world if self._one_launch(feats) else project_world_plain
        project(feats, positions, self.upsample_shape, world)
        world[:, N * C:] = self.coord_map.to(feats.dtype)
        return world, img

    @staticmethod
    def _one_launch(feats: torch.Tensor) -> bool:
        """Whether the warp goes through `project_world`: bf16 features that
        need no gradient (the wrapper launches the kernel on a card and runs
        the plain version on the CPU). The kernel saves nothing for a
        backward, so every call that needs one, and every other dtype, takes
        the library composition, which autograd differentiates."""
        return feats.dtype == torch.bfloat16 and not feats.requires_grad

    @observability.traced("forward")
    def forward(self, images: torch.Tensor, positions: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, N = images.shape[:2]
        feats = self.trunk(images.reshape(B * N, *images.shape[2:]))
        with observability.span("projection"):
            world, img = self.project(feats.unflatten(0, (B, N)), positions)
        with observability.span("heads"):
            heatmap = self.map_classifier(world)
        return {"heatmap": heatmap, "img_heatmap": img}


def coord_map(L: int, W: int) -> torch.Tensor:
    """(1, 2, L, W): x across the columns, then y down the rows, each from
    -1 to 1 (upstream's `create_coord_map`)."""
    x = torch.arange(W, dtype=torch.float64) / (W - 1) * 2 - 1
    y = torch.arange(L, dtype=torch.float64) / (L - 1) * 2 - 1
    return torch.stack([x.expand(L, W), y[:, None].expand(L, W)])[None].float()


@torch.no_grad()
def init_weights(model: MVDet, generator: torch.Generator) -> MVDet:
    """Seeded weights as upstream initialises them, drawn on the CPU: the
    trunk torchvision's (convolutions Kaiming-normal, fan-out, for ReLU;
    BatchNorm (1, 0), running statistics (0, 1)); the classifiers torch's
    default (weights and biases uniform in +-1/sqrt(fan_in))."""
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            mod.reset_running_stats()
    for seq in (model.base_pt1, model.base_pt2):
        for mod in seq.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 * math.sqrt(2.0 / fan_out))
    for seq in (model.img_classifier, model.map_classifier):
        for mod in seq.modules():
            if isinstance(mod, nn.Conv2d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    return model
