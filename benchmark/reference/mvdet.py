"""Plain PyTorch reference of MVDet (Hou, Zheng, Gould, ECCV 2020;
github.com/hou-yz/MVDet, `multiview_detector/models/persp_trans_detector.py`,
`PerspTransDetector`, and its `models/resnet.py`), written from the
published description, for the benchmark's correctness check only.

It imports nothing of the program under test and takes nothing the program
made: the weights come from the benchmark, and the perspective transform is
worked out again from the calibrations and the BEV grid: each cell's ground
point (z = 0) in world coordinates, through the camera's 3x4 matrix, scaled
to the upsampled map, in fp64, and its four bilinear taps gathered one by
one. Precision: fp32 with TF32 off, the warp's weights and sums in fp64.
With `low` set, every convolution reads its operands (input and weight)
rounded, and the projection's output (the warped maps and the coordinate
map) is rounded, where the program rounds them: 'bf16' is a twin of the
program's precision, 'fp8' (e4m3, one scale a tensor) the benchmark's
control. Serving only: MVDet's training (its Gaussian targets and losses,
BatchNorm statistics per camera) is out of scope here.

Layers: the ImageNet normalisation; a ResNet trunk with BatchNorm whose
stages 3 and 4 dilate instead of striding (torchvision's rule: a stage's
first block keeps the dilation before it, its other blocks take the stage's;
both 3x3 convolutions of a block dilated and padded by its dilation), 512
channels at /8; bilinear upsampling (align_corners=False) to the
calibration's image size over `img_reduce`; the image head (1x1 to 64,
ReLU, 1x1 to 2 without bias); the warp onto the grid; the 7 maps and the
coordinate map (x, then y, each -1 to 1) concatenated; the map head (3x3 to
512, ReLU, 3x3 dilation 2, ReLU, 3x3 dilation 4 to 1 without bias).

Layout at the edges: images (B, N, H, W, 3) in [0, 1]; predictions heatmap
(B, 1, L, W), the raw scores, and img_heatmap (B, N, 2, h, w).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
FEATURES = 512


def _scaled(fmt, top: float):
    def rnd(x: torch.Tensor) -> torch.Tensor:
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(fmt).to(x.dtype) * scale
    return rnd


ROUNDING = {"fp8": _scaled(torch.float8_e4m3fn, 448.0),
            "bf16": lambda x: x.to(torch.bfloat16).to(x.dtype)}


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and products in fp32, not TF32, for the block."""
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, dilation, dilation=dilation, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, dilation, dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=BN_EPS)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout, eps=BN_EPS))
        else:
            self.downsample = None


def stages(layers, dilate) -> list:
    """The four stages (torchvision's `_make_layer`, module docstring)."""
    out, cin, dilation = [], 64, 1
    for i, (cout, n) in enumerate(zip((64, 128, 256, 512), layers)):
        stride, before = (1 if i == 0 else 2), dilation
        if i > 0 and dilate[i - 1]:
            dilation, stride = dilation * stride, 1
        out.append(nn.Sequential(*[Block(cin if b == 0 else cout, cout, stride if b == 0 else 1,
                                         before if b == 0 else dilation) for b in range(n)]))
        cin = cout
    return out


def positions(ds: dict, calib: torch.Tensor, grid: torch.Tensor, map_hw) -> torch.Tensor:
    """(L, W, 2) fp64: where each cell's ground point falls in one camera's
    upsampled map of `map_hw`, (x, y) pixel indices: the world-grid point
    (the grid's x, y; z = 0) in world coordinates, through `calib` (3, 4)
    at the calibration's image size, divided by its depth, scaled by the
    map's size over the image's."""
    g = torch.as_tensor(grid).double()
    pts = torch.stack([g[..., 0], g[..., 1], torch.zeros_like(g[..., 0])], -1)
    if ds["name"] == "MultiviewX":
        pts = pts / 40.0
    elif ds["name"] == "Wildtrack":
        pts = pts * 2.5 + torch.tensor([-300.0, -900.0, 0.0], dtype=torch.float64,
                                       device=pts.device)
    c = torch.as_tensor(calib).double().to(pts.device)
    hom = pts @ c[:, :3].T + c[:, 3]
    (ih, iw), (h, w) = ds["image_size"], map_hw
    return torch.stack([hom[..., 0] / hom[..., 2] * (w / iw),
                        hom[..., 1] / hom[..., 2] * (h / ih)], -1)


def warp_taps(pos: torch.Tensor, map_hw) -> list:
    """The four bilinear taps of each position (L, W, 2): (flat pixel index,
    fp64 weight) pairs, the weight 0 where the tap lies outside the map."""
    h, w = map_hw
    x, y = pos[..., 0].reshape(-1), pos[..., 1].reshape(-1)
    x0, y0 = torch.floor(x), torch.floor(y)
    taps = []
    for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
        weight = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        taps.append((index, weight * inside))
    return taps


class Reference(nn.Module):
    """The model. Module names are upstream's state-dict keys (`base_pt1`,
    `base_pt2`, `img_classifier`, `map_classifier`), so a state dict loads
    into the program and here alike. `ds` is the configuration's `dataset`
    group, `model` its `model` group."""

    def __init__(self, ds: dict, model: dict, low: str | None = None):
        super().__init__()
        self.ds = ds
        self.round = ROUNDING[low] if low else None
        self.map_hw = tuple(int(s / model["img_reduce"]) for s in ds["image_size"])
        self.grid_reduce = model["grid_reduce"]
        st = stages(model["resnet_layers"], model["dilation"])
        self.base_pt1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64, eps=BN_EPS), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1), *st[:3])
        self.base_pt2 = nn.Sequential(st[3])
        self.img_classifier = nn.Sequential(nn.Conv2d(FEATURES, 64, 1), nn.ReLU(),
                                            nn.Conv2d(64, 2, 1, bias=False))
        self.map_classifier = nn.Sequential(
            nn.Conv2d(FEATURES * ds["num_cam"] + 2, 512, 3, padding=1), nn.ReLU(),
            nn.Conv2d(512, 512, 3, padding=2, dilation=2), nn.ReLU(),
            nn.Conv2d(512, 1, 3, padding=4, dilation=4, bias=False))
        self._taps = {}

    # -- layers -------------------------------------------------------------
    def q(self, x):
        return self.round(x) if self.round else x

    def conv(self, m: nn.Conv2d, x):
        return F.conv2d(self.q(x), self.q(m.weight), m.bias, m.stride, m.padding, m.dilation)

    def bn(self, m: nn.BatchNorm2d, x):
        if self.training:
            raise NotImplementedError("the reference serves only: BatchNorm on running statistics")
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0,
                            m.eps)

    def block(self, b: Block, x):
        out = F.relu(self.bn(b.bn1, self.conv(b.conv1, x)))
        out = self.bn(b.bn2, self.conv(b.conv2, out))
        idn = x if b.downsample is None else self.bn(b.downsample[1],
                                                     self.conv(b.downsample[0], x))
        return F.relu(out + idn)

    def trunk(self, images: torch.Tensor) -> torch.Tensor:
        """images (M, H, W, 3) -> the /8 features (M, 512, h8, w8)."""
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        p1 = self.base_pt1
        x = F.max_pool2d(F.relu(self.bn(p1[1], self.conv(p1[0], x))), 3, 2, 1)
        for layer in (p1[4], p1[5], p1[6], self.base_pt2[0]):
            for b in layer:
                x = self.block(b, x)
        return x

    # -- the perspective transform, from the calibrations -------------------
    def taps(self, calib: torch.Tensor, grid: torch.Tensor) -> list:
        key = (tuple(calib.flatten().tolist()), tuple(grid.shape))
        if key not in self._taps:
            self._taps[key] = warp_taps(positions(self.ds, calib, grid, self.map_hw),
                                        self.map_hw)
        return self._taps[key]

    def warp(self, up: torch.Tensor, calib, grid) -> torch.Tensor:
        """up (S, C, h, w) -> (S, C, L, W) fp32: each cell the sum of its
        four taps' values times their weights, in fp64."""
        S, C = up.shape[:2]
        flat = up.reshape(S, C, -1)
        out = 0.0
        for index, weight in self.taps(calib, grid):
            out = out + flat.index_select(2, index).double() * weight
        return out.float().reshape(S, C, *grid.shape[:2])

    def coord_map(self, L: int, W: int, device) -> torch.Tensor:
        x = torch.arange(W, dtype=torch.float64, device=device) / (W - 1) * 2 - 1
        y = torch.arange(L, dtype=torch.float64, device=device) / (L - 1) * 2 - 1
        return torch.stack([x.expand(L, W), y[:, None].expand(L, W)]).float()

    def forward(self, images, calibs, grid) -> dict:
        with no_tf32():
            S, N = images.shape[:2]
            L, W = grid.shape[:2]
            feats = self.trunk(images.reshape(S * N, *images.shape[2:])).unflatten(0, (S, N))
            world, img = [], []
            for n in range(N):
                up = F.interpolate(feats[:, n], self.map_hw, mode="bilinear",
                                   align_corners=False)
                ic = self.img_classifier
                img.append(self.conv(ic[2], F.relu(self.conv(ic[0], up))))
                world.append(self.q(self.warp(up, calibs[n], grid)))
            world.append(self.q(self.coord_map(L, W, images.device)).expand(S, -1, -1, -1))
            mc = self.map_classifier
            x = F.relu(self.conv(mc[0], torch.cat(world, 1)))
            x = F.relu(self.conv(mc[2], x))
            return {"heatmap": self.conv(mc[4], x), "img_heatmap": torch.stack(img, 1)}


# -- decode -------------------------------------------------------------------
@torch.no_grad()
def decode(pred: dict, cfg: dict) -> dict:
    """Detections (B, K) of the raw score map under the configuration's
    decode settings, as upstream's test loop: the `topk` highest scores
    (equal ones in cell order), each cell's position in world-grid units
    (Wildtrack's rows are x), and greedy suppression written as a loop:
    highest first, a candidate is dropped where one kept before it lies at
    most `nms_dist` away; valid where kept and above `cls_thresh`."""
    dec, g = cfg["decode"], cfg["model"]["grid_reduce"]
    hm = pred["heatmap"].float()
    B, _, L, W = hm.shape
    k = min(dec["topk"], L * W)
    conf, idx = torch.sort(hm.reshape(B, -1), dim=1, descending=True, stable=True)
    conf, idx = conf[:, :k], idx[:, :k]
    rows, cols = (idx // W).float() * g, (idx % W).float() * g
    first, second = (rows, cols) if cfg["dataset"]["name"] == "Wildtrack" else (cols, rows)
    location = torch.stack([first, second], -1)
    keep = torch.zeros(B, k, dtype=torch.bool)
    for b, pts in enumerate(location.cpu().tolist()):
        kept = []
        for i, p in enumerate(pts):
            if all(math.dist(p, pts[j]) > dec["nms_dist"] for j in kept):
                kept.append(i)
                keep[b, i] = True
    return {"conf": conf, "location": location,
            "valid": keep.to(hm.device) & (conf > dec["cls_thresh"])}


def train_steps(model, batches, calibs, grid, cfg):
    raise NotImplementedError("MVDet's training (its Gaussian targets and losses, BatchNorm "
                              "statistics per camera) is out of scope of this reference")


def train_forward(model, images, calibs, grid):
    raise NotImplementedError("MVDet's training is out of scope of this reference")


def init_state(model: Reference, generator: torch.Generator, device) -> dict:
    """Seeded weights for every key of the model's state dict, made on
    `device`, as upstream initialises them: the trunk's convolutions
    Kaiming-normal (fan-out, gain for ReLU: std sqrt(2 / (cout k k))), its
    BatchNorms (1, 0) with running statistics (0, 1), torchvision's; the
    classifiers' weights and biases torch's default, uniform in
    +-1/sqrt(fan_in). One normal draw for the trunk, one uniform draw for
    the classifiers."""
    mods = dict(model.named_modules())
    sd = model.state_dict()
    trunk = [k for k in sd if k.startswith("base_pt") and isinstance(mods[k.rsplit(".", 1)[0]],
                                                                     nn.Conv2d)]
    heads = [k for k in sd if k.startswith(("img_classifier", "map_classifier"))]
    normal = torch.randn(sum(sd[k].numel() for k in trunk), generator=generator, device=device)
    uniform = torch.rand(sum(sd[k].numel() for k in heads), generator=generator,
                         device=device) * 2 - 1
    out, at_n, at_u = {}, 0, 0
    for k, v in sd.items():
        mod, name = mods[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]
        n = v.numel()
        if k in trunk:
            fan_out = v.shape[0] * v[0, 0].numel()
            out[k] = normal[at_n:at_n + n].reshape(v.shape) * math.sqrt(2.0 / fan_out)
            at_n += n
        elif k in heads:
            out[k] = uniform[at_u:at_u + n].reshape(v.shape) / math.sqrt(mod.weight[0].numel())
            at_u += n
        elif name in ("weight", "running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif name == "num_batches_tracked":
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out
