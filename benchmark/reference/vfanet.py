"""Plain PyTorch reference of the VFA multiview detector, written from the
published description (Jiahao-Ma/VFA: `vfa/model/resnet.py`,
`vfa/model/vfanet.py`, `vfa/model/vfa_op.py`, `vfa/model/loss.py`,
`vfa/data/encoder.py`), for the benchmark's correctness check only.

It imports nothing of the program under test and takes nothing the program
made: the weights come from the benchmark (`weights.py`), the voxel
sampling is worked out again from the calibrations, the BEV grid and the
lateral features. Precision: fp32 with TF32 off, the voxel sampling (the
integral image, its corner reads and the box means) in fp64. With `low`
set, every convolution and linear layer (the collapse included) and the
sampling's input read their operands rounded to a lower precision, in
the forward and in the backward (the gradients too), accumulating in fp32,
as kernels in that precision would: 'fp8' (e4m3 forward, e5m2 gradients,
one scale a tensor) is the benchmark's control; 'bf16' is a twin of the
program's precision, a witness of how far rounding alone moves the
numbers.

Layout at the edges: images (B, N, H, W, 3) in [0, 1]; predictions
heatmap (B, 1, L, W), loc_offset (B, L, W, 2) and, in 3D mode,
dim_offset (B, L, W, 3), rotation (B, L, W, angle_bins).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GN_GROUPS, GN_EPS, BN_EPS = 16, 1e-5, 1e-5
EPSILON, MAX_AREA_RATIO = 1e-6, 0.3      # vfa_op.py: box area bounds
CRANGE = (-1.0, 0.95)                    # vfa_op.py: normalised box clamp
FP8_MAX = 448.0                          # largest float8 e4m3 value


def _scaled(fmt, top: float):
    def rnd(x: torch.Tensor) -> torch.Tensor:
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(fmt).to(x.dtype) * scale
    return rnd


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


# (forward operands, gradients): fp8 as fp8 training takes it, e4m3 for the
# activations and weights and e5m2 for the gradients, one scale a tensor
# (the largest magnitude to the format's largest value); bf16 as it is
ROUNDING = {"fp8": (_scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)),
            "bf16": (_bf16, _bf16)}


class _Round(torch.autograd.Function):
    """x rounded by `fwd`; the gradient that comes back rounded by `bwd`."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


class _LowConv(torch.autograd.Function):
    """A convolution whose operands are rounded, forward and backward (the
    output's gradient too), accumulating in fp32."""

    @staticmethod
    def forward(ctx, x, w, b, conf, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf, ctx.bwd, ctx.bias = conf, bwd, b is not None
        return F.conv2d(xq, wq, b, *conf)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.bwd(g)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, *ctx.conf) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, *ctx.conf) \
            if ctx.needs_input_grad[1] else None
        gb = g.sum((0, 2, 3)) if ctx.bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None, None, None


class _LowLinear(torch.autograd.Function):
    """A linear layer whose operands are rounded, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, b, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.bwd = bwd
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.bwd(g)
        gx = gq @ wq if ctx.needs_input_grad[0] else None
        gw = (gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
              if ctx.needs_input_grad[1] else None)
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None, None




def voxel_geometry(ds: dict, calib: torch.Tensor, grid: torch.Tensor, feat_hw) -> tuple:
    """For one camera (3, 4) and one feature size (fh, fw): the corner points
    lt, rb, rt, lb of every voxel's projected box (nl*L*W, 4, 2), (x, y) in
    [-1, 1] image coordinates, the box area in feature pixels and whether
    the voxel is visible (nl*L*W,), all fp64 (`vfa_op.py`: the cube's 8
    corners on each z layer projected, the box over them clamped, visible
    where EPS < area < 0.3 of the map)."""
    l, w, h = ds["cube_size"]
    dev = grid.device
    cx = torch.tensor([-l / 2, l / 2, l / 2, -l / 2] * 2, dtype=torch.float64)
    cy = torch.tensor([-w / 2, -w / 2, w / 2, w / 2] * 2, dtype=torch.float64)
    cz = torch.tensor([0.0] * 4 + [float(h)] * 4, dtype=torch.float64)
    corner = torch.stack([cx, cy, cz], -1).to(dev)                          # (8, 3)
    z = torch.arange(0, ds["grid_h"], h, dtype=torch.float64, device=dev)
    pts = (torch.as_tensor(grid, device=dev).double()[None, :, :, None, :] + corner
           + F.pad(z[:, None], (2, 0))[:, None, None, None, :])           # (nl, L, W, 8, 3)
    if ds["name"] == "MultiviewX":
        pts = pts / 40.0
    elif ds["name"] == "Wildtrack":
        pts = pts * 2.5 + torch.tensor([-300.0, -900.0, 0.0], dtype=torch.float64, device=dev)
    c = torch.as_tensor(calib, device=dev).double()
    hom = pts @ c[:, :3].T + c[:, 3]
    xy = hom[..., :2] / hom[..., 2:3]
    ih, iw = ds["image_size"]
    nx = (2.0 * xy[..., 0] / iw - 1.0).clamp(*CRANGE)
    ny = (2.0 * xy[..., 1] / ih - 1.0).clamp(*CRANGE)
    le, to, ri, bo = nx.amin(-1), ny.amin(-1), nx.amax(-1), ny.amax(-1)
    fh, fw = feat_hw
    area = (ri - le) * (bo - to) * (fh * fw) + EPSILON
    visible = (area > EPSILON) & (area < fh * fw * MAX_AREA_RATIO)
    corners = torch.stack([torch.stack(p, -1) for p in
                           ((le, to), (ri, bo), (ri, to), (le, bo))], -2)
    return corners.reshape(-1, 4, 2), area.reshape(-1), visible.reshape(-1)


def tap_matrix(corners: torch.Tensor, area: torch.Tensor, visible: torch.Tensor,
               feat_hw) -> torch.Tensor:
    """The voxel means as a sparse (V, fh*fw) fp64 matrix over the integral
    image: each voxel reads its box's corners lt, rb, rt, lb with signs
    +, +, -, -, each corner a bilinear read of 4 pixels as torch's
    grid_sample takes it (align_corners=False: pixel x at ((x + 1) * fw -
    1) / 2; a pixel outside the map reads 0), all over the box's area, and
    nothing where the voxel is not visible."""
    fh, fw = feat_hw
    V = corners.shape[0]
    x = ((corners[..., 0] + 1.0) * fw - 1.0) / 2.0                          # (V, 4)
    y = ((corners[..., 1] + 1.0) * fh - 1.0) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float64, device=corners.device)
    scale = sign * (visible.double() / area)[:, None]
    cols, vals = [], []
    for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
        w = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
        inside = (xi >= 0) & (xi <= fw - 1) & (yi >= 0) & (yi <= fh - 1)
        cols.append((yi.clamp(0, fh - 1) * fw + xi.clamp(0, fw - 1)).long())
        vals.append(w * inside * scale)
    cols, vals = torch.stack(cols, -1).reshape(V, 16), torch.stack(vals, -1).reshape(V, 16)
    rows = torch.arange(V, device=corners.device)[:, None].expand(V, 16)
    keep = vals != 0
    return torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]), vals[keep],
                                   (V, fh * fw), check_invariants=False).coalesce()


def feature_shapes(resize_size) -> list:
    """(fh, fw) of the /8, /16, /32 maps: each stride-2 stage takes ceil(x/2)."""
    h, w = resize_size
    out = []
    for stage in range(5):
        h, w = (h + 1) // 2, (w + 1) // 2
        if stage >= 2:
            out.append((h, w))
    return out



class Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.GroupNorm(GN_GROUPS, cout, eps=GN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.GroupNorm(GN_GROUPS, cout, eps=GN_EPS)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.GroupNorm(GN_GROUPS, cout, eps=GN_EPS))
        else:
            self.downsample = None


class Trunk(nn.Module):
    """ResNet-18/34 with GroupNorm(16): the /8, /16, /32 maps."""

    def __init__(self, layers):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.GroupNorm(GN_GROUPS, 64, eps=GN_EPS)
        cin = 64
        for i, (cout, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = [Block(cin if b == 0 else cout, cout, (1 if i == 1 else 2) if b == 0 else 1)
                      for b in range(n)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            cin = cout


class Collapse(nn.Module):
    def __init__(self, nl: int):
        super().__init__()
        self.collapse = nn.Linear(256 * nl, 256)


class ReferenceVFA(nn.Module):
    """The model. Module names are the upstream checkpoint's keys, so a
    state dict loads into the program and here alike. `ds` is the
    configuration's `dataset` group, `model` its `model` group."""

    def __init__(self, ds: dict, model: dict, low: str | None = None):
        super().__init__()
        self.ds = ds
        self.round = ROUNDING[low] if low else None
        self.nl = len(range(0, ds["grid_h"], ds["cube_size"][2]))
        self.base = Trunk(model["resnet_layers"])
        for s, cin in zip((8, 16, 32), (128, 256, 512)):
            setattr(self, f"lat{s}", nn.Conv2d(cin, 256, 1))
            setattr(self, f"bn{s}", nn.GroupNorm(GN_GROUPS, 256, eps=GN_EPS))
            setattr(self, f"vfa{s}", Collapse(self.nl))
        self.fuse = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1), nn.BatchNorm2d(256, eps=BN_EPS), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=2, dilation=2), nn.BatchNorm2d(256, eps=BN_EPS),
            nn.ReLU())
        self.map_classifier = nn.Sequential(nn.Conv2d(256, 1, 3, padding=4, dilation=4, bias=False))
        self.tytx_pred = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1), nn.GroupNorm(GN_GROUPS, 256, eps=GN_EPS),
            nn.ReLU(), nn.Conv2d(256, 2, 3, padding=1, bias=False))
        if ds["mode"] == "3D":
            self.orient_pred = nn.Sequential(
                nn.Conv2d(256, model["angle_bins"], 3, padding=4, dilation=4, bias=False))
            self.thtwtl_pred = nn.Sequential(
                nn.Conv2d(256, 256, 3, padding=1), nn.GroupNorm(GN_GROUPS, 256, eps=GN_EPS),
                nn.ReLU(), nn.Conv2d(256, 3, 3, padding=1, bias=False))
        self._taps = {}

    # -- layers -------------------------------------------------------------
    def q(self, x):
        return _Round.apply(x, *self.round) if self.round else x

    def conv(self, m: nn.Conv2d, x):
        conf = (m.stride, m.padding, m.dilation)
        if self.round:
            return _LowConv.apply(x, m.weight, m.bias, conf, *self.round)
        return F.conv2d(x, m.weight, m.bias, *conf)

    def linear(self, m: nn.Linear, x):
        if self.round:
            return _LowLinear.apply(x, m.weight, m.bias, *self.round)
        return F.linear(x, m.weight, m.bias)

    def block(self, b: Block, x):
        out = F.relu(b.bn1(self.conv(b.conv1, x)))
        out = b.bn2(self.conv(b.conv2, out))
        idn = x if b.downsample is None else b.downsample[1](self.conv(b.downsample[0], x))
        return F.relu(out + idn)

    def laterals(self, images: torch.Tensor) -> list:
        """images (M, H, W, 3) -> three lateral maps (M, 256, fh, fw)."""
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        t = self.base
        x = F.max_pool2d(F.relu(t.bn1(self.conv(t.conv1, x))), 3, 2, 1)
        feats = []
        for layer in (t.layer1, t.layer2, t.layer3, t.layer4):
            for b in layer:
                x = self.block(b, x)
            feats.append(x)
        return [F.relu(getattr(self, f"bn{s}")(self.conv(getattr(self, f"lat{s}"), f)))
                for s, f in zip((8, 16, 32), feats[1:])]

    # -- voxel sampling, from the calibrations ------------------------------
    def taps(self, calib: torch.Tensor, grid: torch.Tensor, feat_hw) -> torch.Tensor:
        """The sampling of one camera at one feature size as a sparse fp64
        matrix (nl*L*W voxels, fh*fw pixels) over the integral image (built
        once, kept)."""
        key = (tuple(calib.flatten().tolist()), tuple(feat_hw))
        if key not in self._taps:
            self._taps[key] = tap_matrix(*voxel_geometry(self.ds, calib, grid, feat_hw), feat_hw)
        return self._taps[key]

    def sample(self, lat: torch.Tensor, calib, grid, collapse: nn.Linear) -> torch.Tensor:
        """One camera, one scale: lat (S, 256, fh, fw) -> relu(collapse(vox))
        (S, L*W, 256) in fp32. vox[c*nl + l] is the mean of channel c over
        layer l's projected box: four bilinear reads of the integral image
        (fp64), vox = (lt + rb - rt - lb) / area, zero where the box is
        not visible (`tap_matrix`)."""
        S, C, fh, fw = lat.shape
        ii = self.q(lat).double().cumsum(-1).cumsum(-2).reshape(S * C, fh * fw)
        vox = torch.sparse.mm(self.taps(calib, grid, (fh, fw)), ii.T)        # (V, S*C)
        vox = vox.reshape(self.nl, -1, S, C).permute(2, 1, 3, 0)            # (S, L*W, C, nl)
        vox = vox.reshape(S, -1, C * self.nl).float()
        return F.relu(self.linear(collapse, vox))

    def bev(self, images: torch.Tensor, calibs: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        """images (S, N, H, W, 3) -> BEV features (S, 256, L, W) fp32: the
        sum over cameras and scales of each one's collapsed features."""
        S, N = images.shape[:2]
        L, W = grid.shape[:2]
        lats = self.laterals(images.reshape(S * N, *images.shape[2:]))
        out = 0.0
        for s, lat in zip((8, 16, 32), lats):
            lat = lat.reshape(S, N, *lat.shape[1:])
            for n in range(N):
                out = out + self.sample(lat[:, n], calibs[n], grid,
                                        getattr(self, f"vfa{s}").collapse)
        return out.reshape(S, L, W, 256).permute(0, 3, 1, 2)

    def heads(self, ortho: torch.Tensor) -> dict:
        f = self.fuse
        x = f[2](f[1](self.conv(f[0], ortho)))
        fused = f[5](f[4](self.conv(f[3], x)))

        def head(seq, x):
            x = F.relu(seq[1](self.conv(seq[0], x)))
            return self.conv(seq[3], x).permute(0, 2, 3, 1)

        pred = {"heatmap": self.conv(self.map_classifier[0], fused),
                "loc_offset": head(self.tytx_pred, ortho)}
        if self.ds["mode"] == "3D":
            pred["dim_offset"] = head(self.thtwtl_pred, ortho)
            pred["rotation"] = self.conv(self.orient_pred[0], fused).permute(0, 2, 3, 1)
        return pred

    def forward(self, images, calibs, grid) -> dict:
        return self.heads(self.bev(images, calibs, grid))


# the name every architecture's reference gives its model (`cell.py`)
Reference = ReferenceVFA


# -- decode -------------------------------------------------------------------
@torch.no_grad()
def decode(pred: dict, cfg: dict) -> dict:
    """Detections (B, K) of predictions under the configuration's decode
    settings: sigmoid, 5x5 max-pool NMS, the k highest scores (ties in
    index order), the threshold, the cell plus sigmoid offset in world
    units, exp(dim offset) * class mean, the CSL bin's angle in radians."""
    ds, dim_mean = cfg["dataset"], cfg["model"]["dim_mean"]
    cls_thresh, topk = cfg["decode"]["cls_thresh"], cfg["decode"]["topk"]
    hm = pred["heatmap"].float()
    B, _, L, W = hm.shape
    dev = hm.device
    s = torch.sigmoid(hm)
    conf_map = torch.where(F.max_pool2d(s, 5, 1, 2) == s, s, torch.zeros_like(s)).reshape(B, -1)
    k = min(topk, conf_map.shape[1])
    conf, idx = torch.sort(conf_map, dim=1, descending=True, stable=True)
    conf, idx = conf[:, :k], idx[:, :k]
    gy, gx = torch.meshgrid(torch.arange(L, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    ws = np.asarray(ds["world_size"], np.float64)
    gs = ws / np.asarray(ds["cube_size"][:2], np.float64)
    off = torch.sigmoid(pred["loc_offset"].float())
    cy = ((gy + off[..., 0]) / float(gs[0]) * float(ws[0])).reshape(B, -1).gather(1, idx)
    cx = ((gx + off[..., 1]) / float(gs[1]) * float(ws[1])).reshape(B, -1).gather(1, idx)
    zero = torch.zeros_like(cy)
    out = {"conf": conf, "valid": conf > cls_thresh}
    if ds["mode"] == "3D":
        dims = torch.exp(pred["dim_offset"].float().reshape(B, -1, 3)
                         .gather(1, idx[..., None].expand(-1, -1, 3)))
        out["dimension"] = dims * torch.as_tensor(np.asarray(dim_mean), dtype=torch.float32,
                                                  device=dev)
        rot = pred["rotation"].float()
        bins = torch.argmax(rot.reshape(B, -1, rot.shape[-1]), -1).gather(1, idx)
        out["rotation"] = torch.deg2rad(bins.to(torch.float32))
        out["location"] = torch.stack([cx, cy, zero], -1)
    elif ds["name"] == "Wildtrack":
        out["location"] = torch.stack([cy, cx, zero], -1)
    else:
        out["location"] = torch.stack([cx, cy, zero], -1)
    return out


# -- training -----------------------------------------------------------------
def csl_labels(deg: torch.Tensor, bins: int, sigma: float = 6.0) -> torch.Tensor:
    """Circular smooth labels (..., bins) of angles in degrees (truncated)."""
    label = torch.trunc(deg).long()
    x = torch.arange(-(bins // 2), bins - bins // 2, dtype=torch.float32, device=deg.device)
    y = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    idx = torch.remainder(torch.arange(bins, device=deg.device) - (label[..., None] - bins // 2),
                          bins)
    return y[idx]


def targets(batch: dict, ds: dict, dim_mean, bins: int) -> dict:
    """Dense targets of the padded objects: mask (B, 1, L, W), the heatmap,
    loc_offset (B, L, W, 2) and, in 3D mode, dim_offset and the CSL
    rotation. A later object on the same cell wins."""
    hm = batch["heatmap"].float()
    B, L, W = hm.shape
    dev = hm.device
    loc = batch["location"].float().cpu().numpy()
    valid = batch["valid"].cpu().numpy()
    mask = torch.zeros(B, 1, L, W, device=dev)
    off = torch.zeros(B, L, W, 2, device=dev)
    out = {"heatmap": hm[:, None], "mask": mask, "loc_offset": off}
    if ds["mode"] == "3D":
        out["dim_offset"] = torch.zeros(B, L, W, 3, device=dev)
        out["rotation"] = torch.zeros(B, L, W, bins, device=dev)
        dims = batch["dimension"].float()
        rots = csl_labels(torch.rad2deg(batch["rotation"].float()), bins)
        mean = torch.as_tensor(np.asarray(dim_mean), dtype=torch.float32, device=dev)
    gs = np.asarray((L, W), np.float32)
    ws = np.asarray(ds["world_size"], np.float32)
    for b in range(B):
        for m in range(loc.shape[1]):
            if valid[b, m] <= 0:
                continue
            g = loc[b, m, :2].astype(np.float32) / ws * gs
            cx, cy = int(np.floor(g[0])), int(np.floor(g[1]))
            r, c = (cx, cy) if ds["name"] == "Wildtrack" else (cy, cx)
            if not (-L <= r < L and -W <= c < W):
                continue
            r, c = r % L, c % W
            mask[b, 0, r, c] = 1.0
            off[b, r, c] = torch.from_numpy(g - np.floor(g))
            if ds["mode"] == "3D":
                out["dim_offset"][b, r, c] = torch.log(dims[b, m] / mean)
                out["rotation"][b, r, c] = rots[b, m]
    return out


def _focal(logits, gt, pos, neg, alpha=2.0, beta=4.0, eps=1e-5):
    p = torch.sigmoid(logits).clamp(eps, 1 - eps)
    n_pos, n_neg = pos.float().sum(), neg.float().sum()
    lp = -(((1 - p) ** alpha) * torch.log(p) * pos).sum()
    ln = -(((1 - gt) ** beta) * (p ** alpha) * torch.log(1 - p) * neg).sum()
    return (lp / n_pos if n_pos > 0 else lp * 0) + (ln / n_neg if n_neg > 0 else ln * 0)


def _smooth_l1(a, b):
    d = (a - b).abs()
    return torch.where(d < 1, 0.5 * d * d, d - 0.5)


def loss(pred: dict, gt: dict, ds: dict, weights) -> torch.Tensor:
    """The weighted sum of the heatmap focal loss, the smooth-L1 offsets
    (per positive cell) and, in 3D mode, the dimension offsets and the CSL
    angle focal loss at the positive cells."""
    pos = gt["heatmap"] == 1.0
    l_hm = _focal(pred["heatmap"].float(), gt["heatmap"], pos, ~pos)
    mask = gt["mask"].permute(0, 2, 3, 1)
    n = gt["mask"].sum().clamp(min=1.0)
    l_yx = (_smooth_l1(torch.sigmoid(pred["loc_offset"].float()), gt["loc_offset"]) * mask).sum() / n
    if ds["mode"] != "3D":
        return l_hm * weights[0] + l_yx * weights[1]
    l_dim = (_smooth_l1(pred["dim_offset"].float(), gt["dim_offset"]) * mask).sum() / n
    cell = mask == 1.0
    rot_gt = gt["rotation"]
    l_ang = _focal(pred["rotation"].float(), rot_gt, (rot_gt == 1.0) & cell, (rot_gt != 1.0) & cell)
    hm_w, pos_w, dim_w, ang_w = weights
    return l_yx * pos_w + l_dim * dim_w + l_hm * hm_w + l_ang * ang_w


def train_steps(model: ReferenceVFA, batches: list, calibs, grid, cfg: dict) -> dict:
    """len(batches) steps of SGD (momentum, weight decay; the
    configuration's `train` group) under torch's OneCycleLR, stepped once
    an epoch as the upstream trainer does (so every step here takes the
    schedule's step 1). Each batch is (images
    (B, N, H, W, 3) fp32, ground truth). The BEV features of a batch are
    computed a scene at a time without a graph, the fuse block, heads and
    loss on the whole batch (the BatchNorms take its statistics), and each
    scene's backbone and sampling again with a graph, fed the BEV
    gradient (a recompute, which changes no value).

    Returns the loss of each step, the first step's predictions, its
    gradients and each parameter's change over all steps, by name."""
    recipe, dim_mean, bins = cfg["train"], cfg["model"]["dim_mean"], cfg["model"]["angle_bins"]
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.SGD(model.parameters(), lr=recipe["lr"], momentum=0.9,
                          weight_decay=recipe["weight_decay"])
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=recipe["lr"], total_steps=recipe["steps_per_epoch"] * recipe["epochs"])
    with warnings.catch_warnings():   # "step() before optimizer.step()": on purpose
        warnings.simplefilter("ignore", UserWarning)
        sched.step()                  # the trainer's step before its first epoch
    losses, first_grads, first_pred = [], None, None
    model.train()
    for images, truth in batches:
        opt.zero_grad(set_to_none=True)
        S = images.shape[0]
        with torch.no_grad():
            ortho = torch.cat([model.bev(images[b:b + 1], calibs, grid) for b in range(S)])
        ortho.requires_grad_(True)
        pred = model.heads(ortho)
        total = loss(pred, targets(truth, model.ds, dim_mean, bins), model.ds,
                     model.ds["loss_weight"])
        total.backward()
        for b in range(S):
            model.bev(images[b:b + 1], calibs, grid).backward(ortho.grad[b:b + 1])
        losses.append(float(total.detach()))
        if first_grads is None:
            first_grads = {k: p.grad.detach().clone() for k, p in params.items()}
            first_pred = {k: v.detach() for k, v in pred.items()}
        opt.step()
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return {"losses": losses, "pred": first_pred, "grads": first_grads, "change": change}


@torch.no_grad()
def train_forward(model: ReferenceVFA, images, calibs, grid) -> dict:
    """The predictions of a training-mode forward on a batch (the
    BatchNorms on its statistics), the BEV features a scene at a time."""
    model.train()
    S = images.shape[0]
    return model.heads(torch.cat([model.bev(images[b:b + 1], calibs, grid) for b in range(S)]))


def init_state(model: ReferenceVFA, generator: torch.Generator, device) -> dict:
    """Seeded weights for every key of the model's state dict, made on
    `device` in one call: each conv / linear weight and bias uniform in
    +-1/sqrt(fan_in) (torch's default bound), norm scales 1 and shifts 0,
    BatchNorm statistics (0, 1)."""
    mods = dict(model.named_modules())
    sd = model.state_dict()
    draws = [(k, v.shape) for k, v in sd.items()
             if isinstance(mods[k.rsplit(".", 1)[0]], (nn.Conv2d, nn.Linear))]
    total = sum(math.prod(s) for _, s in draws)
    flat = torch.rand(total, generator=generator, device=device) * 2 - 1
    out, at = {}, 0
    for k, v in sd.items():
        mod = mods[k.rsplit(".", 1)[0]]
        name = k.rsplit(".", 1)[1]
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            n = v.numel()
            out[k] = flat[at:at + n].reshape(v.shape) / math.sqrt(mod.weight[0].numel())
            at += n
        elif name in ("weight", "running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif name == "num_batches_tracked":
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out
