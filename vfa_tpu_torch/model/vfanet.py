"""VFANet, the multiview BEV detection model (port of
`vfa_tpu/model/vfanet.py`).

In-graph ImageNet normalization, ResNet-GN pyramid, per-scale 1x1 laterals
(128/256/512 -> 256) + GN + ReLU, per-scale voxel sampling with the
collapse Linear(256*nl -> 256) + ReLU, summed over cameras and scales in
fp32, a fuse block (3x3 conv + BN + ReLU, dilated-2 3x3 conv + BN + ReLU), and
CenterNet-style heads. Sampling goes through a compiled rig (the rig
kernels, or their plain versions), or, with `rig=None`, through the
reference voxel route of `ops/voxel.py` from the calibrations. In training
mode the two BatchNorms normalize with
batch statistics and update their running buffers as flax does. Module
names follow the reference `.pth` keys (`vfa/model/vfanet.py:14-149`).
The public edge keeps the JAX layouts:
images (B, N, H, W, 3); outputs as at `vfa_tpu/model/vfanet.py:321-331`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from vfa_tpu_torch import observability
from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.model.resnet import ResNetGN, group_norm, remat
from vfa_tpu_torch.ops import rig_cuda
from vfa_tpu_torch.ops.rig import rig_bev
from vfa_tpu_torch.ops.voxel import sample_voxels, voxel_boxes

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


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, on bf16 inputs, rounds the convolution to bf16
    before it adds the bias, as flax's `nn.Conv` does (the product, then
    `y + bias`: two roundings; a bias fused into the convolution rounds
    once). Same parameters as nn.Conv2d; fp32 runs unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16 and self.bias is not None:
            return (self._conv_forward(x, self.weight, None)
                    + self.bias.view(1, -1, 1, 1))
        return super().forward(x)


class BatchNorm2dBiased(nn.BatchNorm2d):
    """BatchNorm2d whose running variance is updated with the biased batch
    variance, as flax `nn.BatchNorm` does (`nn.BatchNorm2d` uses the
    unbiased one), so a train step leaves the same running statistics as
    the JAX model. flax momentum 0.9 is `momentum=0.1` here. Same
    parameters and buffers as `nn.BatchNorm2d`.

    On bf16 inputs it rounds as flax does, with the running statistics
    cast to bf16 at use (a no-op after `cast_model`; fp32 buffers under
    mixed precision, `train_lib`): in eval mode it normalizes op by op in
    bf16, as flax's `_normalize` does, (x - mean) * (rsqrt(var + eps) *
    scale) + bias, each op rounded (`F.batch_norm` would round once); in
    training mode it takes flax's fp32 batch statistics (E[x^2] - E[x]^2,
    clipped at 0), normalizes in fp32 and rounds once, and writes back, in
    the buffers' dtype, flax's update on the bf16 statistics:
    bf16(bf16(0.9) * stat) + 0.1 * batch_stat, the first product in bf16
    (the Python scalar takes the array's dtype), the sum in fp32.

    With `stats_group` set (a process group; `VFANet.mesh` sets it to the
    mesh's data axis) the training statistics span the batches of all its
    ranks (`synced`), as GSPMD computes them over a sharded batch."""

    stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.stats_group is not None:
            import torch.distributed as dist

            from vfa_tpu_torch.parallel import sum_shared

            group = self.stats_group
            return self.synced(x, lambda s: sum_shared(s, group),
                               x.numel() // x.shape[1] * dist.get_world_size(group))
        if not self.training:
            if x.dtype == torch.bfloat16:
                shape = (1, -1, 1, 1)
                mean, var = (t.to(x.dtype).view(shape)
                             for t in (self.running_mean, self.running_var))
                mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
                return (x - mean) * mul + self.bias.view(shape)
            return super().forward(x)
        if x.dtype == torch.bfloat16:
            return self._train_bf16(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def synced(self, x: torch.Tensor, reduce, count: int) -> torch.Tensor:
        """The forward with the batch statistics of several ranks: the
        per-channel sums of x and x^2 (fp32) are summed by `reduce` (a
        differentiable all-reduce, `parallel.sum_shared`) and divided by
        `count`, the elements per channel of all of them; var = E[x^2] -
        E[x]^2, clipped at 0, as flax computes it; then `_normalize`. Eval
        mode: `forward`."""
        if not self.training:
            return self(x)
        xs = x.float()
        s = reduce(torch.stack([xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3))]))
        mean = s[0] / count
        return self._normalize(x, mean, torch.clamp(s[1] / count - mean * mean, min=0.0))

    def _train_bf16(self, x: torch.Tensor) -> torch.Tensor:
        # flax casts x to fp32 once for the statistics and once for the
        # normalisation; autograd rounds each cast's cotangent to bf16
        xs = x.float()
        mean = xs.mean((0, 2, 3))
        var = torch.clamp((xs * xs).mean((0, 2, 3)) - mean * mean, min=0.0)
        return self._normalize(x, mean, var)

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor) -> torch.Tensor:
        """x normalised with the fp32 batch statistics in fp32 and rounded
        once to x's dtype; the running statistics updated, flax's bf16
        update on bf16 x (class docstring), a lerp on fp32 x."""
        with torch.no_grad():
            if x.dtype == torch.bfloat16:
                keep = torch.tensor(1.0 - self.momentum, dtype=x.dtype)
                for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                    buf.copy_((keep * buf.to(x.dtype)).float() + self.momentum * stat)
            else:
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class VFANet(nn.Module):
    """rig_impl: 'cuda' samples through the hand-written rig kernels
    (`ops/rig_cuda.py`; the plain versions for CPU tensors), 'plain' through
    the plain PyTorch versions (`ops/rig.py`). The fused stem is switched
    on as in the JAX package: VFA_FUSED_STEM=1, or `ResNetGN(fused_stem=
    True)` (see `model/resnet.py`).

    The memory options of `vfa_tpu/model/vfanet.py:62-72` trade a
    recompute in the backward for activations not kept; none changes the
    parameters: `backbone_remat` and `stem_remat` go to `ResNetGN` (its
    `remat` and `stem_remat`); `backbone_chunks` > 1 runs the ImageNet
    normalisation, the backbone and the laterals over the B*N images in
    that many chunks, each recomputed in the backward, so the stem's
    temporaries peak at one chunk's (`laterals`). The rig kernels run
    outside every recomputed region."""

    def __init__(self, cfg: DatasetConfig, base: str = "resnet18",
                 angle_range: int = 360, rig_impl: str = "cuda",
                 backbone_remat: bool = False, backbone_chunks: int = 1,
                 stem_remat: bool = False):
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
        self.backbone_chunks = backbone_chunks
        nl = cfg.num_layers
        self.base = ResNetGN(RESNET_LAYERS[base], remat=backbone_remat,
                             stem_remat=stem_remat)
        self.lat8 = Conv2d(128, 256, 1)
        self.lat16 = Conv2d(256, 256, 1)
        self.lat32 = Conv2d(512, 256, 1)
        self.bn8 = group_norm(256)
        self.bn16 = group_norm(256)
        self.bn32 = group_norm(256)
        self.vfa8 = VFACollapse(nl)
        self.vfa16 = VFACollapse(nl)
        self.vfa32 = VFACollapse(nl)
        self.fuse = nn.Sequential(
            Conv2d(256, 256, 3, padding=1),
            BatchNorm2dBiased(256, eps=1e-5, momentum=0.1), nn.ReLU(),
            Conv2d(256, 256, 3, padding=2, dilation=2),
            BatchNorm2dBiased(256, eps=1e-5, momentum=0.1), nn.ReLU())
        self.map_classifier = nn.Sequential(
            nn.Conv2d(256, 1, 3, padding=4, dilation=4, bias=False))
        self.tytx_pred = nn.Sequential(
            Conv2d(256, 256, 3, padding=1), group_norm(256), nn.ReLU(),
            nn.Conv2d(256, 2, 3, padding=1, bias=False))
        if cfg.mode == "3D":
            self.orient_pred = nn.Sequential(
                nn.Conv2d(256, angle_range, 3, padding=4, dilation=4, bias=False))
            self.thtwtl_pred = nn.Sequential(
                Conv2d(256, 256, 3, padding=1), group_norm(256), nn.ReLU(),
                nn.Conv2d(256, 3, 3, padding=1, bias=False))
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.mesh = None

    @property
    def mesh(self):
        """The `parallel.Mesh` of a multi-process run (None: one process),
        set by the caller, as JAX's VFANet takes its bev_mesh. Setting it
        gives the fuse BatchNorms the statistics of the global batch (the
        mesh's data axis)."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        self._mesh = mesh
        for bn in (self.fuse[1], self.fuse[4]):
            bn.stats_group = None if mesh is None else mesh.group("data")

    def laterals(self, images: torch.Tensor) -> List[torch.Tensor]:
        """images (B, N, H, W, 3) in [0, 1] -> the three lateral maps
        relu(GN(1x1 conv)) of the pyramid, each (B*N, 256, fh, fw). With
        `backbone_chunks` > 1 the B*N images go through `trunk` in that
        many chunks, each recomputed in the backward (`remat`), and the
        maps are concatenated; as in JAX (`vfa_tpu/model/vfanet.py:164`),
        only when the chunk count divides B*N, else in one pass."""
        B, N = images.shape[:2]
        x = images.reshape(B * N, *images.shape[2:])
        chunks = self.backbone_chunks
        if chunks <= 1 or x.shape[0] % chunks:
            return self.trunk(x)
        parts = [remat(self, self.trunk, xc) for xc in x.chunk(chunks)]
        return [torch.cat(maps) for maps in zip(*parts)]

    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """images (M, H, W, 3) in [0, 1] -> the three lateral maps, each
        (M, 256, fh, fw): the ImageNet normalisation, the backbone, the
        laterals."""
        # the constants in the image dtype, as JAX makes them
        # (`vfa_tpu/model/vfanet.py:151-152`)
        mean, std = (t.to(x.dtype) for t in (self.img_mean, self.img_std))
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        with observability.span("backbone"):
            feats = self.base(x)
        # the backbone's backward ends with the gradient of the weight its
        # first convolution used (under mixed precision this call's cast)
        observability.backward_span("backbone.bwd", feats, self.base.conv1.weight)
        with observability.span("laterals"):
            return [torch.relu(bn(lat(f))) for f, lat, bn in zip(
                feats, (self.lat8, self.lat16, self.lat32),
                (self.bn8, self.bn16, self.bn32))]

    def feature_modules(self) -> List[nn.Module]:
        """The modules that see each camera's image alone, upstream of the
        sampling: the backbone, the laterals and their GroupNorms."""
        return [self.base, self.lat8, self.lat16, self.lat32, self.bn8,
                self.bn16, self.bn32]

    def collapses(self) -> List[nn.Linear]:
        return [self.vfa8.collapse, self.vfa16.collapse, self.vfa32.collapse]

    def bev_features(self, images: torch.Tensor, rig, calibs=None,
                     grid=None) -> torch.Tensor:
        """images (B, N, H, W, 3) in [0, 1] -> BEV features (B, L, W, 256).
        With `rig` the compiled rig samples (calibs and grid unused); with
        rig=None the reference voxel route does, from calibs (B, N, 3, 4)
        and grid (L, W, 3). On a mesh (`self.mesh`) the N cameras are this
        rank's and the sum is all-reduced over the mesh's `cam` axis; with
        a BEV slab rig (`parallel_bev.BevSlab`) the result is this rank's
        slab (B, slab_rows, W, 256)."""
        B, N = images.shape[:2]
        lats = self.laterals(images)
        with observability.span("sampling"):
            bev = self.sampling(lats, B, N, rig, calibs, grid)
        observability.backward_span("sampling.bwd", bev, lats)
        return bev

    def sampling(self, lats: List[torch.Tensor], B: int, N: int, rig, calibs,
                 grid) -> torch.Tensor:
        """The sampling layer of `bev_features`: the laterals' maps of B
        scenes of N cameras each -> the BEV features."""
        if rig is None:
            if calibs is None or grid is None:
                raise ValueError("the voxel route (rig=None) needs calibs "
                                 "(B, N, 3, 4) and grid (L, W, 3)")
            return self._camera_sum(self.voxel_bev(lats, calibs, grid)).to(lats[0].dtype)
        lat5 = [lat.permute(0, 2, 3, 1).reshape(B, N, *lat.shape[2:], -1) for lat in lats]
        kernels = [lin.weight.t() for lin in self.collapses()]
        biases = [lin.bias for lin in self.collapses()]
        if hasattr(rig, "slab_rows"):
            from vfa_tpu_torch.parallel_bev import sample_bev_sharded

            if self.mesh is None:
                raise ValueError("a BEV slab rig needs VFANet.mesh, the "
                                 "mesh whose bev axis the slabs shard over")
            return sample_bev_sharded(lat5, rig, kernels, biases, out_dtype=lats[0].dtype,
                                      impl=self.rig_impl)
        # on a mesh the fp32 camera sums are all-reduced before the one rounding
        bev = (rig_cuda.rig_bev if self.rig_impl == "cuda" else rig_bev)(
            lat5, rig.scales, kernels, biases,
            torch.float32 if self.mesh is not None else lats[0].dtype)
        L, W = rig.grid_shape
        return self._camera_sum(bev).reshape(B, L, W, 256).to(lats[0].dtype)

    def _camera_sum(self, ortho: torch.Tensor) -> torch.Tensor:
        """The fp32 sum of this rank's cameras, summed over the mesh's
        `cam` axis (the downstream layers run alike on every rank of it)."""
        if self.mesh is None:
            return ortho
        from vfa_tpu_torch import parallel

        return parallel.sum_replicated(ortho, self.mesh.group("cam"))

    def voxel_bev(self, lats: List[torch.Tensor], calibs: torch.Tensor,
                  grid: torch.Tensor) -> torch.Tensor:
        """The reference route (`vfa_tpu/model/vfanet.py:255-300`): the
        fp32 sum over cameras, taken one at a time as JAX's default
        camera_reduce='scan' does, of `one_camera`. Under autograd each
        camera is recomputed in the backward (`remat`, as jax.checkpoint
        there), so memory stays constant in N."""
        B, N = calibs.shape[:2]
        L, W = grid.shape[:2]
        cfg = self.cfg
        ortho = torch.zeros((B, L, W, 256), dtype=torch.float32, device=grid.device)
        for n in range(N):
            boxes = voxel_boxes(calibs[:, n], grid, dataset=cfg.name,
                                grid_height=cfg.grid_h, cube_size=cfg.cube_size,
                                image_size=cfg.image_size)       # (B, nl, L, W, 4)
            lat_n = [lat.reshape(B, N, *lat.shape[1:])[:, n] for lat in lats]
            ortho = ortho + remat(self, self.one_camera, boxes, *lat_n)
        return ortho

    def one_camera(self, boxes: torch.Tensor, *lats: torch.Tensor) -> torch.Tensor:
        """BEV contribution of one camera of every scene: the fp32 sum over
        the 3 scales of relu(collapse(sample_voxels(lateral, boxes)));
        lats (B, 256, fh, fw) each, boxes (B, nl, L, W, 4)."""
        out = 0.0
        for lat, lin in zip(lats, self.collapses()):
            out = out + voxel_contribution(lat, boxes, lin)
        return out

    @observability.traced("forward")
    def forward(self, images: torch.Tensor, rig, calibs=None,
                grid=None) -> Dict[str, torch.Tensor]:
        """Returns heatmap (B, 1, L, W), loc_offset (B, L, W, 2) and, in 3D
        mode, dim_offset (B, L, W, 3), rotation (B, L, W, angle_range).
        calibs and grid feed the voxel route (rig=None); see
        `bev_features`. With a BEV slab rig the fuse block and the heads
        run on this rank's rows (`parallel_bev.heads`)."""
        if rig is not None and hasattr(rig, "slab_rows"):
            from vfa_tpu_torch.parallel_bev import heads

            bev = self.bev_features(images, rig)
            with observability.span("heads"):
                return heads(self, bev, self.mesh, rig.rows)
        ortho = self.bev_features(images, rig, calibs, grid).permute(0, 3, 1, 2)
        with observability.span("heads"):
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


def voxel_contribution(lat: torch.Tensor, boxes: torch.Tensor,
                       collapse: nn.Linear) -> torch.Tensor:
    """relu(collapse(sample_voxels(lat, boxes))) in fp32: one scale's BEV
    contribution of one camera, lat (*lead, C, fh, fw) -> (*lead, L, W,
    n_out). vox is fp32 on bf16 features too (`sample_voxels`), and a bf16
    weight and bias are widened to it exactly, as JAX promotes
    `jnp.dot(vox, kernel, preferred_element_type=f32) + bias`
    (`vfa_tpu/model/vfanet.py:272-274`)."""
    vox = sample_voxels(lat, boxes)
    weight, bias = (t.to(vox.dtype) for t in (collapse.weight, collapse.bias))
    return torch.relu(F.linear(vox, weight, bias)).float()


def cast_model(model: nn.Module, dtype) -> nn.Module:
    """Cast every floating parameter and buffer of `model` to `dtype`, in
    place, as the root bench casts its variables for a bf16 serving run
    (`bench.py:260-263`: every fp32 leaf of params and batch_stats): conv
    and linear weights and biases, norm scales and biases, the BatchNorms'
    running statistics, and the ImageNet normalisation constants (JAX makes
    them in the image dtype, `vfa_tpu/model/vfanet.py:151-152`). Integer
    buffers (`num_batches_tracked`) stay. Returns the model."""
    return model.to(dtype)


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
