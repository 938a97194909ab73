"""ResNet-18/34 feature pyramid with GroupNorm(16) (port of
`vfa_tpu/model/resnet.py`), and the ResNet stages MVDet's trunk shares.

Reference: `vfa/model/resnet.py` — BasicBlock with GN(16), stem conv7x7/s2
+ GN + maxpool3x3/s2, returning the /8, /16, /32 pyramid. NCHW inside,
except where each norm and what follows it go through `ops/group_norm.py`'s
kernels (bf16 serving on the card): there the activations are
channels-last, and the pyramid is made NCHW for the laterals. Module names
follow the reference state-dict keys (`base.layerX.Y.*`).
`resnet_stages` builds the four stages by torchvision's rule for either
norm, and with stages whose stride turns into dilation (MVDet's trunk,
`model/mvdet.py`).
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import checkpoint

from vfa_tpu_torch import observability
from vfa_tpu_torch.ops.group_norm import norm_act, norm_relu_pool

GN_EPS = 1e-5
BN_EPS = 1e-5


def remat(module: nn.Module, fn, *args):
    """fn(*args) with its activations recomputed in the backward instead
    of kept (non-reentrant `torch.utils.checkpoint`, as flax's `nn.remat`
    and `jax.checkpoint`); `fn` reads its parameters from `module`. The
    recompute runs on the parameters the forward saw: under
    `torch.func.functional_call` (mixed precision casts the fp32 masters at
    use, `train_lib._forward`) those are the call's bf16 tensors, which
    `module` no longer holds when the backward runs. Without autograd it
    is fn(*args). The recompute records no span (`observability.
    untraced`)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    params = dict(module.named_parameters())
    return checkpoint(_on_params, module, params, fn, *args, use_reentrant=False,
                      context_fn=_recompute_untraced)


def _recompute_untraced():
    # (forward context, recompute context) of a non-reentrant checkpoint
    return contextlib.nullcontext(), observability.untraced()


def _on_params(module, params, fn, *args):
    # the context torch.func.functional_call runs a module's forward in
    with _reparametrize_module(module, params):
        return fn(*args)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(16, channels, eps=GN_EPS)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a norm and a residual add (`vfa/model/resnet.py:26-57`).
    `norm` makes each norm layer (`group_norm`, VFANet's, or `batch_norm`);
    `dilation` dilates both 3x3 convolutions, each padded by it (MVDet's
    copy of torchvision's block, which lifts its limit of 1). Each norm
    runs with what follows it through `ops/group_norm.norm_act`."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm=group_norm, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, dilation,
                               dilation=dilation, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation=dilation,
                               bias=False)
        self.bn2 = norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                norm(planes))

    def forward(self, x):
        identity = x
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = norm_act(norm, conv(x))
        # each intermediate is handed on, never named, so that it is freed
        # once the next op has read it (a serving peak may be set in a block)
        return norm_act(self.bn2, self.conv2(norm_act(self.bn1, self.conv1(x), "relu")),
                        "add_relu", identity)


def resnet_stages(layers: Sequence[int], norm=group_norm,
                  dilate: Sequence[bool] = (False, False, False)) -> List[nn.Sequential]:
    """The four stages of a ResNet-18/34 (64, 128, 256, 512 channels,
    `layers` blocks each) by torchvision's `_make_layer`: stage 1 at stride
    1, each later one at stride 2 unless `dilate` names it
    (`replace_stride_with_dilation`); then the stage's stride multiplies
    the running dilation instead, its first block keeps the dilation before
    it and its other blocks take the new one. A 1x1 downsample (with its
    norm) where the stride or the channels change."""
    stages, inplanes, dilation = [], 64, 1
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride, previous = (1 if stage == 0 else 2), dilation
        if stage > 0 and dilate[stage - 1]:
            dilation, stride = dilation * stride, 1
        mods = []
        for b in range(blocks):
            s = stride if b == 0 else 1
            ds = b == 0 and (s != 1 or inplanes != planes)
            mods.append(BasicBlock(inplanes, planes, s, ds, norm,
                                   previous if b == 0 else dilation))
            inplanes = planes
        stages.append(nn.Sequential(*mods))
    return stages


class ResNetGN(nn.Module):
    """ResNet trunk returning (feats8, feats16, feats32), NCHW (on the
    kernels' route, `ops/group_norm.py`, each copied from the channels-last
    activations: the laterals take NCHW faster than channels-last, whose
    norms would copy their 256-channel outputs to NCHW).
    `layers` is (2, 2, 2, 2) for resnet18, (3, 4, 6, 3) for resnet34.
    The stem's GN + ReLU + max-pool go through `ops/group_norm.
    norm_relu_pool`: bf16 serving on the card takes its kernel whatever
    `fused_stem` says. Elsewhere `fused_stem` runs them through
    `ops.stem.gn_relu_pool` (same forward, the hand-written backward that
    keeps only conv1's output); the parameters stay under `bn1`, so the
    state dict is the same. VFA_FUSED_STEM=1/0 overrides the attribute, as
    in the JAX package. The memory options of `vfa_tpu/model/resnet.py:
    84-145` recompute in the backward (`remat`) what they do not keep:
    `remat` each BasicBlock, `stem_remat` conv1 + GN + ReLU + pool (with
    the fused stem, conv1 + `gn_relu_pool`, whose backward kernels still
    run once). Neither changes the parameters or what is computed."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 fused_stem: bool = False, remat: bool = False,
                 stem_remat: bool = False):
        super().__init__()
        self.fused_stem = fused_stem
        self.remat = remat
        self.stem_remat = stem_remat
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = group_norm(64)
        for stage, layer in enumerate(resnet_stages(layers), start=1):
            setattr(self, f"layer{stage}", layer)

    def fused_stem_on(self) -> bool:
        env = os.environ.get("VFA_FUSED_STEM")
        return env != "0" if env is not None else self.fused_stem

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return norm_relu_pool(self.bn1, self.conv1(x), self.fused_stem_on())

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = remat(self, self.stem, x) if self.stem_remat else self.stem(x)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = remat(block, block, x) if self.remat else block(x)
            feats.append(x)
        return tuple(f.contiguous() for f in feats[1:])
