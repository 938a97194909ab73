"""The plain reference of the toy architecture: images (B, N, H, W, 3) to
a BEV heatmap (B, 1, L, W) by a 1x1 convolution on each camera, the
camera mean, an average pool to the grid and a 3x3 convolution. With
`low`, both convolutions read their operands rounded ('bf16' the twin,
'fp8' the control)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scene import grid_shape

ROUNDING = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


class Reference(nn.Module):
    def __init__(self, ds: dict, model: dict, low: str | None = None):
        super().__init__()
        self.ds = ds
        self.grid_hw = grid_shape(ds)
        self.low = ROUNDING[low] if low else None
        self.embed = nn.Conv2d(3, model["channels"], 1)
        self.head = nn.Conv2d(model["channels"], 1, 3, padding=1)

    def _r(self, x):
        return x if self.low is None else x.to(self.low).float()

    def forward(self, images, calibs, grid) -> dict:
        B, N = images.shape[:2]
        x = images.permute(0, 1, 4, 2, 3).flatten(0, 1).float()
        f = F.relu(F.conv2d(self._r(x), self._r(self.embed.weight), self.embed.bias))
        f = F.adaptive_avg_pool2d(f.unflatten(0, (B, N)).mean(1), self.grid_hw)
        return {"heatmap": F.conv2d(self._r(f), self._r(self.head.weight), self.head.bias,
                                    padding=1)}


@torch.no_grad()
def decode(pred: dict, cfg: dict) -> dict:
    """The `topk` highest sigmoid scores of each scene and their cells."""
    s = torch.sigmoid(pred["heatmap"].float()).flatten(1)
    conf, idx = torch.sort(s, dim=1, descending=True, stable=True)
    k = cfg["decode"]["topk"]
    return {"conf": conf[:, :k], "index": idx[:, :k]}


def _loss(pred: dict, truth: dict) -> torch.Tensor:
    return F.mse_loss(torch.sigmoid(pred["heatmap"][:, 0].float()), truth["heatmap"])


def train_steps(model: Reference, batches: list, calibs, grid, cfg: dict) -> dict:
    """SGD (momentum 0.9, the configuration's rate and weight decay) on
    each (images, truth) batch: the losses, the first step's predictions
    and gradients, and each parameter's change."""
    t = cfg["train"]
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.SGD(model.parameters(), lr=t["lr"], momentum=0.9,
                          weight_decay=t["weight_decay"])
    losses, grads, first = [], None, None
    for images, truth in batches:
        opt.zero_grad(set_to_none=True)
        pred = model(images, calibs, grid)
        total = _loss(pred, truth)
        total.backward()
        losses.append(float(total.detach()))
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in params.items()}
            first = {k: v.detach() for k, v in pred.items()}
        opt.step()
    change = {k: p.detach() - start[k] for k, p in params.items()}
    return {"losses": losses, "pred": first, "grads": grads, "change": change}


@torch.no_grad()
def train_forward(model: Reference, images, calibs, grid) -> dict:
    model.train()
    return model(images, calibs, grid)


def init_state(model: Reference, generator: torch.Generator, device) -> dict:
    """Every tensor of the state dict uniform in +-0.5, in one draw."""
    sd = model.state_dict()
    flat = torch.rand(sum(v.numel() for v in sd.values()), generator=generator,
                      device=device) - 0.5
    out, at = {}, 0
    for k, v in sd.items():
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out
