"""The adapter of the toy architecture: its program is a PyTorch module of
its own (the reference's arithmetic, written again), so that the harness
runs it without the port."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scene import grid_shape


class ToyNet(nn.Module):
    def __init__(self, ds: dict, model: dict):
        super().__init__()
        self.grid_hw = grid_shape(ds)
        self.embed = nn.Conv2d(3, model["channels"], 1)
        self.head = nn.Conv2d(model["channels"], 1, 3, padding=1)

    def forward(self, images, calibs, grid) -> dict:
        B, N = images.shape[:2]
        f = F.relu(self.embed(images.permute(0, 1, 4, 2, 3).flatten(0, 1)))
        f = F.adaptive_avg_pool2d(f.unflatten(0, (B, N)).mean(1), self.grid_hw)
        return {"heatmap": self.head(f)}


def _model(cfg: dict, state: dict, device):
    model = ToyNet(cfg["dataset"], cfg["model"])
    model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=getattr(torch, cfg["dtype"]))


def prepare(cfg: dict, calibs, device, train: bool, cache_dir: str):
    return None


def server(cfg: dict, state: dict, prepared, device, calibs, grid):
    model = _model(cfg, state, device).eval()
    topk = cfg["decode"]["topk"]

    @torch.no_grad()
    def serve(images):
        pred = model(images, calibs, grid)
        s = torch.sigmoid(pred["heatmap"].float()).flatten(1)
        conf, idx = torch.sort(s, dim=1, descending=True, stable=True)
        return pred, {"conf": conf[:, :topk], "index": idx[:, :topk]}

    serve.model = model
    return serve


def trainer(cfg: dict, state: dict, device):
    model = _model(cfg, state, device)
    t = cfg["train"]
    opt = torch.optim.SGD(model.parameters(), lr=t["lr"], momentum=0.9,
                          weight_decay=t["weight_decay"])

    def step(batch, prepared):
        opt.zero_grad(set_to_none=True)
        pred = model(batch["images"], batch["calibs"], batch["grid"])
        loss = F.mse_loss(torch.sigmoid(pred["heatmap"][:, 0].float()), batch["heatmap"])
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    return step, model, opt


def clock_points(model):
    return None
