"""Entry point of the port (mirrors the root `__graft_entry__.py`).

entry() -> (fn, example_args): the single-scene forward pass of the
flagship model (full-size MultiviewC VFANet: 7 cameras at 720x1280,
156x156 BEV) through the reference voxel route (rig=None), as
`__graft_entry__.entry()` applies the JAX model without a rig. Every
parameter and buffer is zero, as JAX zeroes every variable there; `fn`
takes them first, as JAX's `fn(variables, ...)` does.

    python -m vfa_tpu_torch.entry            # runs fn once on the card
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call


def entry(device="cuda", tiny: bool = False):
    """tiny: the shrunken test configuration with the flagship's 7 cameras,
    as `__graft_entry__._flagship(tiny=True)`."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene, tiny_config
    from vfa_tpu_torch.model.vfanet import VFANet

    cfg = get_config("MultiviewC")
    if tiny:
        cfg = dataclasses.replace(tiny_config(cfg), num_cam=cfg.num_cam)
    model = VFANet(cfg).to(device).eval()
    scene = make_scene(cfg, seed=0, num_objects=4)
    images, calibs, grid = (torch.from_numpy(a).to(device)
                            for a in (scene.images, scene.calibs, scene.grid))
    params = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}

    def fn(params, images, calibs, grid):
        """One scene (N, H, W, 3), its calibs (N, 3, 4) and the grid
        (L, W, 3) -> the prediction dict of a batch of one."""
        return functional_call(model, params,
                               (images[None], None, calibs[None], grid))

    return fn, (params, images, calibs, grid)


def dryrun_multichip(n_devices: int) -> None:
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}): multi-device training is not ported "
        "yet (ROADMAP.md Queue 1 item 15, parallelism)")


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ran OK: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(out.items())))
