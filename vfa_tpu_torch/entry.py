"""Entry point of the port (mirrors the root `__graft_entry__.py`).

entry() -> (fn, example_args): the single-scene forward pass of the
flagship model (full-size MultiviewC VFANet: 7 cameras at 720x1280,
156x156 BEV) through the reference voxel route (rig=None), as
`__graft_entry__.entry()` applies the JAX model without a rig. Every
parameter and buffer is zero, as JAX zeroes every variable there; `fn`
takes them first, as JAX's `fn(variables, ...)` does.

dryrun_multichip(n) runs the four multi-device paths of
`__graft_entry__.dryrun_multichip` at the tiny config in n ranks (gloo on
the CPU, `launch.run_ranks`): the data-parallel rig train step, the
(data, cam) step through the voxel route, BEV-sharded sampling with its
gradients, and the full-model BEV-sharded train step at batch 1.

    python -m vfa_tpu_torch.entry            # runs fn once on the card
    python -m vfa_tpu_torch.entry --dryrun 4 # the multi-device dryrun, CPU
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


DIM_MEAN = (145.0, 120.0, 255.0)


def synthetic_batch(cfg, seeds, num_cam=None, max_objects=16) -> dict:
    """Synthetic scenes `seeds` as a numpy training batch (the keys of
    `__graft_entry__.dryrun_multichip`'s make_batch)."""
    import numpy as np

    from vfa_tpu_torch.data.synthetic import make_scene
    from vfa_tpu_torch.utils import pad_objects

    scenes = [make_scene(cfg, seed=s, num_objects=3, num_cam=num_cam) for s in seeds]
    objs = [pad_objects(s.objects, max_objects, cfg.mode) for s in scenes]
    batch = {"images": np.stack([s.images for s in scenes]),
             "calibs": np.stack([s.calibs for s in scenes]),
             "grid": scenes[0].grid,
             "heatmap": np.stack([s.heatmap for s in scenes])}
    for key in objs[0]:
        batch[key] = np.stack([o[key] for o in objs])
    return batch


def _train_step_on(mesh, cfg, batch, rig, device, rig_impl="cuda"):
    """One fp32 train step of the seeded tiny model on `mesh` (this rank's
    part of `batch`); returns the loss."""
    from vfa_tpu_torch import parallel
    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.train_lib import batch_to_device, make_optimizer, make_train_step

    tcfg = TrainConfig(pretrained=False)
    model = init_weights(VFANet(cfg, rig_impl=rig_impl),
                         torch.Generator().manual_seed(0)).to(device)
    model.mesh = mesh
    parallel.replicate(model, mesh)
    step = make_train_step(model, make_optimizer(model, tcfg, 4), cfg, tcfg,
                           dim_mean=DIM_MEAN, mesh=mesh)
    loss = step(batch_to_device(parallel.shard_batch(batch, mesh), device), rig)
    return float(loss["loss"])


def _dryrun_rank(device, n: int) -> dict:
    """The four parts of the dryrun on this rank (see the module
    docstring); returns their losses and the BEV sampling's sum of
    squares."""
    import math

    import numpy as np

    from vfa_tpu_torch import parallel, parallel_bev
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.geometry import make_grid
    from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes

    cfg = dataclasses.replace(tiny_config(get_config("MultiviewC")), num_cam=7)
    shapes = pyramid_feat_shapes(cfg.resize_size)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    out = {}

    # 1. the window-rig train step, data parallel over all n ranks
    batch = synthetic_batch(cfg, range(n), num_cam=cfg.num_cam)
    rig = build_rig(batch["calibs"][0], cfg, grid, shapes, tile_v=16,
                    band_buckets=2, device=device)
    out["rig_loss"] = _train_step_on(parallel.make_mesh(data=n, cam=1), cfg,
                                     batch, rig, device)

    # 2. the voxel route with the cameras split too (cam 2 where possible)
    cam = 2 if n % 2 == 0 else 1
    cfg2 = dataclasses.replace(cfg, num_cam=2 * cam)
    out["mesh2"] = f"data{n // cam}xcam{cam}"
    out["dyn_loss"] = _train_step_on(
        parallel.make_mesh(data=n // cam, cam=cam), cfg2,
        synthetic_batch(cfg2, range(n // cam), num_cam=cfg2.num_cam), None, device)

    # 3. BEV-sharded sampling and its gradients over bev = min(n, 4) ranks
    #    (the other ranks, if any, form data rows of their own)
    bev = min(n, 4)
    data = n // bev
    if data * bev != n:
        raise ValueError(f"dryrun_multichip({n}): {n} ranks do not tile bev={bev}")
    bev_mesh = parallel_bev.make_bev_mesh(data=data, bev=bev)
    srig = parallel_bev.build_bev_sharded_rig(
        batch["calibs"][0], cfg, grid, shapes, num_shards=bev, tile_v=16,
        dtype=torch.float32, band_buckets=2).slab(bev_mesh, device)
    rng = np.random.default_rng(0)
    nl = srig.scales[0].nl
    lats = [torch.tensor(rng.normal(size=(1, cfg.num_cam, fh, fw, 256)), dtype=torch.float32,
                         device=device, requires_grad=True) for fh, fw in shapes]
    kernels = [torch.tensor(rng.normal(size=(256 * nl, 256)) * 0.02, dtype=torch.float32,
                            device=device, requires_grad=True) for _ in shapes]
    biases = [torch.zeros(256, device=device) for _ in shapes]
    full = parallel_bev.gather_bev(parallel_bev.sample_bev_sharded(
        lats, srig, kernels, biases, out_dtype=torch.float32), srig)
    val = (full ** 2).sum()
    val.backward()
    grads = [g.grad for g in lats + kernels]
    out["bev_mesh"] = f"bev{bev}"
    out["bev_val"] = float(val)
    out["bev_grads_finite"] = all(bool(torch.isfinite(g).all()) for g in grads)

    # 4. the full-model BEV-sharded train step at batch 1 (per data row)
    batch4 = synthetic_batch(cfg, range(data), num_cam=cfg.num_cam)
    out["bev_train_loss"] = _train_step_on(bev_mesh, cfg, batch4, srig, device)
    for k in ("rig_loss", "dyn_loss", "bev_val", "bev_train_loss"):
        if not math.isfinite(out[k]):
            raise FloatingPointError(f"dryrun_multichip({n}): non-finite {k} {out[k]}")
    if not out["bev_grads_finite"]:
        raise FloatingPointError(f"dryrun_multichip({n}): non-finite BEV gradients")
    return out


def dryrun_multichip(n_devices: int, threads: int = 1) -> dict:
    """The multi-device dryrun in `n_devices` gloo ranks on the CPU; prints
    `__graft_entry__.dryrun_multichip`'s line and returns rank 0's
    results."""
    from vfa_tpu_torch.launch import run_ranks

    r = run_ranks("vfa_tpu_torch.entry:_dryrun_rank", n_devices,
                  args=(n_devices,), threads=threads)[0]["result"]
    print(f"dryrun_multichip({n_devices}): rig-window mesh=data{n_devices} "
          f"loss={r['rig_loss']:.4f} | dynamic mesh={r['mesh2']} "
          f"loss={r['dyn_loss']:.4f} | bev-sharded mesh={r['bev_mesh']} "
          f"out2={r['bev_val']:.4f} | full-model bev train step "
          f"loss={r['bev_train_loss']:.4f} OK", flush=True)
    return r


if __name__ == "__main__":
    import sys

    if len(sys.argv) >= 2 and sys.argv[1] == "--dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
        sys.exit(0)
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ran OK: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in sorted(out.items())))
