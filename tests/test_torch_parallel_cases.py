"""Scenarios that tests/test_torch_parallel.py and
tests/test_torch_parallel_bev.py run in gloo ranks on the CPU
(`vfa_tpu_torch.launch.run_ranks`), and their references: JAX's
one-process train steps from JAX's initial weights (`jax_init`,
`jax_step`), and the port's one process. Holds no test of its own; the
module imports only the port, JAX only inside the `jax_*` functions (the
ranks load no JAX)."""

import dataclasses

import numpy as np
import torch

from vfa_tpu_torch import parallel, parallel_bev
from vfa_tpu_torch.config import TrainConfig, get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.entry import DIM_MEAN, synthetic_batch
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.model.vfanet import VFANet, init_weights
from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes
from vfa_tpu_torch.train_lib import batch_to_device, make_optimizer, make_train_step

RIG = dict(tile_v=16, band_buckets=2)       # tests/test_parallel_bev.py:26-37
# the conv biases that a train-mode BatchNorm follows: their gradient is 0
# in exact arithmetic, so their update is rounding noise alone
BN_FED_BIASES = ("fuse.0.bias", "fuse.3.bias")
# a sharded step's update against JAX's one-process step's (`check_step`):
# rel-L2 of all parameters as one vector, and of each parameter
UPDATE_L2, PARAM_UPDATE_L2 = 2e-3, 5e-2


def train_step(cfg, batch, rig, mesh=None, lr=0.001, state=None):
    """One fp32 train step of the model on this rank's part of `batch`
    (all of it without a mesh), from the state dict `state` (a path or a
    dict; None: the seeded init, seed 0); returns (loss, state dict after
    the step, the serving heatmap of the model before it, in eval mode, on
    this rank's images)."""
    tcfg = TrainConfig(epochs=4, lr=lr, pretrained=False)
    model = VFANet(cfg)
    if state is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(torch.load(state) if isinstance(state, str) else state)
    model.mesh = mesh
    step = make_train_step(model, make_optimizer(model, tcfg, 4), cfg, tcfg,
                           dim_mean=DIM_MEAN, mesh=mesh)
    if mesh is not None:
        step = parallel.shard_train_step(step, mesh)
        rig = rig if rig is None or hasattr(rig, "slab_rows") else parallel.camera_rig(rig, mesh)
    mine = batch if mesh is None else parallel.shard_batch(batch, mesh)
    with torch.no_grad():
        on_device = batch_to_device(mine, "cpu")
        heatmap = model.eval()(on_device["images"], rig, on_device["calibs"],
                               on_device["grid"])["heatmap"]
    loss = step(batch_to_device(batch, "cpu"), rig)
    return (float(loss["loss"]), {k: v.clone() for k, v in model.state_dict().items()},
            heatmap)


def dp_setup():
    """(cfg, batch, rig) of the data-parallel rig step (4 scenes) and of
    the camera-split steps (2 scenes, 4 cameras; the voxel route takes no
    rig)."""
    cfg = tiny_config(get_config("MultiviewC"))
    batch = synthetic_batch(cfg, range(4))
    rig = build_rig(batch["calibs"][0], cfg, batch["grid"],
                    pyramid_feat_shapes(cfg.resize_size), device="cpu", **RIG)
    cfg2 = dataclasses.replace(cfg, num_cam=4)
    batch2 = synthetic_batch(cfg2, range(2), num_cam=4)
    rig2 = build_rig(batch2["calibs"][0], cfg2, batch2["grid"],
                     pyramid_feat_shapes(cfg2.resize_size), device="cpu", **RIG)
    return (cfg, batch, rig), (cfg2, batch2, rig2)


def psum_inputs():
    """Inputs of tests/test_parallel.py::test_camera_psum_bev_matches_unsharded's
    kind, from seed 1234: (cfg, lats (4, C, fh, fw), calibs (4, 3, 4),
    kernel (C*nl, 12), bias (12,))."""
    tc = tiny_config(get_config("MultiviewC"))
    rng = np.random.default_rng(1234)
    calibs = make_calibrations(tc, 4)
    C, fh, fw = 8, tc.resize_size[0] // 8, tc.resize_size[1] // 8
    lats = rng.normal(size=(4, C, fh, fw)).astype(np.float32)
    nl = psum_boxes(tc, calibs).shape[1]
    kernel = rng.normal(size=(C * nl, 12)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    return tc, lats, calibs, kernel, bias


def psum_boxes(tc, calibs):
    """The (4, nl, L, W, 4) voxel boxes of each camera (`ops.voxel`)."""
    from vfa_tpu_torch.ops.voxel import voxel_boxes

    grid = torch.from_numpy(make_grid(tc.world_size, tc.cube_size[:2], tc.name))
    return voxel_boxes(torch.from_numpy(calibs), grid, dataset=tc.name,
                       grid_height=tc.grid_h, cube_size=tc.cube_size,
                       image_size=tc.image_size)


def dp_rank(device, state):
    """2 ranks: from the state dict at `state`, the (data 2) rig step, the
    (data 1 x cam 2) steps through the voxel route and through the rig cut
    to each rank's cameras; and camera_psum_bev over cam 2."""
    (cfg, batch, rig), (cfg2, batch2, rig2) = dp_setup()
    cam2 = parallel.make_mesh(data=1, cam=2)
    out = {"data2": train_step(cfg, batch, rig, parallel.make_mesh(data=2, cam=1),
                               state=state),
           "cam2": train_step(cfg2, batch2, None, cam2, state=state),
           "cam2rig": train_step(cfg2, batch2, rig2, cam2, state=state)}
    tc, lats, calibs, kernel, bias = psum_inputs()
    out["psum"] = parallel.camera_psum_bev(
        parallel.make_mesh(data=1, cam=2), torch.from_numpy(lats),
        psum_boxes(tc, calibs), torch.from_numpy(kernel), torch.from_numpy(bias))
    return out


def bev_setup(factor=16, B=2):
    """(cfg, calibs, grid, feat_shapes, lats, kernels, biases) of
    tests/test_parallel_bev.py's fixture (same seeds)."""
    from vfa_tpu_torch.data.synthetic import make_scene

    tc = tiny_config(get_config("MultiviewC"), factor=factor)
    scene = make_scene(tc, seed=0, num_objects=3)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    shapes = pyramid_feat_shapes(tc.resize_size)
    rng = np.random.default_rng(0)
    nl = len(range(0, tc.grid_h, tc.cube_size[2]))
    lats, kernels, biases = [], [], []
    for fh, fw in shapes:
        lats.append(rng.normal(size=(B, tc.num_cam, fh, fw, 256)).astype(np.float32))
        kernels.append((rng.normal(size=(256 * nl, 256)) * 0.02).astype(np.float32))
        biases.append((rng.normal(size=(256,)) * 0.1).astype(np.float32))
    return tc, np.asarray(scene.calibs), grid, shapes, lats, kernels, biases


def bev_sample(srig, lats, kernels, biases, w, gather):
    """(out, grads of lats, grads of kernels) of sum(out * w), out the BEV
    features of `srig` (a CameraRig, or a BevSlab gathered by `gather`)."""
    lats = [torch.tensor(a, requires_grad=True) for a in lats]
    kernels = [torch.tensor(a, requires_grad=True) for a in kernels]
    biases = [torch.from_numpy(a) for a in biases]
    out = gather(lats, kernels, biases)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), [t.grad for t in lats], [t.grad for t in kernels]


def bev_rank(device, state):
    """4 ranks: BEV-sharded sampling with its gradients, then the
    full-model BEV-sharded steps of `step_setup` from the state dict at
    `state`."""
    import torch.distributed as dist

    tc, calibs, grid, shapes, lats, kernels, biases = bev_setup()
    mesh = parallel_bev.make_bev_mesh(data=1, bev=4)
    srig = parallel_bev.build_bev_sharded_rig(
        calibs, tc, grid, shapes, num_shards=4, dtype=torch.float32, **RIG
    ).slab(mesh, device)
    w = np.random.default_rng(1).normal(size=(2, *grid.shape[:2], 256)).astype(np.float32)

    def sharded(lats, kernels, biases):
        return parallel_bev.gather_bev(parallel_bev.sample_bev_sharded(
            lats, srig, kernels, biases, out_dtype=torch.float32), srig)

    out, glat, gker = bev_sample(srig, lats, kernels, biases, w, sharded)
    for g in gker:                   # the collapses sum over the slabs
        dist.all_reduce(g)
    res = {"sample": (out, glat, gker)}
    for factor, B in ((8, 2), (16, 1)):
        cfg, batch, _ = step_setup(factor, B)
        srig = parallel_bev.build_bev_sharded_rig(
            batch["calibs"][0], cfg, batch["grid"],
            pyramid_feat_shapes(cfg.resize_size), num_shards=4,
            dtype=torch.float32, **RIG).slab(mesh, device)
        res[f"step{factor}"] = train_step(cfg, batch, srig, mesh, lr=0.02, state=state)
    return res


def step_setup(factor=8, B=2):
    """(cfg, batch, full rig) of a full-model BEV step: factor 8, batch 2
    is tests/test_parallel_bev.py::test_bev_sharded_train_step_matches_unsharded's
    (a 19x19 grid: 5-row slabs, the last with one padding row); factor 16,
    batch 1 is the dryrun's (a 9x9 grid: 3-row slabs, the last all
    padding, the dilated heads' halo of 4 rows across two slabs)."""
    cfg = tiny_config(get_config("MultiviewC"), factor=factor)
    batch = synthetic_batch(cfg, range(B), max_objects=8)
    rig = build_rig(batch["calibs"][0], cfg, batch["grid"],
                    pyramid_feat_shapes(cfg.resize_size), device="cpu", **RIG)
    return cfg, batch, rig


def dp_steps():
    """name -> (factor, num_cam, global batch, rig or None, lr) of
    `dp_rank`'s steps, for `jax_step`."""
    (cfg, batch, rig), (cfg2, batch2, rig2) = dp_setup()
    return {"data2": (16, cfg.num_cam, batch, rig, 0.001),
            "cam2": (16, 4, batch2, None, 0.001),
            "cam2rig": (16, 4, batch2, rig2, 0.001)}


def bev_steps():
    """The same of `bev_rank`'s full-model steps (`step_setup`)."""
    steps = {}
    for factor, B in ((8, 2), (16, 1)):
        cfg, batch, rig = step_setup(factor, B)
        steps[f"step{factor}"] = (factor, cfg.num_cam, batch, rig, 0.02)
    return steps


def jax_init():
    """JAX's initial params and batch_stats of the tiny MultiviewC model
    (`train_lib.init_state`'s `model.init`, PRNGKey(0), as
    tests/test_parallel.py; under jit, which gives the same values in a
    third of the time), as numpy trees. flax keys its init by module path
    and the parameter shapes do not depend on the grid, the image size or
    the camera count, so every step of `dp_steps` and `bev_steps` starts
    from these values."""
    import jax
    import jax.numpy as jnp

    from vfa_tpu.config import TrainConfig as JTrainConfig, mc_opts
    from vfa_tpu.data.synthetic import tiny_config as jax_tiny
    from vfa_tpu.train_lib import create_model, init_grid

    model = create_model(jax_tiny(mc_opts), JTrainConfig(pretrained=False))
    batch = synthetic_batch(tiny_config(get_config("MultiviewC")), range(1))
    init = jax.jit(lambda key, *args: model.init(key, *args, train=True))
    variables = init(jax.random.PRNGKey(0), jnp.asarray(batch["images"]),
                     jnp.asarray(batch["calibs"]), init_grid(jnp.asarray(batch["grid"])))
    return tuple(jax.tree_util.tree_map(np.array, variables[k])
                 for k in ("params", "batch_stats"))


def jax_step(variables, factor, num_cam, batch, rig, lr):
    """JAX's one-process fp32 train step (tests/test_parallel.py's recipe:
    TrainConfig(epochs=4, lr), 4 steps an epoch, DIM_MEAN) from
    `variables` on the global `batch`, through JAX's window rig built as
    `rig` was (tile_v 16, band_buckets 2) or, rig None, its voxel route;
    returns (loss, the parameters and running statistics after it under
    the port's names)."""
    import jax
    import jax.numpy as jnp

    from vfa_tpu.config import TrainConfig as JTrainConfig, mc_opts
    from vfa_tpu.data.synthetic import tiny_config as jax_tiny
    from vfa_tpu.ops.rig import build_rig as jax_build_rig
    from vfa_tpu.train_lib import (TrainState, create_model, make_optimizer,
                                   make_train_step as jax_train_step)
    from vfa_tpu_torch.convert import named_jax_leaves

    jc = dataclasses.replace(jax_tiny(mc_opts, factor=factor), num_cam=num_cam)
    tcfg = JTrainConfig(epochs=4, lr=lr, pretrained=False)
    model = create_model(jc, tcfg)
    tx = make_optimizer(tcfg, 4)
    params, stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in variables)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_train_step(model, tx, jc, tcfg, dim_mean=DIM_MEAN)
    if rig is None:
        state, ld = step(state, jb)
    else:
        jrig = jax_build_rig(np.asarray(batch["calibs"][0]), jc, np.asarray(batch["grid"]),
                             pyramid_feat_shapes(jc.resize_size), dtype=jnp.float32,
                             layout="window", **RIG)
        state, ld = step(state, jb, jrig)
    return float(ld["loss"]), named_jax_leaves(*(jax.tree_util.tree_map(np.array, t)
                                                  for t in (state.params, state.batch_stats)))


def check_step(got, want, init, loss_rel, rtol, atol):
    """A sharded step's (loss, state dict) `got` against JAX's (loss,
    named leaves) `want`, both from the state dict `init`: the loss at
    `loss_rel`, every parameter and running statistic at rtol / atol
    (JAX's own bounds for its sharded step). The update is held too (a
    small lr keeps the parameters within rtol of themselves): the update of
    the parameters (not the running statistics), as one vector, within rel-L2 UPDATE_L2 of
    JAX's, and each parameter's within PARAM_UPDATE_L2 of its own (those
    of BN_FED_BIASES only in the vector). A gradient reduced over the
    wrong ranks is off by its own size."""
    loss, sd = got
    want_loss, leaves = want
    assert abs(loss - want_loss) <= loss_rel * abs(want_loss), (loss, want_loss)
    num = den = 0.0
    for k, w in leaves.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=rtol, atol=atol, err_msg=k)
        if "running_" not in k:
            dt, dj = sd[k].numpy() - init[k].numpy(), w - init[k].numpy()
            num, den = num + float(((dt - dj) ** 2).sum()), den + float((dj ** 2).sum())
            rel = np.linalg.norm(dt - dj) / max(np.linalg.norm(dj), 1e-30)
            assert k in BN_FED_BIASES or rel <= PARAM_UPDATE_L2, (k, rel)
    assert (num / den) ** 0.5 <= UPDATE_L2, (num / den) ** 0.5
