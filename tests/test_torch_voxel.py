"""The port's reference voxel route against the JAX package: geometry
(`project`, `grid_sample_bilinear`), the voxel ops of `ops/voxel.py`, the
tiny VFANet forward without a rig, and the port's voxel route against its
own compiled-rig route."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu import geometry as jgeo
from vfa_tpu.config import TrainConfig, mc_opts, mx_opts, wt_opts
from vfa_tpu.data.synthetic import make_calibrations, make_scene, tiny_config
from vfa_tpu.ops import voxel as jvox
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import geometry as tgeo
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.model.vfanet import VFANet, init_weights
from vfa_tpu_torch.ops import voxel as tvox
from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

OP_RTOL, OP_ATOL = 1e-4, 1e-4          # tests/test_voxel.py:71,90
FWD_RTOL, FWD_ATOL = 5e-3, 5e-4        # tests/test_parity.py, test_torch_model.py
RIG_RTOL, RIG_ATOL = 2e-3, 2e-4        # tests/test_rig.py:47
CONFIGS = [mc_opts, mx_opts, wt_opts]


def _geometry(cfg, num_cam=1):
    tc = tiny_config(cfg)
    grid = jgeo.make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    return tc, grid, make_calibrations(tc, num_cam)


def _box_kw(tc):
    return dict(dataset=tc.name, grid_height=tc.grid_h,
                cube_size=tc.cube_size, image_size=tc.image_size)


def _jax_boxes(tc, grid, calib):
    return np.array(jvox.voxel_boxes(jnp.asarray(calib), jnp.asarray(grid),
                                     **_box_kw(tc)))


def test_project_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32) * 100
    calib = make_calibrations(tiny_config(mc_opts), 2).astype(np.float32)
    want = np.asarray(jgeo.project(jnp.asarray(pts[:, :, None]),
                                   jnp.asarray(calib)))
    got = tgeo.project(torch.from_numpy(pts[:, :, None]), torch.from_numpy(calib))
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_RTOL, atol=OP_ATOL)


def test_grid_sample_bilinear_matches_jax_and_torch():
    """Samples inside, on the edge and outside the image (zeros padding),
    unbatched against JAX and batched against F.grid_sample."""
    rng = np.random.default_rng(1)
    image = rng.normal(size=(2, 4, 9, 13)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(2, 6, 5, 2)).astype(np.float32)
    coords[0, 0, :2] = [[-1.0, -1.0], [1.0, 1.0]]
    got = tgeo.grid_sample_bilinear(torch.from_numpy(image), torch.from_numpy(coords))
    assert got.shape == (2, 6, 5, 4)
    for b in range(2):
        want = np.asarray(jgeo.grid_sample_bilinear(jnp.asarray(image[b]),
                                                    jnp.asarray(coords[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=OP_RTOL, atol=OP_ATOL)
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(image), torch.from_numpy(coords), align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_voxel_boxes_match_jax_batched(cfg):
    tc, grid, calibs = _geometry(cfg, num_cam=3)
    got = tvox.voxel_boxes(torch.from_numpy(calibs), torch.from_numpy(grid),
                           **_box_kw(tc))
    L, W = tc.grid_shape
    assert got.shape == (3, tc.num_layers, L, W, 4)
    for n in range(3):
        np.testing.assert_allclose(got[n].numpy(), _jax_boxes(tc, grid, calibs[n]),
                                   rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_sample_voxels_matches_jax(cfg):
    """One camera against JAX, and a batch of two cameras (leading dim) equal
    to each camera alone."""
    tc, grid, calibs = _geometry(cfg, num_cam=2)
    rng = np.random.default_rng(2)
    C, fh, fw = 8, tc.resize_size[0] // 8, tc.resize_size[1] // 8
    feats = rng.normal(size=(2, C, fh, fw)).astype(np.float32)
    boxes = np.stack([_jax_boxes(tc, grid, c) for c in calibs])
    got = tvox.sample_voxels(torch.from_numpy(feats), torch.from_numpy(boxes))
    for n in range(2):
        want = np.asarray(jvox.sample_voxels(jnp.asarray(feats[n]),
                                             jnp.asarray(boxes[n])))
        np.testing.assert_allclose(got[n].numpy(), want, rtol=OP_RTOL, atol=OP_ATOL)
        one = tvox.sample_voxels(torch.from_numpy(feats[n]), torch.from_numpy(boxes[n]))
        np.testing.assert_allclose(got[n].numpy(), one.numpy(), rtol=0, atol=1e-6)
    area, vis = tvox.box_area_visibility(torch.from_numpy(boxes), (fh, fw))
    jarea, jvis = jvox.box_area_visibility(jnp.asarray(boxes), (fh, fw))
    np.testing.assert_allclose(area.numpy(), np.asarray(jarea), rtol=1e-6)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))


@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_voxel_taps_match_jax(cfg):
    tc, grid, calibs = _geometry(cfg)
    boxes = _jax_boxes(tc, grid, calibs[0])
    nl, L, W, _ = boxes.shape
    fh, fw = tc.resize_size[0] // 8, tc.resize_size[1] // 8
    jidx, jw = jvox.voxel_taps(jnp.asarray(boxes), (fh, fw))
    idx, w = tvox.voxel_taps(torch.from_numpy(boxes), (fh, fw))
    assert idx.dtype == torch.int32 and idx.shape == (nl * L * W, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=OP_RTOL, atol=OP_ATOL)
    feat = np.random.default_rng(3).normal(size=(8, fh, fw)).astype(np.float32)
    want = np.asarray(jvox.sample_voxels_taps(jnp.asarray(feat), jidx, jw, nl, L, W))
    got = tvox.sample_voxels_taps(torch.from_numpy(feat), idx, w, nl, L, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_RTOL, atol=OP_ATOL)
    dense = tvox.sample_voxels(torch.from_numpy(feat), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=OP_RTOL, atol=OP_ATOL)


def _scenes(tc, n=2):
    scenes = [make_scene(tc, seed=s, num_objects=3) for s in range(n)]
    return (np.stack([s.images for s in scenes]), np.stack([s.calibs for s in scenes]),
            scenes[0].grid)


@pytest.mark.medium
@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_vfanet_voxel_route_matches_jax(cfg):
    """The tiny forward without a rig, JAX's default camera_reduce='scan',
    with the same weights (params_from_jax) on MultiviewC (3D) and
    Wildtrack (2D)."""
    tc = tiny_config(cfg)
    images, calibs, grid = _scenes(tc)
    jmodel = create_model(tc, TrainConfig(pretrained=False))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                     jnp.asarray(calibs), jnp.asarray(grid))
    want = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(calibs),
                        jnp.asarray(grid))
    model = VFANet(t_tiny_config(get_config(cfg.name)))
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images), None, torch.from_numpy(calibs),
                           torch.from_numpy(grid))
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), rtol=FWD_RTOL,
                                   atol=FWD_ATOL, err_msg=key)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_voxel_route_matches_the_rig_route(cfg):
    """The port's BEV features through the voxel route against the compiled
    rig's (12-bucket window rig, kernel wrappers' plain versions on the
    CPU), same weights and images, tiny config."""
    tc = t_tiny_config(get_config(cfg.name))
    images, calibs, grid = _scenes(tiny_config(cfg))
    rig = build_rig(calibs[0], tc, grid, pyramid_feat_shapes(tc.resize_size),
                    tile_v=16, band_buckets=12, device="cpu")
    model = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        got = model.bev_features(torch.from_numpy(images), None,
                                 torch.from_numpy(calibs), torch.from_numpy(grid))
        want = model.bev_features(torch.from_numpy(images), rig)
    assert got.shape == want.shape == (2, *tc.grid_shape, 256)
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RIG_RTOL, atol=RIG_ATOL)


@pytest.mark.medium
def test_one_train_step_matches_jax_voxel_route():
    """--no_rig: one train step and the eval step through the voxel route,
    JAX's dynamic-gather path against the port's (cameras recomputed in
    the backward on both sides), tiny Wildtrack; the harness of
    test_torch_train.py with layout=None."""
    from test_torch_train import _train_against_jax

    pred = _train_against_jax(wt_opts, steps=1, layout=None)
    assert set(pred) == {"heatmap", "loc_offset"}


def test_voxel_route_trains_with_checkpointed_cameras():
    """Under autograd the voxel route recomputes each camera in the
    backward; its gradients equal those of the same route without
    recomputation."""
    tc = t_tiny_config(get_config("Wildtrack"))
    images, calibs, grid = _scenes(tiny_config(wt_opts), n=1)
    model = init_weights(VFANet(tc), torch.Generator().manual_seed(0))
    args = (torch.from_numpy(images), None, torch.from_numpy(calibs),
            torch.from_numpy(grid))
    grads = []
    for recompute in (True, False):
        model.zero_grad()
        model.voxel_bev = (VFANet.voxel_bev.__get__(model) if recompute else
                           _voxel_bev_without_checkpoint.__get__(model))
        model.bev_features(*args).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1]) and "vfa8.collapse.weight" in grads[0]
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-5, atol=1e-7)


def _voxel_bev_without_checkpoint(self, lats, calibs, grid):
    B, N = calibs.shape[:2]
    cfg = self.cfg
    out = 0.0
    for n in range(N):
        boxes = tvox.voxel_boxes(calibs[:, n], grid, dataset=cfg.name,
                                 grid_height=cfg.grid_h, cube_size=cfg.cube_size,
                                 image_size=cfg.image_size)
        out = out + self.one_camera(
            boxes, *[lat.reshape(B, N, *lat.shape[1:])[:, n] for lat in lats])
    return out
