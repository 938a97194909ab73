"""The work counts of VFANet (`work/vfanet.py`) and the shared ones
(`work/__init__.py`) against arithmetic by hand at small sizes."""

import numpy as np
import torch

from work import vfanet as work
from reference.vfanet import ReferenceVFA, tap_matrix, voxel_geometry
from scene import make_calibrations, make_grid

DS = {"name": "MultiviewC", "mode": "3D", "world_size": [375, 375], "image_size": [90, 160],
      "resize_size": [90, 160], "grid_h": 160, "cube_size": [25, 25, 32], "num_cam": 2}
CFG = {"dataset": DS, "dtype": "bfloat16",
       "model": {"resnet_layers": [2, 2, 2, 2], "angle_bins": 360}}


def test_backbone_flops_by_hand():
    # 90x160: stem 45x80, pool 23x40, stages at 23x40, 12x20, 6x10, 3x5
    mac = (3 * 64 * 49 * 45 * 80                                   # stem
           + 4 * 64 * 64 * 9 * 23 * 40                             # layer1
           + (64 * 128 * 9 + 128 * 128 * 9 * 3 + 64 * 128) * 12 * 20
           + (128 * 256 * 9 + 256 * 256 * 9 * 3 + 128 * 256) * 6 * 10
           + (256 * 512 * 9 + 512 * 512 * 9 * 3 + 256 * 512) * 3 * 5)
    assert work.backbone_flops((90, 160), (2, 2, 2, 2)) == 2 * mac


def test_visible_pairs_by_brute_force():
    """Each (cell, camera) pair counted when any layer's voxel box lies in
    the image with an area under 0.3 of the map, projected point by point
    in numpy."""
    calibs, grid = make_calibrations(DS), make_grid(DS)
    l, w, h = DS["cube_size"]
    corners = np.array([[x, y, z] for z in (0, h) for x, y in
                        ((-l / 2, -w / 2), (l / 2, -w / 2), (l / 2, w / 2), (-l / 2, w / 2))])
    want = []
    for fh, fw in ((12, 20), (6, 10), (3, 5)):
        n = 0
        for P in calibs.astype(np.float64):
            for r in range(grid.shape[0]):
                for c in range(grid.shape[1]):
                    seen = False
                    for z in range(0, DS["grid_h"], h):
                        pts = grid[r, c].astype(np.float64) + corners + [0, 0, z]
                        hom = pts @ P[:, :3].T + P[:, 3]
                        x = np.clip(2 * hom[:, 0] / hom[:, 2] / 160 - 1, -1, 0.95)
                        y = np.clip(2 * hom[:, 1] / hom[:, 2] / 90 - 1, -1, 0.95)
                        area = (x.max() - x.min()) * (y.max() - y.min()) * fh * fw + 1e-6
                        seen |= 1e-6 < area < 0.3 * fh * fw
                    n += seen
        want.append(n)
    assert work.visible_pairs(DS) == want
    nl = 5
    assert work.collapse_flops(DS) == sum(want) * 2 * 256 * nl * 256


def test_forward_flops_sums_the_layers():
    L = W = 15
    heads = (2 * 256 * 256 * 9 * L * W * 2 + 2 * 256 * 1 * 9 * L * W
             + 2 * (256 * 256 * 9 + 256 * 2 * 9) * L * W
             + 2 * (256 * 256 * 9 + 256 * 3 * 9) * L * W + 2 * 256 * 360 * 9 * L * W)
    lat = 2 * 2 * (128 * 12 * 20 + 256 * 6 * 10 + 512 * 3 * 5) * 256
    assert work.forward_flops(CFG) == (2 * work.backbone_flops((90, 160), (2, 2, 2, 2))
                                       + lat + work.collapse_flops(DS) + heads)


def test_sampling_bytes_by_hand():
    lat = 3 * 2 * 256 * (12 * 20 + 6 * 10 + 3 * 5)
    bev, weights = 3 * 15 * 15 * 256, 3 * (256 * 5 * 256 + 256)
    assert work.sampling_bytes(CFG, 3, False) == 2 * (lat + bev + weights)
    assert work.sampling_bytes(CFG, 3, True) == 2 * (2 * lat + bev + 2 * weights)
    assert work.sampling_flops(CFG, 3, True) == 6 * work.collapse_flops(DS)


def test_bound_takes_the_longer():
    peak = {"flops": 1e12, "bytes_per_s": 1e9}
    assert work.bound_s(2e12, 1e9, peak) == 2.0
    assert work.bound_s(1e12, 3e9, peak) == 3.0


def test_tap_matrix_is_grid_sample():
    """The reference's sparse sampling equals four grid_sample reads of the
    integral image, (lt + rb - rt - lb) / area, zero where not visible."""
    torch.manual_seed(0)
    calib = torch.as_tensor(make_calibrations(DS)[0])
    grid = torch.as_tensor(make_grid(DS))
    for hw in ((12, 20), (6, 10), (3, 5)):
        corners, area, visible = voxel_geometry(DS, calib, grid, hw)
        ii = torch.randn(4, *hw, dtype=torch.float64).cumsum(-1).cumsum(-2)
        taps = torch.nn.functional.grid_sample(ii[None], corners[None], align_corners=False)[0]
        want = (taps[..., 0] + taps[..., 1] - taps[..., 2] - taps[..., 3]) / area * visible
        got = torch.sparse.mm(tap_matrix(corners, area, visible, hw), ii.reshape(4, -1).T).T
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert ReferenceVFA(DS, CFG["model"]).nl == 5
