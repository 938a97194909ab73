"""The port's host data modules against the JAX package's on the mini
on-disk datasets of tests/test_adapters.py: calibration parsing
(`calib.py`), the gt heatmaps (`data/heatmaps.py`) and the three dataset
adapters (`data/adapters.py`: labels, heatmap caches, dim_mean,
calibrations, gt.txt), all exactly equal."""

import os

import numpy as np
import pytest

from test_adapters import _mini_pedestrian, mini_mc  # noqa: F401  (fixture)
from vfa_tpu import calib as jcalib
from vfa_tpu.data import adapters as jad
from vfa_tpu.data import heatmaps as jhm

from vfa_tpu_torch import calib
from vfa_tpu_torch.data import adapters, heatmaps

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _same_objects(got, want):
    assert len(got) == len(want)
    for g_frame, w_frame in zip(got, want):
        assert len(g_frame) == len(w_frame)
        for g, w in zip(g_frame, w_frame):
            assert type(g).__name__ == type(w).__name__ and g.classname == w.classname
            for field in w._fields:
                if field == "classname":
                    continue
                gv, wv = getattr(g, field), getattr(w, field)
                if wv is None:
                    assert gv is None
                else:
                    np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv))


def test_calib_matches_jax(mini_mc):  # noqa: F811
    for i in range(1, 8):
        intr = os.path.join(mini_mc, "calibrations/intrinsic", f"intr_Camera{i}.xml")
        extr = os.path.join(mini_mc, "calibrations/extrinsic", f"extr_Camera{i}.xml")
        k = calib.load_intrinsic(intr)
        np.testing.assert_array_equal(k, jcalib.load_intrinsic(intr))
        (e, rz), (je, jrz) = calib.load_extrinsic(extr), jcalib.load_extrinsic(extr)
        np.testing.assert_array_equal(e, je)
        assert rz == jrz == 45.0 * i
        np.testing.assert_array_equal(calib.camera_matrix(k, e),
                                      jcalib.camera_matrix(k, e))
        np.testing.assert_array_equal(calib.read_opencv_node(extr, "rvec"),
                                      jcalib.read_opencv_node(extr, "rvec"))
    with pytest.raises(KeyError, match="R_y"):
        calib.read_opencv_node(extr, "R_y")


def test_heatmaps_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    hm, jh = np.zeros((156, 156), np.float32), np.zeros((156, 156), np.float32)
    for _ in range(12):
        box = (rng.uniform(20, 136), rng.uniform(20, 136), rng.uniform(220, 290),
               rng.uniform(100, 140), rng.uniform(-180, 180))
        hm = heatmaps.rotated_gaussian_stamp(hm, *box)
        jh = jhm.rotated_gaussian_stamp(jh, *box)
        np.testing.assert_array_equal(hm, jh)
    for reduce in (1, 4):
        np.testing.assert_array_equal(heatmaps.gaussian_map_kernel(reduce),
                                      jhm.gaussian_map_kernel(reduce))
    occ = (rng.uniform(size=(3, 40, 60)) > 0.97).astype(np.float32)
    smooth = heatmaps.smooth_occupancy_maps(occ, 4)
    np.testing.assert_array_equal(smooth, jhm.smooth_occupancy_maps(occ, 4))
    # a cache the JAX package wrote loads as the port's own
    jc = jhm.HeatmapCache(str(tmp_path / "c" / "maps.npy"))
    jc.dump(smooth)
    c = heatmaps.HeatmapCache(str(tmp_path / "c" / "maps.npy"))
    assert c.exists()
    np.testing.assert_array_equal(c.load(), smooth)


@pytest.mark.parametrize("heatmap_type", ["RGK", "GK"])
def test_multiviewc_adapter_matches_jax(mini_mc, tmp_path, heatmap_type):  # noqa: F811
    want = jad.MultiviewC(mini_mc, heatmap_type=heatmap_type,
                          cache_dir=str(tmp_path / "jax"))
    got = adapters.MultiviewC(mini_mc, heatmap_type=heatmap_type,
                              cache_dir=str(tmp_path / "port"))
    _same_objects(got.labels, want.labels)
    np.testing.assert_array_equal(got.heatmaps, want.heatmaps)
    np.testing.assert_array_equal(got.dim_mean, want.dim_mean)
    np.testing.assert_array_equal(got.calibrations, want.calibrations)
    assert got.R_z == want.R_z
    assert got.get_image_fpaths(range(4)) == want.get_image_fpaths(range(4))
    # the caches JAX built are read back unchanged (no rebuild)
    again = adapters.MultiviewC(mini_mc, heatmap_type=heatmap_type,
                                cache_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(again.heatmaps, want.heatmaps)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("name,num_cam,frames,mod,intr_dir", [
    ("MultiviewX", 6, 4, 1000, "intrinsic"),
    ("Wildtrack", 7, 10, 480, "intrinsic_zero"),
])
def test_pedestrian_adapters_match_jax(tmp_path, name, num_cam, frames, mod, intr_dir):
    prefix = "_MX" if name == "MultiviewX" else "_WT"
    root = _mini_pedestrian(tmp_path, getattr(jad, name), num_cam, frames, mod,
                            getattr(jad, prefix + "_INTR"),
                            getattr(jad, prefix + "_EXTR"), intr_dir)
    want = getattr(jad, name)(root, cache_dir=str(tmp_path / "jax"))
    with open(os.path.join(root, "gt.txt")) as f:
        want_gt = f.read()
    got = adapters.ADAPTERS[name](root, cache_dir=str(tmp_path / "port"),
                                  force_gt=True)
    with open(os.path.join(root, "gt.txt")) as f:
        assert f.read() == want_gt
    _same_objects(got.labels, want.labels)
    np.testing.assert_array_equal(got.heatmaps, want.heatmaps)
    np.testing.assert_array_equal(got.calibrations, want.calibrations)
    assert got.get_image_fpaths(range(frames)) == want.get_image_fpaths(range(frames))
    assert got.pos_to_grid(12345) == want.pos_to_grid(12345)
    np.testing.assert_array_equal(got.get_worldcoord_from_worldgrid(np.array([7, 9])),
                                  want.get_worldcoord_from_worldgrid(np.array([7, 9])))
