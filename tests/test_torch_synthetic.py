"""Synthetic inputs, grids and host geometry of the port are bit-identical
to the JAX package's for the same seed."""

import numpy as np
import pytest

from vfa_tpu import geometry as jgeo
from vfa_tpu import utils as jutils
from vfa_tpu.config import get_config as jax_config
from vfa_tpu.data import synthetic as jsyn
from vfa_tpu.ops import voxel as jvox

from vfa_tpu_torch import geometry as tgeo
from vfa_tpu_torch import utils as tutils
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data import synthetic as tsyn
from vfa_tpu_torch.ops import voxel as tvox

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["MultiviewC", "MultiviewX", "Wildtrack"]


@pytest.mark.parametrize("name", NAMES)
def test_grid_and_calibrations_identical(name):
    for j, t in ((jax_config(name), get_config(name)),
                 (jsyn.tiny_config(jax_config(name)), tsyn.tiny_config(get_config(name)))):
        np.testing.assert_array_equal(
            tgeo.make_grid(t.world_size, t.cube_size[:2], t.name),
            jgeo.make_grid(j.world_size, j.cube_size[:2], j.name))
        np.testing.assert_array_equal(tsyn.make_calibrations(t),
                                      jsyn.make_calibrations(j))
        grid = tgeo.make_grid(t.world_size, t.cube_size[:2], t.name)
        np.testing.assert_array_equal(
            tgeo.worldgrid_to_worldcoord(grid, name),
            np.asarray(jgeo.worldgrid_to_worldcoord(grid, name)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_scene_identical_per_seed(name, seed):
    j = jsyn.make_scene(jsyn.tiny_config(jax_config(name)), seed=seed, num_objects=4)
    t = tsyn.make_scene(tsyn.tiny_config(get_config(name)), seed=seed, num_objects=4)
    for field in ("images", "calibs", "grid", "heatmap"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    mode = get_config(name).mode
    pj = jutils.pad_objects(j.objects, 6, mode)
    pt = tutils.pad_objects(t.objects, 6, mode)
    assert set(pt) == set(pj)
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k])


def test_voxel_helpers_and_rodrigues_identical():
    for cfg in (get_config(n) for n in NAMES):
        np.testing.assert_array_equal(tvox.cube_corner_offsets(cfg.cube_size),
                                      jvox.cube_corner_offsets(cfg.cube_size))
        np.testing.assert_array_equal(
            tvox.z_layer_offsets(cfg.grid_h, cfg.cube_size[2]),
            jvox.z_layer_offsets(cfg.grid_h, cfg.cube_size[2]))
    assert (tvox.EPSILON, tvox.MAXIMUM_AREA_RATIO) == (jvox.EPSILON, jvox.MAXIMUM_AREA_RATIO)
    for rvec in ([0.0, 0.0, 0.0], [0.3, -1.2, 0.7]):
        np.testing.assert_array_equal(tgeo.rodrigues(rvec), jgeo.rodrigues(rvec))
