"""The port's visualization (`visualization/bbox.py`, `figure.py`)
against the JAX package's: box corners and projections exactly equal, and
the figures (matplotlib Agg, both) the same RGBA pixels for the same
inputs."""

import numpy as np
import pytest

from vfa_tpu.config import get_config as jax_get_config
from vfa_tpu.visualization import bbox as jbbox
from vfa_tpu.visualization import figure as jfigure

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, make_scene, tiny_config
from vfa_tpu_torch.utils import Obj2D, Obj3D, grid_rot180, to_numpy
from vfa_tpu_torch.visualization import bbox, figure

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _pixels(fig):
    fig.canvas.draw()
    px = np.asarray(fig.canvas.buffer_rgba()).copy()
    figure._plt().close(fig)
    return px


def test_box_corners_and_projection_equal_jax():
    rng = np.random.default_rng(0)
    calib = make_calibrations(get_config("MultiviewC"))[3]
    for _ in range(5):
        loc = rng.uniform(0, 3000, 3).astype(np.float32)
        dim = rng.uniform(50, 300, 3).astype(np.float32)
        rot = float(rng.uniform(-np.pi, np.pi))
        got = bbox.compute_3d_box_corners(loc, dim, rot)
        want = jbbox.compute_3d_box_corners(loc, dim, rot)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bbox.project_points(got, calib),
                                      jbbox.project_points(want, calib))
    assert bbox.BOX_EDGES == jbbox.BOX_EDGES
    a = rng.normal(size=(2, 3, 4))
    np.testing.assert_array_equal(grid_rot180(a), a[:, ::-1, ::-1])
    np.testing.assert_array_equal(to_numpy([1, 2]), np.array([1, 2]))


def test_heatmap_figure_pixels_equal_jax():
    rng = np.random.default_rng(1)
    pred, gt = rng.uniform(size=(2, 9, 11)).astype(np.float32)
    assert np.array_equal(_pixels(figure.heatmap_figure(pred, gt)),
                          _pixels(jfigure.heatmap_figure(pred, gt)))
    assert np.array_equal(_pixels(figure.heatmap_figure(pred)),
                          _pixels(jfigure.heatmap_figure(pred)))


@pytest.mark.parametrize("data", ["MultiviewC", "Wildtrack"])
def test_prediction_figure_pixels_equal_jax(data):
    """3D boxes (MultiviewC) and ground points (Wildtrack) on every camera
    of a tiny synthetic scene, gt and detections."""
    cfg = tiny_config(get_config(data))
    scene = make_scene(cfg, seed=2, num_objects=3)
    rng = np.random.default_rng(3)
    heat = rng.uniform(size=scene.heatmap.shape).astype(np.float32)
    if cfg.mode == "3D":
        dets = [Obj3D("cow", o.dimension, np.asarray(o.location) + 5.0,
                      o.rotation + 0.3, 0.9) for o in scene.objects]
    else:
        dets = [Obj2D("person", np.asarray(o.location) + 5.0, 0.9)
                for o in scene.objects]
    args = (scene.images, scene.calibs, heat, dets, scene.objects)
    got = _pixels(figure.prediction_figure(*args, cfg))
    want = _pixels(jfigure.prediction_figure(*args, jax_tiny(data)))
    assert got.shape == want.shape and np.array_equal(got, want)
    bare = _pixels(figure.prediction_figure(*args[:3], [], [], cfg))
    assert not np.array_equal(got, bare)          # the boxes were drawn


def jax_tiny(data):
    from vfa_tpu.data.synthetic import tiny_config as jtiny

    return jtiny(jax_get_config(data))


def test_save_prediction_figure_writes_a_png(tmp_path):
    cfg = tiny_config(get_config("MultiviewX"))
    scene = make_scene(cfg, seed=0, num_objects=2)
    path = tmp_path / "p.png"
    figure.save_prediction_figure(path, scene.images, scene.calibs,
                                  scene.heatmap, [], scene.objects, cfg)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert figure.matplotlib_available()
