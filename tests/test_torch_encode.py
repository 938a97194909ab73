"""The port's target encoder against the encode half of `vfa_tpu/codec.py`
on the same numpy objects (rtol 1e-5 / atol 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu import codec as jc
from vfa_tpu.config import mc_opts, wt_opts
from vfa_tpu.data.synthetic import tiny_config
from vfa_tpu.train_lib import encode_targets as j_encode_targets
from vfa_tpu.train_lib import gather_rotation_cells as j_gather

from vfa_tpu_torch import codec as tc
from vfa_tpu_torch import train_lib as ttl
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
DIM_MEAN = np.array([145.0, 120.0, 255.0], np.float32)


def _batch(cfg, rng, B=3, M=6, n_valid=(4, 0, 6), same_cell=True):
    """Padded objects for B frames: frame 1 is empty; in frame 0 objects 0
    and 2 share a cell (the later one must win)."""
    L, W = cfg.grid_shape
    ws = np.asarray(cfg.world_size, np.float32)
    loc = np.zeros((B, M, 3), np.float32)
    loc[..., :2] = rng.uniform(0.05, 0.95, size=(B, M, 2)) * ws
    if same_cell:
        cell = ws / np.asarray(cfg.grid_shape, np.float32)
        corner = np.floor(loc[0, 0, :2] / cell)
        loc[0, 0, :2] = (corner + 0.3) * cell
        loc[0, 2, :2] = (corner + 0.6) * cell
    valid = np.zeros((B, M), np.float32)
    for b, n in enumerate(n_valid):
        valid[b, :n] = 1.0
    batch = {
        "location": loc, "valid": valid,
        "heatmap": rng.uniform(0, 1, size=(B, L, W)).astype(np.float32),
    }
    if cfg.mode == "3D":
        batch["dimension"] = rng.uniform(100, 300, size=(B, M, 3)).astype(np.float32)
        batch["dimension"] *= valid[..., None]
        batch["rotation"] = rng.uniform(-np.pi, np.pi, size=(B, M)).astype(np.float32)
    return batch


def test_gaussian_csl_labels_match_jax():
    ang = np.array([-180.0, -179.6, -0.4, 0.0, 0.7, 45.2, 179.9, 359.0, -361.5],
                   np.float32)
    for n, sigma in ((360, 6.0), (180, 3.0)):
        got = tc.gaussian_csl_labels(torch.from_numpy(ang), n, sigma).numpy()
        want = np.asarray(jc.gaussian_csl_labels(jnp.asarray(ang), n, sigma))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dense_rotation", [True, False])
@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_encode_targets_match_jax(cfg, dense_rotation):
    """Batched encode == vmapped JAX `encode_frame`: empty frame, two
    objects on one cell (last writer wins), padded objects dropped, and the
    Wildtrack row/column swap."""
    rng = np.random.default_rng(5)
    jcfg = tiny_config(cfg)
    tcfg = t_tiny_config(get_config(cfg.name))
    batch = _batch(jcfg, rng)
    dm = DIM_MEAN if cfg.mode == "3D" else None
    want = j_encode_targets({k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                            None if dm is None else jnp.asarray(dm), 360,
                            dense_rotation=dense_rotation)
    got = ttl.encode_targets({k: torch.from_numpy(v) for k, v in batch.items()},
                             tcfg, dm, 360, dense_rotation=dense_rotation)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(got["mask"][1].sum()) == 0.0            # the empty frame
    assert float(got["mask"][0].sum()) == 3.0            # 4 valid, 2 share a cell


def _place(batch, cfg, b, i, row, col):
    """Put object i of frame b on grid cell (row, col), indices unclipped
    (Wildtrack's row is the location's x, MultiviewC's its y)."""
    cx, cy = (row, col) if cfg.name == "Wildtrack" else (col, row)
    cell = np.asarray(cfg.world_size, np.float32) / np.asarray(cfg.grid_shape, np.float32)
    batch["location"][b, i, :2] = (np.array([cx, cy], np.float32) + [0.3, 0.6]) * cell


# (object 1 of frame 0 at (row, col), object 3 at (row, col) or None) ->
# cells of frame 0's mask after JAX's wrap, and its sum. In frame 0 objects 0
# and 2 share one cell already (3 cells from 4 objects).
WRAP_CASES = {
    "row_minus_1": ((-1, 2), None, 3),
    "col_minus_1": ((1, -1), None, 3),
    "row_L": (("L", 2), None, 2),
    "wrapped_then_later_in_grid": ((-1, 2), ("L-1", 2), 2),
}


@pytest.mark.parametrize("case", list(WRAP_CASES))
@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_encode_wraps_negative_cells_as_jax(cfg, case):
    """The dense targets take JAX's scatter index rule: row (col) -1 wraps
    to L-1 (W-1), row L is dropped, and a later valid object on the wrapped
    cell wins. mask, offsets, dense rotation and n_pos equal JAX's."""
    rng = np.random.default_rng(9)
    jcfg = tiny_config(cfg)
    tcfg = t_tiny_config(get_config(cfg.name))
    L, W = jcfg.grid_shape
    batch = _batch(jcfg, rng)
    first, later, n_pos = WRAP_CASES[case]
    sub = lambda v: {"L": L, "L-1": L - 1}.get(v, v)
    _place(batch, jcfg, 0, 1, *map(sub, first))
    if later is not None:
        _place(batch, jcfg, 0, 3, *map(sub, later))
    dm = DIM_MEAN if cfg.mode == "3D" else None
    want = j_encode_targets({k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                            None if dm is None else jnp.asarray(dm), 360)
    got = ttl.encode_targets({k: torch.from_numpy(v) for k, v in batch.items()},
                             tcfg, dm, 360)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(got["mask"][0].sum()) == float(want["mask"][0].sum()) == n_pos
    r, c = map(sub, first)
    if -L <= r < L and -W <= c < W:
        assert float(got["mask"][0, 0, r % L, c % W]) == 1.0
    if later is not None:
        # the wrapped cell holds the later object's offsets
        loc = batch["location"][0, 3, :2] / np.asarray(jcfg.world_size) * jcfg.grid_shape
        np.testing.assert_allclose(got["loc_offset"][0, r % L, c % W].numpy(),
                                   loc - np.floor(loc), rtol=RTOL, atol=ATOL)


def test_encode_wrapped_cell_full_multiviewc():
    """Full MultiviewC (156 x 156): one object half a cell below y = 0 and
    one inside; both packages mark (39, 39) and the wrapped (155, 78)."""
    jcfg, tcfg = mc_opts, get_config("MultiviewC")
    cell = np.asarray(jcfg.world_size, np.float32) / np.asarray(jcfg.grid_shape, np.float32)
    loc = np.zeros((2, 3), np.float32)
    loc[0, :2] = np.array([39.5, 39.5]) * cell
    loc[1, :2] = np.array([78.5, -0.5]) * cell
    objs = {"location": loc, "valid": np.ones(2, np.float32),
            "dimension": np.full((2, 3), 200.0, np.float32),
            "rotation": np.array([0.3, -1.2], np.float32)}
    heat = np.zeros(jcfg.grid_shape, np.float32)
    want = jc.encode_frame({k: jnp.asarray(v) for k, v in objs.items()},
                           jnp.asarray(heat), jcfg, dim_mean=jnp.asarray(DIM_MEAN))
    got = tc.encode_frame({k: torch.from_numpy(v) for k, v in objs.items()},
                          torch.from_numpy(heat), tcfg, dim_mean=DIM_MEAN)
    cells = [[39, 39], [155, 78]]
    assert np.argwhere(np.asarray(want["mask"])[0, 0]).tolist() == cells
    assert torch.nonzero(got["mask"][0, 0]).tolist() == cells
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_encode_single_frame_keeps_jax_shapes():
    rng = np.random.default_rng(6)
    jcfg = tiny_config(mc_opts)
    tcfg = t_tiny_config(get_config("MultiviewC"))
    batch = _batch(jcfg, rng, B=1, n_valid=(5,))
    objs = {k: v[0] for k, v in batch.items() if k != "heatmap"}
    want = jc.encode_frame({k: jnp.asarray(v) for k, v in objs.items()},
                           jnp.asarray(batch["heatmap"][0]), jcfg,
                           dim_mean=jnp.asarray(DIM_MEAN))
    got = tc.encode_frame({k: torch.from_numpy(v) for k, v in objs.items()},
                          torch.from_numpy(batch["heatmap"][0]), tcfg,
                          dim_mean=DIM_MEAN)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_object_cells_match_jax(cfg):
    rng = np.random.default_rng(7)
    jcfg = tiny_config(cfg)
    tcfg = t_tiny_config(get_config(cfg.name))
    batch = _batch(jcfg, rng)
    batch["location"][2, 5, :2] = np.asarray(jcfg.world_size) * 1.5   # outside
    objs = {k: batch[k] for k in ("location", "valid")}
    want = jax.vmap(lambda o: jc.object_cells(o, jcfg))(
        {k: jnp.asarray(v) for k, v in objs.items()})
    got = tc.object_cells({k: torch.from_numpy(v) for k, v in objs.items()}, tcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2][0, 0] and got[2][0, 2]              # later object owns
    assert not got[2][2, 5]


def test_sparse_rotation_cells_match_jax_and_dense_loss():
    from vfa_tpu_torch.losses import (
        csl_angle_focal_loss, csl_angle_focal_loss_cells,
    )

    rng = np.random.default_rng(8)
    jcfg = tiny_config(mc_opts)
    tcfg = t_tiny_config(get_config("MultiviewC"))
    batch = _batch(jcfg, rng)
    L, W = jcfg.grid_shape
    pred = rng.normal(size=(3, L, W, 360)).astype(np.float32)
    want = j_gather(jnp.asarray(pred), {k: jnp.asarray(v) for k, v in batch.items()},
                    jcfg, 360)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ttl.gather_rotation_cells(torch.from_numpy(pred), tb, tcfg, 360)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    gt = ttl.encode_targets(tb, tcfg, DIM_MEAN, 360)
    dense = csl_angle_focal_loss(torch.from_numpy(pred), gt["rotation"], gt["mask"])
    sparse = csl_angle_focal_loss_cells(*got)
    np.testing.assert_allclose(float(sparse), float(dense), rtol=RTOL, atol=ATOL)
