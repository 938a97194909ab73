"""The port's window rig against the JAX package: the host build must be
identical, and the plain PyTorch version of the window kernel must match
the Pallas kernel (interpret mode) and the XLA scan formulation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vfa_tpu.config import mc_opts, mx_opts, wt_opts
from vfa_tpu.data.synthetic import make_calibrations, tiny_config
from vfa_tpu.geometry import make_grid
from vfa_tpu.ops import rig as jrig
from vfa_tpu.ops.rig_pallas import rig_sample_scale_pallas

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops.rig_cuda import rig_sample_scale_cuda, rig_window_fwd


def _both_rigs(cfg, buckets, tile_v=16, shapes=None):
    tc = tiny_config(cfg)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    calibs = make_calibrations(tc, 2)
    shapes = shapes or jrig.pyramid_feat_shapes(tc.resize_size)
    jr = jrig.build_rig(calibs, tc, grid, shapes, tile_v=tile_v,
                        dtype=jnp.float32, band_buckets=buckets,
                        layout="window")
    tr = trig.build_rig(calibs, t_tiny_config(get_config(cfg.name)), grid,
                        shapes, tile_v=tile_v, dtype=torch.float32,
                        band_buckets=buckets, layout="window", device="cpu")
    return jr, tr


@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("cfg", [mc_opts, mx_opts, wt_opts], ids=lambda c: c.name)
def test_window_rig_identical_to_jax_build(cfg, buckets):
    """Exact equality: A, starts, inv_perm, window_hw, nl, tile_v."""
    jr, tr = _both_rigs(cfg, buckets)
    assert tr.grid_shape == jr.grid_shape
    assert len(tr.scales) == len(jr.scales) == 3
    for js, ts in zip(jr.scales, tr.scales):
        assert ts.window_hw == tuple(tuple(w) for w in js.window_hw)
        assert (ts.nl, ts.tile_v, ts.feat_hw) == (js.nl, js.tile_v, js.feat_hw)
        assert len(ts.A) == len(js.A)
        for ja, ta in zip(js.A, ts.A):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for jst, tst in zip(js.starts, ts.starts):
            assert tst.dtype == torch.int32
            np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(ts.inv_perm.numpy(),
                                      np.asarray(js.inv_perm))


def test_rig_helpers_match_jax():
    assert trig.pyramid_feat_shapes((720, 1280)) == jrig.pyramid_feat_shapes((720, 1280))
    for nl in (5, 8):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert trig.default_tile_v(nl, tdt) == jrig.default_tile_v(
                nl, "pallas", "window", dtype=jdt)
    jr, tr = _both_rigs(mc_opts, 3)
    assert trig.rig_matmul_flops(tr) == jrig.rig_matmul_flops(jr)
    with pytest.raises(ValueError, match="unknown rig layout"):
        trig.build_rig(np.zeros((1, 3, 4)), mc_opts, np.zeros((2, 2, 3)),
                       [(8, 8)], layout="banded", device="cpu")


@pytest.mark.parametrize("camera_sum", [False, True])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_plain_window_sampling_matches_jax(B, camera_sum):
    """The plain version (and the kernel wrapper, which takes it for CPU
    tensors) against `rig_sample_scale_pallas(interpret=True)` and the XLA
    scan `ops.rig.rig_sample_scale`. Tolerance as tests/test_rig.py:137
    (rtol 1e-4 / atol 1e-5, fp32 sums in another order)."""
    rng = np.random.default_rng(7 + B)
    jr, tr = _both_rigs(mc_opts, 3, shapes=[(12, 20)])
    js, ts = jr.scales[0], tr.scales[0]
    N, C, n_out = 2, 8, 12
    lat = rng.normal(size=(B, N, 12, 20, C)).astype(np.float32)
    # nl distinct weights per channel: a wrong Kr layout cannot pass
    k = rng.normal(size=(C * js.nl, n_out)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)

    want_pal = np.asarray(rig_sample_scale_pallas(
        jnp.asarray(lat), js, jnp.asarray(k), jnp.asarray(b), interpret=True,
        camera_sum=camera_sum))
    want_xla = np.asarray(jrig.rig_sample_scale(
        jnp.asarray(lat), js, jnp.asarray(k), jnp.asarray(b),
        camera_sum=camera_sum))
    tl, tk, tb = map(torch.from_numpy, (lat, k, b))
    got = trig.rig_sample_scale(tl, ts, tk, tb, camera_sum=camera_sum).numpy()
    launches = rig_window_fwd.launches
    got_w = rig_sample_scale_cuda(tl, ts, tk, tb, camera_sum=camera_sum).numpy()
    assert rig_window_fwd.launches == launches   # CPU: no kernel launch
    assert got.shape == want_pal.shape
    for g in (got, got_w):
        np.testing.assert_allclose(g, want_pal, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, want_xla, rtol=1e-4, atol=1e-5)


def test_wrapper_refuses_unknown_device():
    rng = np.random.default_rng(0)
    _, tr = _both_rigs(mc_opts, 1, shapes=[(12, 20)])
    sr = tr.scales[0]
    ii = trig.pad_features(torch.from_numpy(
        rng.normal(size=(1, 2, 12, 20, 8)).astype(np.float32)))
    Kr = torch.zeros((sr.nl, 8, 4))
    out = torch.empty((2, 1, sr.A[0].shape[1] * sr.tile_v, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        rig_window_fwd(ii.to("meta"), sr.A[0], sr.starts[0], Kr, out,
                       off_t=0, tile_v=sr.tile_v, window=sr.window_hw[0])
