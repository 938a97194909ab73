"""The port's flat rig layout on the CPU against the JAX package: the host
build must be identical (prefix-folded with 1-3 buckets, and the 16-tap
form), and the plain PyTorch versions of the flat kernels (which the
wrappers of `ops/rig_cuda.py` take for CPU tensors) must match the Pallas
kernels (interpret mode) and the XLA scan formulation, forward and
gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import mc_opts, wt_opts
from vfa_tpu.data.synthetic import make_calibrations, tiny_config
from vfa_tpu.geometry import make_grid
from vfa_tpu.ops import rig as jrig
from vfa_tpu.ops.rig_pallas import rig_sample_scale_pallas

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops.rig_cuda import (
    rig_flat_bwd, rig_flat_fwd, rig_sample_scale_cuda, rig_scale_bwd,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _both_rigs(cfg, buckets, fold_prefix=True, tile_v=16, shapes=None,
               layout="flat"):
    tc = tiny_config(cfg)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    calibs = make_calibrations(tc, 2)
    shapes = shapes or jrig.pyramid_feat_shapes(tc.resize_size)
    jr = jrig.build_rig(calibs, tc, grid, shapes, tile_v=tile_v,
                        dtype=jnp.float32, band_buckets=buckets,
                        layout=layout, fold_prefix=fold_prefix)
    tr = trig.build_rig(calibs, t_tiny_config(get_config(cfg.name)), grid,
                        shapes, tile_v=tile_v, dtype=torch.float32,
                        band_buckets=buckets, layout=layout,
                        fold_prefix=fold_prefix, device="cpu")
    return jr, tr


@pytest.mark.parametrize("fold_prefix,buckets",
                         [(True, 1), (True, 2), (True, 3), (False, 1)],
                         ids=["fold-1", "fold-2", "fold-3", "taps-1"])
@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_flat_rig_identical_to_jax_build(cfg, fold_prefix, buckets):
    """Exact equality: A, starts, inv_perm, on_raw, nl, tile_v."""
    jr, tr = _both_rigs(cfg, buckets, fold_prefix)
    assert tr.grid_shape == jr.grid_shape
    assert len(tr.scales) == len(jr.scales) == 3
    for js, ts in zip(jr.scales, tr.scales):
        assert ts.window_hw == () == tuple(js.window_hw)
        assert ts.on_raw == js.on_raw == fold_prefix
        assert (ts.nl, ts.tile_v, ts.feat_hw) == (js.nl, js.tile_v, js.feat_hw)
        assert len(ts.A) == len(js.A)
        for ja, ta in zip(js.A, ts.A):
            assert ta.shape[-1] % 8 == 0
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for jst, tst in zip(js.starts, ts.starts):
            assert tst.dtype == torch.int32
            np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(ts.inv_perm.numpy(),
                                      np.asarray(js.inv_perm))


def test_flat_helpers_match_jax():
    for nl in (5, 8):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert trig.default_tile_v(nl, tdt, "flat") == jrig.default_tile_v(
                nl, "pallas", "flat", dtype=jdt) == 160
    jr, tr = _both_rigs(mc_opts, 3)
    assert trig.rig_matmul_flops(tr) == jrig.rig_matmul_flops(jr)
    grid = make_grid(tiny_config(mc_opts).world_size, mc_opts.cube_size[:2], "MultiviewC")
    with pytest.raises(ValueError, match="requires fold_prefix"):
        trig.build_rig(make_calibrations(tiny_config(mc_opts), 2),
                       t_tiny_config(get_config("MultiviewC")), grid, [(12, 20)],
                       tile_v=16, band_buckets=3, layout="flat",
                       fold_prefix=False, device="cpu")
    with pytest.raises(ValueError, match="window layout requires"):
        trig.build_rig(np.zeros((1, 3, 4)), mc_opts, np.zeros((2, 2, 3)),
                       [(8, 8)], layout="window", fold_prefix=False, device="cpu")


@pytest.mark.parametrize("fold_prefix,buckets", [(True, 1), (True, 3), (False, 1)],
                         ids=["fold-1", "fold-3", "taps-1"])
@pytest.mark.parametrize("camera_sum", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_flat_sampling_matches_jax(B, camera_sum, fold_prefix, buckets):
    """The plain version, and the kernel wrapper on CPU tensors, against
    JAX `rig_sample_scale` and `rig_sample_scale_pallas(interpret=True)`.
    Tolerance rtol 2e-3 / atol 2e-4 as tests/test_rig.py:47 (the 16-tap
    form differences integral-image values, fp32 sums in another order)."""
    rng = np.random.default_rng(11 + B)
    jr, tr = _both_rigs(mc_opts, buckets, fold_prefix, shapes=[(12, 20)])
    js, ts = jr.scales[0], tr.scales[0]
    N, C, n_out = 2, 8, 12
    lat = rng.normal(size=(B, N, 12, 20, C)).astype(np.float32)
    k = rng.normal(size=(C * js.nl, n_out)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    wants = [np.asarray(fn(jnp.asarray(lat), js, jnp.asarray(k), jnp.asarray(b),
                           camera_sum=camera_sum, **kw))
             for fn, kw in ((jrig.rig_sample_scale, {}),
                            (rig_sample_scale_pallas, {"interpret": True}))]
    tl, tk, tb = map(torch.from_numpy, (lat, k, b))
    launches = rig_flat_fwd.launches
    gots = [fn(tl, ts, tk, tb, camera_sum=camera_sum).numpy()
            for fn in (trig.rig_sample_scale, rig_sample_scale_cuda)]
    assert rig_flat_fwd.launches == launches       # CPU: no kernel launch
    for g in gots:
        assert g.shape == wants[0].shape
        for w in wants:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)


def test_flat_equals_window_in_the_port():
    """The two layouts regroup the same prefix-folded weights
    (tests/test_rig.py:175-202; rtol 1e-5 / atol 1e-6)."""
    rng = np.random.default_rng(5)
    tc = tiny_config(wt_opts)
    fh, fw = tc.resize_size[0] // 8, tc.resize_size[1] // 8
    _, flat = _both_rigs(wt_opts, 1, shapes=[(fh, fw)])
    _, flat2 = _both_rigs(wt_opts, 2, shapes=[(fh, fw)])
    _, win = _both_rigs(wt_opts, 2, shapes=[(fh, fw)], layout="window")
    nl = flat.scales[0].nl
    lat = torch.from_numpy(rng.normal(size=(2, 2, fh, fw, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(8 * nl, 12)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    want = trig.rig_sample_scale(lat, flat.scales[0], k, b).numpy()
    for other in (flat2, win):
        got = trig.rig_sample_scale(lat, other.scales[0], k, b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fold_prefix,buckets", [(True, 1), (True, 2), (False, 1)],
                         ids=["fold-1", "fold-2", "taps-1"])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_flat_backward_matches_jax_grad(B, fold_prefix, buckets):
    """Gradients of lat and the collapse kernel through `RigScaleTiles` on
    the flat rig (CPU: the plain backward) and through autograd of the
    plain forward, against `jax.grad` of the Pallas formulation (interpret
    mode) and of the XLA scan (rtol 1e-4 / atol 1e-4, tests/test_rig.py:205)."""
    rng = np.random.default_rng(200 * buckets + B)
    tc = tiny_config(mc_opts)
    shape = jrig.pyramid_feat_shapes(tc.resize_size)[0]
    jr, tr = _both_rigs(mc_opts, buckets, fold_prefix, shapes=[shape])
    js, ts = jr.scales[0], tr.scales[0]
    C, n_out = 8, 12
    lat = rng.normal(size=(B, 2, *shape, C)).astype(np.float32)
    k = rng.normal(size=(C * ts.nl, n_out)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    w = rng.normal(size=(B, 2, ts.inv_perm.shape[1], n_out)).astype(np.float32)
    jb, jw = jnp.asarray(b), jnp.asarray(w)

    def loss_xla(lat, k):
        return jnp.sum(jrig.rig_sample_scale(lat, js, k, jb) * jw)

    def loss_pal(lat, k):
        return jnp.sum(rig_sample_scale_pallas(lat, js, k, jb, interpret=True) * jw)

    wants = [jax.grad(f, argnums=(0, 1))(jnp.asarray(lat), jnp.asarray(k))
             for f in (loss_xla, loss_pal)]
    counts = (rig_flat_fwd.launches, rig_flat_bwd.launches)
    for fn in (rig_sample_scale_cuda, trig.rig_sample_scale):
        tl = torch.from_numpy(lat).requires_grad_()
        tk = torch.from_numpy(k).requires_grad_()
        (fn(tl, ts, tk, torch.from_numpy(b)) * torch.from_numpy(w)).sum().backward()
        tol = dict(rtol=1e-4, atol=1e-4)
        for w_lat, w_k in wants:
            np.testing.assert_allclose(tl.grad.numpy(), np.asarray(w_lat), **tol)
            np.testing.assert_allclose(tk.grad.numpy(), np.asarray(w_k), **tol)
    assert (rig_flat_fwd.launches, rig_flat_bwd.launches) == counts


def test_flat_tiles_bwd_matches_autograd_and_drops_padding():
    """The written-out flat backward, bucket by bucket through one dII,
    against autograd of the plain forward; the accumulator's padding rows
    get nothing that the features' gradient keeps."""
    rng = np.random.default_rng(41)
    tc = tiny_config(mc_opts)
    shape = jrig.pyramid_feat_shapes(tc.resize_size)[0]
    _, tr = _both_rigs(mc_opts, 2, shapes=[shape])
    ts = tr.scales[0]
    lat = torch.from_numpy(rng.normal(size=(2, 2, *shape, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(8 * ts.nl, 12)).astype(np.float32))
    ii = trig.pad_features_flat(lat, ts).requires_grad_()
    P, max_band = shape[0] * shape[1], max(a.shape[-1] for a in ts.A)
    assert ii.shape == (2, 2, P + max_band, 8)
    assert not ii[:, :, P:].any()
    Kr = trig.collapse_per_layer(k, 8, ts.nl, torch.float32).requires_grad_()
    tiles = trig.scale_tiles(ii, ts, Kr)
    g = torch.from_numpy(rng.normal(size=tuple(tiles.shape)).astype(np.float32))
    tiles.backward(g)
    dII, dKr = rig_scale_bwd(ii.detach(), ts, Kr.detach(), g)
    np.testing.assert_allclose(dII.numpy(), ii.grad.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dKr.numpy(), Kr.grad.numpy(), rtol=1e-4, atol=1e-4)


def test_flat_wrappers_refuse_unknown_device():
    _, tr = _both_rigs(mc_opts, 1, shapes=[(12, 20)])
    sr = tr.scales[0]
    ii = trig.pad_features_flat(torch.zeros((1, 2, 12, 20, 8)), sr)
    Kr = torch.zeros((sr.nl, 8, 4))
    rows = sr.A[0].shape[1] * sr.tile_v
    with pytest.raises(ValueError, match="unsupported device"):
        rig_flat_fwd(ii.to("meta"), sr.A[0], sr.starts[0], Kr,
                     torch.empty((2, 1, rows, 4)), off_t=0, tile_v=sr.tile_v)
    with pytest.raises(ValueError, match="unsupported device"):
        rig_flat_bwd(ii.to("meta"), sr.A[0], sr.starts[0], Kr,
                     torch.zeros((2, 1, rows, 4)), torch.zeros_like(ii),
                     torch.zeros_like(Kr), off_t=0, tile_v=sr.tile_v)
