"""The port's backward of one rig scale on the CPU: the plain version of
the backward kernel (`window_tiles_bwd`) and the autograd function of
`ops/rig_cuda.py` (which takes that plain version for CPU tensors) against
`jax.grad` of the Pallas formulation (interpret mode) and of the XLA scan
formulation, set up as tests/test_rig.py:205-244, and against torch
autograd of the plain forward. Tolerance rtol 1e-4 / atol 1e-4 (fp32 sums
in another order), as the JAX test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import mc_opts
from vfa_tpu.data.synthetic import make_calibrations, tiny_config
from vfa_tpu.geometry import make_grid
from vfa_tpu.ops import rig as jrig
from vfa_tpu.ops.rig_pallas import rig_sample_scale_pallas

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops.rig_cuda import (
    rig_sample_scale_cuda, rig_scale_bwd, rig_window_bwd, rig_window_fwd,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-4


def _scale_rigs(buckets):
    tc = tiny_config(mc_opts)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    calibs = make_calibrations(tc, 2)
    shapes = jrig.pyramid_feat_shapes(tc.resize_size)[:1]
    jr = jrig.build_rig(calibs, tc, grid, shapes, tile_v=16, dtype=jnp.float32,
                        band_buckets=buckets, layout="window")
    tr = trig.build_rig(calibs, t_tiny_config(get_config("MultiviewC")), grid,
                        shapes, tile_v=16, dtype=torch.float32,
                        band_buckets=buckets, layout="window", device="cpu")
    return jr.scales[0], tr.scales[0], shapes[0]


def _inputs(rng, B, sr, shape, C=8, n_out=12):
    fh, fw = shape
    lat = rng.normal(size=(B, 2, fh, fw, C)).astype(np.float32)
    # nl = 5 distinct weights per channel: a wrong Kr / dKr layout fails
    k = rng.normal(size=(C * sr.nl, n_out)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    w = rng.normal(size=(B, 2, sr.inv_perm.shape[1], n_out)).astype(np.float32)
    return lat, k, b, w


@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_scale_backward_matches_jax_grad(B, buckets):
    rng = np.random.default_rng(100 * buckets + B)
    js, ts, shape = _scale_rigs(buckets)
    assert ts.nl == 5 and len(ts.A) == len(js.A)
    lat, k, b, w = _inputs(rng, B, ts, shape)
    jb, jw = jnp.asarray(b), jnp.asarray(w)

    def loss_xla(lat, k):
        return jnp.sum(jrig.rig_sample_scale(lat, js, k, jb) * jw)

    def loss_pal(lat, k):
        return jnp.sum(rig_sample_scale_pallas(lat, js, k, jb, interpret=True) * jw)

    wants = [jax.grad(f, argnums=(0, 1))(jnp.asarray(lat), jnp.asarray(k))
             for f in (loss_xla, loss_pal)]

    fwd0, bwd0 = rig_window_fwd.launches, rig_window_bwd.launches
    gots = []
    for fn in (rig_sample_scale_cuda, trig.rig_sample_scale):
        tl = torch.from_numpy(lat).requires_grad_()
        tk = torch.from_numpy(k).requires_grad_()
        (fn(tl, ts, tk, torch.from_numpy(b)) * torch.from_numpy(w)).sum().backward()
        gots.append((tl.grad.numpy(), tk.grad.numpy()))
    # CPU tensors: the wrappers take the plain versions, no kernel launch
    assert (rig_window_fwd.launches, rig_window_bwd.launches) == (fwd0, bwd0)

    for g_lat, g_k in gots:
        assert g_lat.shape == lat.shape and g_k.shape == k.shape
        for w_lat, w_k in wants:
            np.testing.assert_allclose(g_lat, np.asarray(w_lat), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g_k, np.asarray(w_k), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [1, 2])
def test_window_tiles_bwd_matches_autograd_of_window_tiles(B):
    """The written-out backward, bucket by bucket through one dII, against
    torch autograd of the plain forward with a given cotangent."""
    rng = np.random.default_rng(31 + B)
    _, ts, shape = _scale_rigs(3)
    lat, k, _, _ = _inputs(rng, B, ts, shape)
    ii = trig.pad_features(torch.from_numpy(lat)).requires_grad_()
    Kr = trig.collapse_per_layer(torch.from_numpy(k), 8, ts.nl,
                                 torch.float32).requires_grad_()
    tiles = torch.cat([trig.window_tiles(ii, A_b, s_b, Kr, win, ts.tile_v)
                       for A_b, s_b, win in zip(ts.A, ts.starts, ts.window_hw)], 2)
    g = torch.from_numpy(rng.normal(size=tuple(tiles.shape)).astype(np.float32))
    tiles.backward(g)

    dII, dKr = rig_scale_bwd(ii.detach(), ts, Kr.detach(), g)
    np.testing.assert_allclose(dII.numpy(), ii.grad.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dKr.numpy(), Kr.grad.numpy(), rtol=RTOL, atol=ATOL)

    # bucket by bucket with a fresh dII each: the parts add up to the whole
    parts, off = [], 0
    for A_b, s_b, win in zip(ts.A, ts.starts, ts.window_hw):
        rows = A_b.shape[1] * ts.tile_v
        parts.append(trig.window_tiles_bwd(ii.detach(), A_b, s_b, Kr.detach(),
                                           g[:, :, off:off + rows], win, ts.tile_v))
        off += rows
    np.testing.assert_allclose(sum(p[0] for p in parts).numpy(), dII.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sum(p[1] for p in parts).numpy(), dKr.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_backward_wrapper_refuses_unknown_device():
    _, ts, shape = _scale_rigs(1)
    ii = trig.pad_features(torch.zeros((1, 2, *shape, 8)))
    Kr = torch.zeros((ts.nl, 8, 4))
    g = torch.zeros((2, 1, ts.A[0].shape[1] * ts.tile_v, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        rig_window_bwd(ii.to("meta"), ts.A[0], ts.starts[0], Kr, g,
                       torch.zeros_like(ii), torch.zeros_like(Kr), off_t=0,
                       tile_v=ts.tile_v, window=ts.window_hw[0])
