"""bf16 serving in the port against the JAX package, on the CPU: the bf16
rig build (exact), the plain bf16 rig tiles (the kernels' plain versions,
which the wrappers take for CPU tensors) against the Pallas kernels in
interpret mode, the norms and the whole bf16 forward with the variables
cast as the root bench casts them (`bench.py:260-263`), and the CLI rig
helper's bf16 policy.

Budget, as tests/test_rig.py:248 holds bf16 against fp32: max abs err
<= 0.03 of the reference's max and rel-L2 < 0.03. Where both sides round
at the same points, each test also asserts a bound a small factor above
the error measured here (stated beside it)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from vfa_tpu.config import TrainConfig, mc_opts, mx_opts, wt_opts
from vfa_tpu.data.synthetic import make_calibrations, make_scene, tiny_config
from vfa_tpu.geometry import make_grid
from vfa_tpu.model.resnet import group_norm as flax_group_norm
from vfa_tpu.ops import rig as jrig
from vfa_tpu.ops.rig_pallas import rig_sample_scale_pallas
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import rig_cli
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.model.resnet import group_norm
from vfa_tpu_torch.model.vfanet import BatchNorm2dBiased, VFANet, cast_model
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops.rig_cuda import (
    rig_flat_fwd, rig_flat_fwd_bf16, rig_sample_scale_cuda, rig_window_fwd,
    rig_window_fwd_bf16,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BUDGET_MAX, BUDGET_L2 = 0.03, 0.03


def _errors(got, want):
    """(max abs err / max |want|, rel-L2) in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    return (np.abs(got - want).max() / scale,
            np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _within(got, want, max_tight, l2_tight):
    """Within the bf16 budget, and within the tighter bounds measured for
    this comparison."""
    e_max, e_l2 = _errors(got, want)
    assert e_max <= BUDGET_MAX and e_l2 < BUDGET_L2, (e_max, e_l2)
    assert e_max <= max_tight and e_l2 <= l2_tight, (e_max, e_l2)


def _bf16(x):
    """A float32 numpy array rounded to bf16, as (jax array, torch tensor)
    holding the same bits."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _both_rigs(cfg, layout, tile_v, buckets=3, shapes=None):
    tc = tiny_config(cfg)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    calibs = make_calibrations(tc, 2)
    shapes = shapes or jrig.pyramid_feat_shapes(tc.resize_size)
    jr = jrig.build_rig(calibs, tc, grid, shapes, tile_v=tile_v,
                        dtype=jnp.bfloat16, band_buckets=buckets, layout=layout)
    tr = trig.build_rig(calibs, t_tiny_config(get_config(cfg.name)), grid,
                        shapes, tile_v=tile_v, dtype=torch.bfloat16,
                        band_buckets=buckets, layout=layout, device="cpu")
    return jr, tr


@pytest.mark.parametrize("layout,cfg,tile_v", [
    ("window", mc_opts, 16), ("window", mc_opts, 160), ("window", mx_opts, 16),
    ("window", mx_opts, 64), ("window", wt_opts, 64), ("flat", mc_opts, 16),
    ("flat", wt_opts, 160),
], ids=["window-mc-16", "window-mc-160", "window-mx-16", "window-mx-64",
        "window-wt-64", "flat-mc-16", "flat-wt-160"])
def test_bf16_rig_identical_to_jax_build(layout, cfg, tile_v):
    """The bf16 build equals JAX's bf16 build exactly: A bit for bit,
    starts, inv_perm, window_hw, nl, tile_v (160 / 64 are JAX's bf16
    defaults for nl 5 / 8)."""
    jr, tr = _both_rigs(cfg, layout, tile_v)
    assert tr.grid_shape == jr.grid_shape
    for js, ts in zip(jr.scales, tr.scales):
        assert ts.window_hw == tuple(tuple(w) for w in js.window_hw)
        assert (ts.nl, ts.tile_v, ts.feat_hw) == (js.nl, js.tile_v, js.feat_hw)
        assert len(ts.A) == len(js.A)
        for ja, ta in zip(js.A, ts.A):
            assert ta.dtype == torch.bfloat16 and ja.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                ta.view(torch.int16).numpy(),
                np.asarray(ja).view(np.int16))
        for jst, tst in zip(js.starts, ts.starts):
            np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(ts.inv_perm.numpy(), np.asarray(js.inv_perm))


def test_bf16_flat_rig_is_the_fp32_flat_rig_cast():
    """A flat rig's tile_v does not depend on the dtype, and its A is built
    in float32 and then cast: the bf16 flat rig equals the fp32 flat rig
    with A cast to bf16 (which `chip_smoke.py` uses instead of a second
    full-width build)."""
    tc = t_tiny_config(get_config("MultiviewC"))
    args = (make_calibrations(tc), tc,
            make_grid(tc.world_size, tc.cube_size[:2], tc.name),
            trig.pyramid_feat_shapes(tc.resize_size))
    kw = dict(tile_v=160, band_buckets=3, layout="flat", device="cpu")
    r32 = trig.build_rig(*args, dtype=torch.float32, **kw)
    r16 = trig.build_rig(*args, dtype=torch.bfloat16, **kw)
    for s32, s16 in zip(r32.scales, r16.scales):
        for a32, a16 in zip(s32.A, s16.A):
            assert torch.equal(a32.to(torch.bfloat16).view(torch.int16),
                               a16.view(torch.int16))
        for t32, t16 in zip(s32.starts, s16.starts):
            assert torch.equal(t32, t16)
        assert torch.equal(s32.inv_perm, s16.inv_perm)


# measured here: 0 / 0 in every case (the same bits: both sides round vox
# and the tiles at the same points, and the sums agree); the bounds leave
# room for a one-ulp flip of a sum taken in another order
TILES_MAX, TILES_L2 = 1e-2, 4e-3


@pytest.mark.parametrize("layout", ["window", "flat"])
@pytest.mark.parametrize("camera_sum", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_bf16_tiles_match_jax(layout, camera_sum, B):
    """The plain bf16 rig sampling (and the kernel wrappers on CPU tensors:
    no kernel launches) against `rig_sample_scale_pallas(interpret=True)`
    on the same bf16 features, collapse kernel, bias and bf16-built rig.
    Both round vox to bf16 after the A product, the tiles to bf16 after the
    collapse and add the bias in bf16."""
    rng = np.random.default_rng(31 + B)
    jr, tr = _both_rigs(mc_opts, layout, 16, shapes=[(12, 20)])
    js, ts = jr.scales[0], tr.scales[0]
    N, C, n_out = 2, 16, 16
    jl, tl = _bf16(rng.uniform(0, 1, size=(B, N, 12, 20, C)))
    jk, tk = _bf16(rng.normal(size=(C * js.nl, n_out)) * 0.2)
    jb, tb = _bf16(rng.normal(size=(n_out,)))
    want = np.asarray(rig_sample_scale_pallas(
        jl, js, jk, jb, out_dtype=jnp.float32, interpret=True,
        camera_sum=camera_sum))
    counts = (rig_window_fwd.launches, rig_flat_fwd.launches,
              rig_window_fwd_bf16.launches, rig_flat_fwd_bf16.launches)
    for fn in (trig.rig_sample_scale, rig_sample_scale_cuda):
        got = fn(tl, ts, tk, tb, out_dtype=torch.float32, camera_sum=camera_sum)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _within(got.numpy(), want, TILES_MAX, TILES_L2)
    assert counts == (rig_window_fwd.launches, rig_flat_fwd.launches,
                      rig_window_fwd_bf16.launches, rig_flat_fwd_bf16.launches)


def test_bf16_norms_match_flax():
    """GroupNorm(16) and an eval-mode BatchNorm on bf16 inputs with bf16
    parameters and running statistics, against flax's. Flax reduces the
    GroupNorm statistics in fp32 and rounds once, as torch does (measured
    max 2.9e-6 / L2 1.2e-7: its E[x^2] - E[x]^2 variance flips a rounding
    now and then); its eval BatchNorm rounds every op in bf16, which
    `BatchNorm2dBiased` repeats (measured 0 / 0; `F.batch_norm`'s single
    rounding gave max 6.8e-3 / L2 4.1e-3). Bounds: about one bf16 ulp
    (2^-8) at the max."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 10, 64)) * 3 + 1
    jx, tx = _bf16(x)
    tx = tx.permute(0, 3, 1, 2)
    scale, bias = rng.uniform(0.5, 1.5, 64), rng.normal(size=64)
    mean, var = rng.normal(size=64) * 0.5, rng.uniform(0.5, 2.0, 64)
    (js, ts), (jbias, tbias) = _bf16(scale), _bf16(bias)
    (jm, tm), (jv, tv) = _bf16(mean), _bf16(var)

    want = flax_group_norm().apply({"params": {"scale": js, "bias": jbias}}, jx)
    gn = group_norm(64).to(torch.bfloat16)
    gn.weight.data, gn.bias.data = ts.clone(), tbias.clone()
    with torch.no_grad():
        got = gn(tx).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    _within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 4e-3, 1e-4)

    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=True)
    want = bn.apply({"params": {"scale": js, "bias": jbias},
                     "batch_stats": {"mean": jm, "var": jv}}, jx)
    tbn = BatchNorm2dBiased(64, eps=1e-5, momentum=0.1).to(torch.bfloat16).eval()
    tbn.weight.data, tbn.bias.data = ts.clone(), tbias.clone()
    tbn.running_mean.data, tbn.running_var.data = tm.clone(), tv.clone()
    with torch.no_grad():
        got = tbn(tx).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    _within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 4e-3, 1e-3)


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.normal(size=x.shape))
        .astype(np.float32), tree)


def _random_stats(stats, rng):
    return {name: {"mean": (0.1 * rng.normal(size=s["mean"].shape)).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, size=s["var"].shape).astype(np.float32)}
            for name, s in stats.items()}


def test_cast_model_casts_every_floating_tensor():
    """`cast_model` casts every floating parameter and buffer (BatchNorm
    running statistics and the ImageNet constants included) and nothing
    else, as the root bench casts every fp32 variable."""
    model = cast_model(VFANet(t_tiny_config(get_config("MultiviewC"))),
                       torch.bfloat16)
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    for name, t in tensors.items():
        want = torch.long if name.endswith("num_batches_tracked") else torch.bfloat16
        assert t.dtype == want, name
    assert {"img_mean", "img_std", "fuse.1.running_mean",
            "fuse.4.running_var"} <= set(tensors)


# measured here (the whole tiny model, bf16 both sides): MultiviewC
# heatmap max 1.03e-2 / L2 7.4e-3, loc_offset 9.0e-3 / 8.6e-3, the 3D heads
# below that; Wildtrack heatmap 9.8e-3 / 6.6e-3, loc_offset 6.9e-3 / 5.5e-3
MODEL_MAX, MODEL_L2 = 0.02, 0.015


@pytest.mark.medium
@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_vfanet_bf16_serving_forward_matches_jax(cfg):
    """The whole serving forward in bf16: JAX with every fp32 variable
    (params and batch_stats) cast to bf16 as `bench.py:260-263` does, bf16
    images and a bf16-built rig, the Pallas kernels in interpret mode,
    against the port's VFANet after `cast_model`, on the same bf16 images
    and rig (the kernels' plain versions on the CPU). Heatmap, loc_offset
    and, in 3D, dim_offset and rotation, each in fp32 as the decoder reads
    them. Both sides round at the same points: the norms as in
    test_bf16_norms_match_flax, a convolution's bias added after the
    product is rounded (`model/vfanet.py::Conv2d`, as flax), the rig tiles
    as in test_bf16_tiles_match_jax. What differs is in the last bits of
    fp32 sums (the GroupNorm variance, the convolutions' order), which
    flips a bf16 rounding here and there; through the random-weight ResNet
    those flips grow to about 1e-2 of an output's max."""
    rng = np.random.default_rng(11)
    tc = tiny_config(cfg)
    scenes = [make_scene(tc, seed=s, num_objects=3) for s in range(2)]
    images = np.stack([s.images for s in scenes])
    calibs = np.stack([s.calibs for s in scenes])
    grid = scenes[0].grid
    shapes = jrig.pyramid_feat_shapes(tc.resize_size)

    jmodel = create_model(tc, TrainConfig(pretrained=False), rig_impl="pallas")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                     jnp.asarray(calibs), jnp.asarray(grid))
    params = _perturb(variables["params"], rng)
    stats = _random_stats(variables["batch_stats"], rng)
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                                   {"params": params, "batch_stats": stats})
    jimages, timages = _bf16(images)
    jr = jrig.build_rig(scenes[0].calibs, tc, grid, shapes, tile_v=16,
                        dtype=jnp.bfloat16, band_buckets=3, layout="window")
    want = jmodel.apply(jvars, jimages, jnp.asarray(calibs), jnp.asarray(grid),
                        train=False, rig=jr)

    model = VFANet(t_tiny_config(get_config(cfg.name)))
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    model = cast_model(model, torch.bfloat16).eval()
    tr = trig.build_rig(scenes[0].calibs, t_tiny_config(get_config(cfg.name)),
                        grid, shapes, tile_v=16, dtype=torch.bfloat16,
                        band_buckets=3, device="cpu")
    with torch.no_grad():
        got = model(timages, tr)

    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key].astype(jnp.float32))
        g = got[key].float().numpy()
        assert got[key].dtype == torch.bfloat16 and g.shape == w.shape, key
        _within(g, w, MODEL_MAX, MODEL_L2)


@pytest.mark.parametrize("layout", ["window", "flat"])
def test_build_cli_rig_bf16_policy(tmp_path, capsys, layout):
    """`build_cli_rig(dtype=torch.bfloat16)` takes JAX's bf16 tile_v for
    the layout, builds A in bf16, says so in its `compiled rig` line, and
    caches under a key of its own (the fp32 rig is a second file)."""
    tc = t_tiny_config(get_config("Wildtrack"))
    calibs = make_calibrations(tiny_config(wt_opts))
    cache = str(tmp_path / "rigs")
    r16 = rig_cli.build_cli_rig(tc, calibs, "cpu", layout=layout, cache_dir=cache,
                                dtype=torch.bfloat16)
    line = capsys.readouterr().out
    want_tv = jrig.default_tile_v(tc.num_layers, "pallas", layout,
                                  dtype=jnp.bfloat16)
    assert r16.scales[0].tile_v == want_tv
    assert re.search(rf"tile_v {want_tv}, bf16, {layout} layout", line), line
    assert all(a.dtype == torch.bfloat16 for s in r16.scales for a in s.A)
    r32 = rig_cli.build_cli_rig(tc, calibs, "cpu", layout=layout, cache_dir=cache)
    assert "fp32" in capsys.readouterr().out
    assert all(a.dtype == torch.float32 for s in r32.scales for a in s.A)
    assert len(list((tmp_path / "rigs").iterdir())) == 2
    rig_cli.build_cli_rig(tc, calibs, "cpu", layout=layout, cache_dir=cache,
                          dtype=torch.bfloat16)
    assert "cache hit" in capsys.readouterr().out
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rig_cli.build_cli_rig(tc, calibs, "cpu", dtype=torch.float16)
