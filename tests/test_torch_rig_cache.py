"""The port's rig disk cache: a cached rig equals a freshly built one
exactly, every keyed input misses the cache, and nothing is written
without a cache directory. Also the builder's FLOP count against the JAX
package's, integer for integer."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vfa_tpu.config import mc_opts, wt_opts
from vfa_tpu.data.synthetic import make_calibrations, tiny_config
from vfa_tpu.geometry import make_grid
from vfa_tpu.ops import rig as jrig

from vfa_tpu_torch import rig_cli
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.ops import rig as trig

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(cfg=mc_opts):
    tc = tiny_config(cfg)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    return (t_tiny_config(get_config(cfg.name)), make_calibrations(tc, 2), grid,
            jrig.pyramid_feat_shapes(tc.resize_size))


def _build(cache_dir=None, layout="window", dtype=torch.float32, buckets=3,
           tile_v=16, calibs=None, cfg=mc_opts):
    tc, c, grid, shapes = _inputs(cfg)
    return trig.build_rig(c if calibs is None else calibs, tc, grid, shapes,
                          tile_v=tile_v, dtype=dtype, band_buckets=buckets,
                          layout=layout, device="cpu", cache_dir=cache_dir)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_rig(a, b):
    assert a.grid_shape == b.grid_shape and len(a.scales) == len(b.scales)
    for sa, sb in zip(a.scales, b.scales):
        assert (sa.nl, sa.tile_v, sa.on_raw, sa.feat_hw, sa.window_hw) == (
            sb.nl, sb.tile_v, sb.on_raw, sb.feat_hw, sb.window_hw)
        assert len(sa.A) == len(sb.A)
        for x, y in zip(sa.A, sb.A):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y))
        for x, y in zip(sa.starts, sb.starts):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert sa.inv_perm.dtype == sb.inv_perm.dtype == torch.int64
        assert torch.equal(sa.inv_perm, sb.inv_perm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("layout", ["window", "flat"])
def test_cached_rig_equals_fresh_build(tmp_path, layout, dtype):
    fresh = _build(layout=layout, dtype=dtype)
    first = _build(str(tmp_path), layout=layout, dtype=dtype)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("torch_rig_")
    loaded = _build(str(tmp_path), layout=layout, dtype=dtype)
    assert os.listdir(tmp_path) == files
    _assert_same_rig(first, fresh)
    _assert_same_rig(loaded, fresh)
    if dtype == torch.bfloat16:
        with np.load(tmp_path / files[0]) as z:
            assert z["A0_0"].dtype == np.uint16


@pytest.mark.parametrize("change", ["calibs", "buckets", "layout", "dtype",
                                    "tile_v", "version"])
def test_each_keyed_input_misses_the_cache(tmp_path, monkeypatch, change):
    _build(str(tmp_path))
    kw = {"calibs": {"calibs": _inputs()[1] * np.float32(1.001)},
          "buckets": {"buckets": 2},
          "layout": {"layout": "flat"},
          "dtype": {"dtype": torch.bfloat16},
          "tile_v": {"tile_v": 24},
          "version": {}}[change]
    if change == "version":
        monkeypatch.setattr(trig, "RIG_CACHE_VERSION", "another-builder")
    got = _build(str(tmp_path), **kw)
    assert len(os.listdir(tmp_path)) == 2
    _assert_same_rig(got, _build(**kw))


def test_nothing_is_written_without_a_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    _build()
    tc, calibs, _, _ = _inputs(wt_opts)
    rig_cli.build_cli_rig(tc, calibs, "cpu")
    assert os.listdir(tmp_path) == []


def test_cli_rig_reports_build_and_cache_hit(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    tc, calibs, _, _ = _inputs(wt_opts)
    a = rig_cli.build_cli_rig(tc, calibs, "cpu", cache_dir=rig_cli.RIG_CACHE_DIR)
    assert ", built in " in capsys.readouterr().out
    b = rig_cli.build_cli_rig(tc, calibs, "cpu", cache_dir=rig_cli.RIG_CACHE_DIR)
    assert ", cache hit in " in capsys.readouterr().out
    assert len(os.listdir(tmp_path / ".cache" / "vfa_tpu_torch_rig")) == 1
    _assert_same_rig(a, b)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", ["window", "flat"])
def test_rig_matmul_flops_matches_jax(layout, train):
    tc, calibs, grid, shapes = _inputs(wt_opts)
    jr = jrig.build_rig(calibs, tiny_config(wt_opts), grid, shapes, tile_v=16,
                        dtype=jnp.float32, band_buckets=3, layout=layout)
    tr = _build(layout=layout, cfg=wt_opts)
    want = jrig.rig_matmul_flops(jr, train=train)
    assert isinstance(want, int) and want > 0
    assert trig.rig_matmul_flops(tr, train=train) == want
