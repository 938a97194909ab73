"""The port's data pipeline against the JAX package's on the mini on-disk
datasets of tests/test_adapters.py: `FrameDataset` (split rules,
Wildtrack's stride 5) and `SceneLoader` batches (float32 and uint8
staging, the shuffle order for one seed, drop_last, the strided process
shards), the native image decoder built from the same source
(`native/imageio.cpp`) and the PIL one, all exactly equal; and the MODA
matcher's ctypes loader against scipy."""

import dataclasses
import os

import numpy as np
import pytest

from test_adapters import _mini_pedestrian, mini_mc  # noqa: F401  (fixture)
from vfa_tpu.config import mc_opts as j_mc_opts
from vfa_tpu.config import wt_opts as j_wt_opts
from vfa_tpu.data import adapters as jad
from vfa_tpu.data.frame_dataset import FrameDataset as JFrameDataset
from vfa_tpu.data.frame_dataset import SceneLoader as JSceneLoader
from vfa_tpu.native import imageio as jimageio

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data import adapters
from vfa_tpu_torch.data.frame_dataset import FrameDataset, SceneLoader
from vfa_tpu_torch.native import (
    batch_linear_sum_assignment, linear_sum_assignment, matcher_backend,
)
from vfa_tpu_torch.native import imageio
from vfa_tpu_torch.train_lib import stage_images

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "objects":
                assert [[o.classname for o in s] for s in g[k]] == \
                       [[o.classname for o in s] for s in w[k]]
                continue
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _mc(mini_mc, tmp_path):  # noqa: F811
    jbase = jad.MultiviewC(mini_mc, cache_dir=str(tmp_path / "jax"))
    base = adapters.MultiviewC(mini_mc, cache_dir=str(tmp_path / "port"))
    jbase.num_frame = base.num_frame = 4
    jcfg = dataclasses.replace(j_mc_opts, root=mini_mc, resize_size=(32, 48))
    cfg = dataclasses.replace(get_config("MultiviewC"), root=mini_mc,
                              resize_size=(32, 48))
    return base, cfg, jbase, jcfg


@pytest.mark.parametrize("images_dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_scene_loader_matches_jax(mini_mc, tmp_path, images_dtype):  # noqa: F811
    base, cfg, jbase, jcfg = _mc(mini_mc, tmp_path)
    for split in ("train", "val"):
        ds = FrameDataset(base, cfg, split=split, train_ratio=0.75)
        jds = JFrameDataset(jbase, jcfg, split=split, train_ratio=0.75)
        assert ds.frame_range == jds.frame_range
        np.testing.assert_array_equal(np.stack(ds.heatmaps), np.stack(jds.heatmaps))
        np.testing.assert_array_equal(ds.grid, jds.grid)
    ds = FrameDataset(base, cfg, split="train", train_ratio=0.75)
    jds = JFrameDataset(jbase, jcfg, split="train", train_ratio=0.75)
    kw = dict(batch_size=2, shuffle=True, seed=5, max_objects=8,
              images_dtype=images_dtype)
    # two epochs of one loader: the shuffle order and the staging ring
    loader, jloader = SceneLoader(ds, **kw), JSceneLoader(jds, **kw)
    for _ in range(2):
        got = [{k: np.copy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
               for b in loader]
        want = [{k: np.copy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
                for b in jloader]
        _same_batches(got, want)
    assert got[0]["images"].dtype == images_dtype
    if images_dtype == np.uint8:
        u8 = list(SceneLoader(ds, **kw))
        f32 = list(SceneLoader(ds, **{**kw, "images_dtype": np.float32}))
        for u, f in zip(u8, f32):
            np.testing.assert_array_equal(u["frame"], f["frame"])
            # the device normalization of the uint8 stage gives the float
            # loader's pixels bit for bit
            np.testing.assert_array_equal(stage_images(u["images"], "cpu").numpy(),
                                          f["images"])


@pytest.mark.parametrize("process_id", [0, 1])
def test_scene_loader_shards_and_drop_last_match_jax(mini_mc, tmp_path, process_id):  # noqa: F811
    base, cfg, jbase, jcfg = _mc(mini_mc, tmp_path)
    ds = FrameDataset(base, cfg, split="train", train_ratio=1.0)
    jds = JFrameDataset(jbase, jcfg, split="train", train_ratio=1.0)
    for kw in (dict(batch_size=1, shuffle=True, seed=2, process_id=process_id,
                    process_count=2),
               dict(batch_size=3, shuffle=False, drop_last=True)):
        loader, jloader = SceneLoader(ds, **kw), JSceneLoader(jds, **kw)
        assert len(loader) == len(jloader)
        _same_batches(list(loader), list(jloader))


def test_wildtrack_stride_5_split_matches_jax(tmp_path):
    root = _mini_pedestrian(tmp_path, jad.Wildtrack, 7, 10, 480,
                            jad._WT_INTR, jad._WT_EXTR, "intrinsic_zero")
    jbase = jad.Wildtrack(root, cache_dir=str(tmp_path / "jax"))
    base = adapters.Wildtrack(root, cache_dir=str(tmp_path / "port"))
    jcfg = dataclasses.replace(j_wt_opts, root=root, resize_size=(32, 48))
    cfg = dataclasses.replace(get_config("Wildtrack"), root=root, resize_size=(32, 48))
    for split in ("train", "val"):
        ds = FrameDataset(base, cfg, split=split)
        jds = JFrameDataset(jbase, jcfg, split=split)
        assert ds.frame_range == jds.frame_range and ds.frame_range.step == 5
        np.testing.assert_array_equal(np.stack(ds.heatmaps), np.stack(jds.heatmaps))
        assert [len(x) for x in ds.labels] == [len(x) for x in jds.labels]


@pytest.mark.parametrize("out_dtype", [None, np.float32, np.uint8])
@pytest.mark.parametrize("size", [(32, 48), (20, 30)], ids=["native_size", "resized"])
def test_image_decoders_match_jax(mini_mc, size, out_dtype):  # noqa: F811
    """Both decoders, into a fresh array or a slot of either dtype, with and
    without a resize: the port's bytes are the JAX package's (the native
    library is built from the same source)."""
    path = os.path.join(mini_mc, "images", "C3", "0002.png")
    for backend in ("native", "pil"):
        out = None if out_dtype is None else np.empty((*size, 3), out_dtype)
        jout = None if out_dtype is None else np.empty((*size, 3), out_dtype)
        got = imageio.load_image(path, size, backend, out=out)
        want = jimageio.load_image(path, size, backend, out=jout)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert imageio.native_available() == jimageio.native_available()
    assert imageio.decoder_backend("pil") == "PIL"
    assert imageio.decoder_backend("native").startswith(
        "native" if imageio.native_available() else "PIL")


def test_matching_backends_agree(monkeypatch):
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 10, (6, 9))
    r, c = linear_sum_assignment(cost)
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    sr, sc = scipy_lsa(cost)
    assert cost[r, c].sum() == pytest.approx(cost[sr, sc].sum(), abs=1e-12)
    costs = rng.uniform(0, 10, (4, 5, 7))
    ns, ms = np.array([5, 3, 0, 2]), np.array([7, 7, 4, 1])
    native = batch_linear_sum_assignment(costs, ns, ms)
    with monkeypatch.context() as m:
        m.setenv("VFA_TPU_NATIVE_MATCHING", "0")
        assert matcher_backend() == "scipy.optimize.linear_sum_assignment"
        plain = batch_linear_sum_assignment(costs, ns, ms)
    for b in range(4):
        rows = np.nonzero(native[b] >= 0)[0]
        prow = np.nonzero(plain[b] >= 0)[0]
        assert costs[b, rows, native[b, rows]].sum() == pytest.approx(
            costs[b, prow, plain[b, prow]].sum(), abs=1e-12)
    assert matcher_backend().startswith("native")
