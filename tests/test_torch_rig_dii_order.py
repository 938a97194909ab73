"""The fixed order of the bf16 backwards' dII adds
(`ops/rig.window_dii_index`, `flat_dii_index`, the per-pixel add lists the
card's dII pass walks), on tiny bf16 window and flat rigs on the CPU: each
(pixel, tile, band position) add is listed once, the adds of a pixel run
bucket by bucket and tile by tile (layer by layer inside a tile where JAX's
window backward is serial, `window_bwd_serial`; a flat band never is), the
plain backward made in the index's order (`_ordered_bwd`,
`_ordered_flat_bwd`) equals the plain backward `_tiles_bwd` bit for bit,
and a built or cached rig carries the index (`ScaleRig.dii_order`)."""

import numpy as np
import pytest
import torch

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops import rig as trig

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def scale():
    tc = tiny_config(get_config("MultiviewC"))
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    rig = trig.build_rig(make_calibrations(tc, 2), tc, grid, [(12, 20)],
                         tile_v=16, dtype=torch.bfloat16, band_buckets=3,
                         device="cpu")
    return rig.scales[0]


def _entries(index, Wp: int, layers: int):
    """The index expanded into its adds, in order: (camera, pixel row,
    pixel column, tile, window position, layer); `layers` = nl on a serial
    bucket (one add per layer, layer by layer inside a tile), 1 otherwise
    (layer 0: the whole window). An int64 numpy array (n_adds, 6)."""
    pixels, ptr, adds = index
    counts = np.diff(ptr)
    cam = np.repeat(pixels[:, 0], counts)
    pix = np.repeat(pixels[:, 1], counts)
    rows = np.stack([cam, pix // Wp, pix % Wp, adds[:, 0], adds[:, 1]], 1)
    rows = np.repeat(rows, layers, axis=0)
    layer = np.tile(np.arange(layers), len(adds))[:, None]
    return np.concatenate([rows, layer], 1).astype(np.int64)


def _ordered_bwd(ii, A_b, starts_b, Kr, g_b, window, tile_v, dII):
    """`window_tiles_bwd` (bf16) with its dII adds made one at a time in the
    order of `window_dii_index`, the order the card's dII pass takes: the
    same values and rounding points, so the same bits when the two orders
    agree."""
    N, B, Hp, Wp, C = ii.shape
    T, R, K = A_b.shape[1:]
    nl = Kr.shape[0]
    serial = trig.window_bwd_serial(B, K, R, A_b.element_size(),
                                    ii.element_size(), C)
    pix = trig._window_pixels(starts_b, N, T, Hp, Wp, window)
    dKr, dband = trig._window_dband(ii, A_b, pix, Kr, g_b, tile_v, serial)
    entries = _entries(trig.window_dii_index(starts_b, window, Hp, Wp), Wp,
                       nl if serial else 1)
    img = dII.permute(0, 2, 3, 1, 4).reshape(N, Hp, Wp, B * C).clone()
    for n, y, x, t, k, layer in entries.tolist():
        img[n, y, x] = (img[n, y, x].float()
                        + dband[n, t, layer, k]).to(torch.bfloat16)
    dII.copy_(img.reshape(N, Hp, Wp, B, C).permute(0, 3, 1, 2, 4))
    return dII, dKr


def _image(scale):
    wh_max = max(w for w, _ in scale.window_hw)
    Hp = trig._round_up(scale.feat_hw[0], 8)
    Wp = trig._round_up(scale.feat_hw[1], 16)
    assert wh_max <= Hp
    return Hp, Wp


def test_every_add_listed_once(scale):
    """Expanding each bucket's index gives every (camera, pixel, tile,
    window position) of its windows exactly once, and nothing else."""
    Hp, Wp = _image(scale)
    for s_b, win in zip(scale.starts, scale.window_hw):
        index = trig.window_dii_index(s_b, win, Hp, Wp)
        got = _entries(index, Wp, 1)[:, :5]
        wh, ww = win
        st = s_b.numpy()
        want = [(n, st[n, t, 0] + k // ww, st[n, t, 1] + k % ww, t, k)
                for n in range(st.shape[0]) for t in range(st.shape[1])
                for k in range(wh * ww)]
        assert len(got) == len(want)
        assert len({tuple(e) for e in got.tolist()}) == len(got)
        assert sorted(map(tuple, got.tolist())) == sorted(want)
        pixels, ptr, adds = index
        assert (np.diff(ptr) > 0).all() and ptr[-1] == len(adds)
        assert len(np.unique(pixels, axis=0)) == len(pixels)


@pytest.mark.parametrize("serial", [False, True], ids=["pipelined", "serial"])
def test_adds_run_bucket_then_tile_then_layer(scale, serial):
    """For each pixel, the adds of the whole scale, bucket by bucket in
    launch order, come in (bucket, tile, layer) order; a serial bucket
    lists each window position once per layer."""
    Hp, Wp = _image(scale)
    seq = {}
    for bi, (s_b, win) in enumerate(zip(scale.starts, scale.window_hw)):
        layers = scale.nl if serial else 1
        e = _entries(trig.window_dii_index(s_b, win, Hp, Wp),
                                    Wp, layers)
        for n, y, x, t, k, layer in e.tolist():
            seq.setdefault((n, y, x), []).append((bi, t, layer, k))
    assert seq
    for adds in seq.values():
        order = [a[:3] for a in adds]
        assert order == sorted(order) and len(set(order)) == len(order)
        if serial:
            per = {}
            for bi, t, layer, k in adds:
                per.setdefault((bi, t, k), []).append(layer)
            assert all(v == list(range(scale.nl)) for v in per.values())


@pytest.mark.parametrize("B,force_serial", [(1, False), (2, False), (2, True)],
                         ids=["B1-serial", "B2-pipelined", "B2-serial"])
def test_ordered_plain_backward_equals_tiles_bwd(scale, monkeypatch, B,
                                                 force_serial):
    """The plain bf16 backward with its dII adds made one at a time in the
    index's order equals `window_tiles_bwd` (the tile-order plain version)
    bit for bit over every bucket of the scale, dII carried across
    buckets. B = 1 is serial by JAX's rule; B = 2 serial takes a budget of
    0 bytes, so that every bucket rounds per layer as the full-width
    scale 0 buckets 6 and 7 do."""
    if force_serial:
        monkeypatch.setattr(trig, "WINDOW_BWD_BUDGET", 0)
    rng = np.random.default_rng(B)
    Hp, Wp = _image(scale)
    C = 16
    feats = rng.uniform(0, 1, size=(B, 2, *scale.feat_hw, C))
    ii = trig.pad_features(torch.from_numpy(feats).float()).to(torch.bfloat16)
    assert ii.shape[2:4] == (Hp, Wp)
    Kr = torch.from_numpy(rng.normal(size=(scale.nl, C, C)) * 0.2).to(torch.bfloat16)
    d_ref = torch.zeros_like(ii)
    d_ord = torch.zeros_like(ii)
    for A_b, s_b, win in zip(scale.A, scale.starts, scale.window_hw):
        T, R, K = A_b.shape[1:]
        assert trig.window_bwd_serial(B, K, R, 2, 2, C) is (B == 1 or force_serial)
        g = torch.from_numpy(rng.normal(size=(2, B, T * 16, C))).to(torch.bfloat16)
        _, k_ref = trig.window_tiles_bwd(ii, A_b, s_b, Kr, g, win, 16, dII=d_ref)
        _, k_ord = _ordered_bwd(ii, A_b, s_b, Kr, g, win, 16, d_ord)
        assert torch.equal(k_ref, k_ord)
        assert torch.equal(d_ref, d_ord)
    assert d_ref.abs().max() > 0


@pytest.mark.parametrize("cached", [False, True], ids=["built", "cached"])
def test_rig_carries_the_index(tmp_path, cached):
    """`build_rig` gives every bucket its dII order index on the rig's
    device, `window_dii_index` on a window rig and `flat_dii_index` on a
    flat one, a rig loaded from the cache too."""
    tc = tiny_config(get_config("MultiviewC"))
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    build = lambda layout: trig.build_rig(
        make_calibrations(tc, 2), tc, grid, [(12, 20), (6, 10)], tile_v=16,
        dtype=torch.bfloat16, band_buckets=3, layout=layout, device="cpu",
        cache_dir=str(tmp_path))
    for layout in ("window", "flat"):
        rig = build(layout)
        if cached:
            rig = build(layout)   # from the file the first build wrote
        for sr in rig.scales:
            assert len(sr.dii_order) == len(sr.A) > 0
            for b, got in enumerate(sr.dii_order):
                if layout == "window":
                    want = trig.window_dii_index(sr.starts[b], sr.window_hw[b],
                                                 *_image(sr))
                else:
                    want = trig.flat_dii_index(sr.starts[b], sr.A[b].shape[-1],
                                               _flat_pixels(sr))
                assert all(g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
                           for g, w in zip(got, want))
    if cached:
        assert len(list(tmp_path.iterdir())) == 2


# ---- the flat layout ----


@pytest.fixture(scope="module", params=["ragged", "band8"])
def flat_scale(request):
    """A tiny bf16 flat rig of 3 buckets: "ragged" has bands 88, 112, 136
    (two of them 8 mod 16) and many band starts; "band8" has an 8-pixel
    bucket beside bands 232 and 240."""
    factor, tile_v = {"ragged": (4, 16), "band8": (8, 8)}[request.param]
    tc = tiny_config(get_config("MultiviewC"), factor=factor)
    grid = make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    rig = trig.build_rig(make_calibrations(tc, 2), tc, grid, [(12, 20)],
                         tile_v=tile_v, dtype=torch.bfloat16, band_buckets=3,
                         layout="flat", device="cpu")
    sr = rig.scales[0]
    bands = [a.shape[-1] for a in sr.A]
    assert len(bands) == 3
    assert (any(b % 16 == 8 for b in bands) and len(set(
        int(x) for s_b in sr.starts for x in s_b.flatten())) > 8
        if request.param == "ragged" else 8 in bands)
    return sr


def _flat_pixels(sr) -> int:
    """Rows of the padded flat features: fh*fw + the largest band."""
    return sr.feat_hw[0] * sr.feat_hw[1] + max(a.shape[-1] for a in sr.A)


def _ordered_flat_bwd(ii, A_b, starts_b, Kr, g_b, tile_v, dII):
    """`flat_tiles_bwd` (bf16) with its dII adds made one at a time in the
    order of `flat_dii_index`: the same values and rounding points (one
    rounding per band add), so the same bits when the two orders agree."""
    N, B, rows, C = ii.shape
    T, R, band = A_b.shape[1:]
    pix = trig._band_pixels(starts_b, N, T, rows, band)
    dKr, dband = trig._window_dband(ii, A_b, pix, Kr, g_b, tile_v, False)
    entries = _entries(trig.flat_dii_index(starts_b, band, rows), rows, 1)
    img = dII.permute(0, 2, 1, 3).reshape(N, rows, B * C).clone()
    for n, y, x, t, k, _ in entries.tolist():
        assert y == 0
        img[n, x] = (img[n, x].float() + dband[n, t, 0, k]).to(torch.bfloat16)
    dII.copy_(img.reshape(N, rows, B, C).permute(0, 2, 1, 3))
    return dII, dKr


def test_flat_every_add_listed_once(flat_scale):
    """Expanding each flat bucket's index gives every (camera, pixel =
    start + position, tile, band position) of its bands exactly once, and
    nothing else; every pixel lies inside the padded features."""
    sr, pixels = flat_scale, _flat_pixels(flat_scale)
    for A_b, s_b in zip(sr.A, sr.starts):
        band = A_b.shape[-1]
        index = trig.flat_dii_index(s_b, band, pixels)
        got = _entries(index, pixels, 1)[:, :5]
        st = s_b.numpy()
        want = [(n, 0, st[n, t] + k, t, k) for n in range(st.shape[0])
                for t in range(st.shape[1]) for k in range(band)]
        assert len(got) == len(want)
        assert sorted(map(tuple, got.tolist())) == sorted(want)
        idx, ptr, adds = index
        assert (np.diff(ptr) > 0).all() and ptr[-1] == len(adds)
        assert len(np.unique(idx, axis=0)) == len(idx)
        assert idx[:, 1].min() >= 0 and idx[:, 1].max() < pixels


def test_flat_adds_run_bucket_then_tile(flat_scale):
    """For each pixel, the flat adds of the whole scale, bucket by bucket in
    launch order, come in (bucket, tile) order, one a (bucket, tile): JAX's
    sequential grid (camera, tile, scene) with buckets launched in order."""
    sr, pixels = flat_scale, _flat_pixels(flat_scale)
    seq = {}
    for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
        e = _entries(trig.flat_dii_index(s_b, A_b.shape[-1], pixels), pixels, 1)
        for n, _, x, t, k, _ in e.tolist():
            seq.setdefault((n, x), []).append((bi, t))
    assert max(len(v) for v in seq.values()) > 1
    for adds in seq.values():
        assert adds == sorted(adds) and len(set(adds)) == len(adds)


@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2"])
def test_flat_ordered_plain_backward_equals_tiles_bwd(flat_scale, B):
    """The plain bf16 flat backward with its dII adds made one at a time in
    the index's order equals `flat_tiles_bwd` (the tile-order plain version,
    JAX's bit for bit: tests/test_torch_bf16_train.py) bit for bit over
    every bucket of the scale, dII carried across buckets."""
    sr = flat_scale
    rng = np.random.default_rng(20 + B)
    C = 16
    feats = rng.uniform(0, 1, size=(B, 2, *sr.feat_hw, C))
    ii = trig.pad_features_flat(torch.from_numpy(feats).float(), sr).to(
        torch.bfloat16)
    assert ii.shape[2] == _flat_pixels(sr)
    Kr = torch.from_numpy(rng.normal(size=(sr.nl, C, C)) * 0.2).to(torch.bfloat16)
    d_ref = torch.zeros_like(ii)
    d_ord = torch.zeros_like(ii)
    for A_b, s_b in zip(sr.A, sr.starts):
        T = A_b.shape[1]
        g = torch.from_numpy(rng.normal(size=(2, B, T * sr.tile_v, C))).to(
            torch.bfloat16)
        _, k_ref = trig.flat_tiles_bwd(ii, A_b, s_b, Kr, g, sr.tile_v, dII=d_ref)
        _, k_ord = _ordered_flat_bwd(ii, A_b, s_b, Kr, g, sr.tile_v, d_ord)
        assert torch.equal(k_ref, k_ord)
        assert torch.equal(d_ref, d_ord)
    assert d_ref.abs().max() > 0
