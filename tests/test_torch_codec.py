"""The port's batched decode against `vfa_tpu.codec.decode_frame`.

Compared on valid entries only: the top-k order among NMS-zeroed ties
(vfa_tpu/codec.py:213) differs between frameworks, and those entries sit
under the threshold. Tolerance: rtol 1e-5 / atol 1e-3 on world-coordinate
locations (values up to ~4e3 cm, fp32) and rtol 1e-5 on the rest."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vfa_tpu.codec import decode_frame as jax_decode, nms_heatmap as jax_nms
from vfa_tpu.config import mc_opts, mx_opts, wt_opts

from vfa_tpu_torch.codec import ObjectEncoder, decode_frame, nms_heatmap
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import tiny_config

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

DIM_MEAN = np.array([145.0, 120.0, 255.0], np.float32)


def _pred(rng, B, L, W, mode):
    pred = {
        "heatmap": rng.normal(size=(B, 1, L, W)).astype(np.float32) * 2,
        "loc_offset": rng.normal(size=(B, L, W, 2)).astype(np.float32),
    }
    if mode == "3D":
        pred["dim_offset"] = 0.1 * rng.normal(size=(B, L, W, 3)).astype(np.float32)
        pred["rotation"] = rng.normal(size=(B, L, W, 360)).astype(np.float32)
    return pred


def test_nms_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 1, 17, 23)).astype(np.float32)
    np.testing.assert_array_equal(nms_heatmap(torch.from_numpy(h)).numpy(),
                                  np.asarray(jax_nms(jnp.asarray(h))))


@pytest.mark.parametrize("cfg", [mc_opts, mx_opts, wt_opts], ids=lambda c: c.name)
def test_decode_matches_jax_on_valid_entries(cfg):
    rng = np.random.default_rng(5)
    tcfg = tiny_config(get_config(cfg.name))
    L, W = tcfg.grid_shape
    B, thresh = 3, 0.8
    pred = _pred(rng, B, L, W, cfg.mode)
    kw = {"dim_mean": DIM_MEAN} if cfg.mode == "3D" else {}
    got = decode_frame({k: torch.from_numpy(v) for k, v in pred.items()},
                       tcfg, thresh, **kw)
    n_valid = 0
    for s in range(B):
        want = jax_decode({k: jnp.asarray(v[s:s + 1]) for k, v in pred.items()},
                          tcfg, thresh, **kw)
        wv = np.asarray(want["valid"])
        gv = got["valid"][s].numpy()
        assert gv.sum() == wv.sum()
        n_valid += int(wv.sum())
        for key in want:
            if key == "valid":
                continue
            w = np.asarray(want[key])[wv]
            g = got[key][s].numpy()[gv]
            atol = 1e-3 if key == "location" else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=key)
    assert n_valid > 0


def test_batch_decode_objects():
    rng = np.random.default_rng(9)
    tcfg = tiny_config(get_config("MultiviewC"))
    L, W = tcfg.grid_shape
    pred = {k: torch.from_numpy(v) for k, v in _pred(rng, 2, L, W, "3D").items()}
    enc = ObjectEncoder(tcfg, dim_mean=DIM_MEAN)
    scenes = enc.batch_decode(pred, 0.8)
    d = enc.decode(pred, 0.8)
    assert len(scenes) == 2
    for s, objs in enumerate(scenes):
        assert len(objs) == int(d["valid"][s].sum())
        assert all(o.classname == "Cow" and o.conf > 0.8 for o in objs)
