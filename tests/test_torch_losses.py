"""The port's losses against `vfa_tpu/losses.py` on the same numpy inputs
(rtol 1e-5 / atol 1e-6: fp32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vfa_tpu import losses as jl

from vfa_tpu_torch import losses as tl

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
B, L, W, A = 2, 9, 11, 36


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def _targets(rng, empty=False):
    mask = np.zeros((B, 1, L, W), np.float32)
    heat = rng.uniform(0, 0.9, size=(B, 1, L, W)).astype(np.float32)
    rot = np.zeros((B, L, W, A), np.float32)
    if not empty:
        for b in range(B):
            for _ in range(3):
                r, c = rng.integers(0, L), rng.integers(0, W)
                mask[b, 0, r, c] = 1.0
                heat[b, 0, r, c] = 1.0
                rot[b, r, c] = rng.uniform(0, 0.9, size=A)
                rot[b, r, c, rng.integers(0, A)] = 1.0
    return {
        "mask": mask, "heatmap": heat, "rotation": rot,
        "loc_offset": rng.uniform(0, 1, size=(B, L, W, 2)).astype(np.float32) * mask.transpose(0, 2, 3, 1),
        "dim_offset": rng.normal(size=(B, L, W, 3)).astype(np.float32) * mask.transpose(0, 2, 3, 1),
    }


def _preds(rng):
    return {
        "heatmap": rng.normal(size=(B, 1, L, W)).astype(np.float32) * 3,
        "loc_offset": rng.normal(size=(B, L, W, 2)).astype(np.float32),
        "dim_offset": rng.normal(size=(B, L, W, 3)).astype(np.float32) * 2,
        "rotation": rng.normal(size=(B, L, W, A)).astype(np.float32) * 3,
    }


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_smooth_l1_and_focal_match_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4, 50)).astype(np.float32) * 2
    t = rng.normal(size=(4, 50)).astype(np.float32)
    _close(tl.smooth_l1(torch.from_numpy(p), torch.from_numpy(t)),
           jl.smooth_l1(jnp.asarray(p), jnp.asarray(t)))
    gt = _targets(rng)["heatmap"]
    _close(tl.focal_loss(torch.from_numpy(p.reshape(-1)[:B * L * W].reshape(gt.shape)),
                         torch.from_numpy(gt)),
           jl.focal_loss(jnp.asarray(p.reshape(-1)[:B * L * W].reshape(gt.shape)),
                         jnp.asarray(gt)))


@pytest.mark.parametrize("empty", [False, True], ids=["objects", "empty"])
def test_csl_angle_focal_loss_matches_jax(empty):
    rng = np.random.default_rng(1)
    gt, pred = _targets(rng, empty), _preds(rng)
    got = tl.csl_angle_focal_loss(torch.from_numpy(pred["rotation"]),
                                  torch.from_numpy(gt["rotation"]),
                                  torch.from_numpy(gt["mask"]))
    want = jl.csl_angle_focal_loss(jnp.asarray(pred["rotation"]),
                                   jnp.asarray(gt["rotation"]),
                                   jnp.asarray(gt["mask"]))
    _close(got, want)
    if empty:
        assert float(got) == 0.0


def test_csl_cells_matches_jax_and_dense():
    """Sparse rotation loss == JAX's sparse == the dense form."""
    rng = np.random.default_rng(2)
    M = 5
    rows = rng.integers(0, L, size=(B, M))
    cols = rng.integers(0, W, size=(B, M))
    cols[:, 1] = cols[:, 0]
    rows[:, 1] = rows[:, 0] + (rows[:, 0] < L - 1)      # distinct cells
    owner = np.ones((B, M), bool)
    owner[0, 3] = False
    keys = rows * W + cols
    for b in range(B):                                   # keep cells unique
        _, first = np.unique(keys[b], return_index=True)
        dup = np.ones(M, bool)
        dup[first] = False
        owner[b, dup] = False
    pred = rng.normal(size=(B, L, W, A)).astype(np.float32) * 3
    gt_cells = rng.uniform(0, 0.9, size=(B, M, A)).astype(np.float32)
    gt_cells[..., 7] = 1.0
    dense_gt = np.zeros((B, L, W, A), np.float32)
    mask = np.zeros((B, 1, L, W), np.float32)
    for b in range(B):
        for m in range(M):
            if owner[b, m]:
                dense_gt[b, rows[b, m], cols[b, m]] = gt_cells[b, m]
                mask[b, 0, rows[b, m], cols[b, m]] = 1.0
    pred_cells = pred[np.arange(B)[:, None], rows, cols]
    got = tl.csl_angle_focal_loss_cells(torch.from_numpy(pred_cells),
                                        torch.from_numpy(gt_cells),
                                        torch.from_numpy(owner))
    _close(got, jl.csl_angle_focal_loss_cells(jnp.asarray(pred_cells),
                                              jnp.asarray(gt_cells),
                                              jnp.asarray(owner)))
    _close(got, tl.csl_angle_focal_loss(torch.from_numpy(pred),
                                        torch.from_numpy(dense_gt),
                                        torch.from_numpy(mask)))


@pytest.mark.parametrize("empty", [False, True], ids=["objects", "empty"])
def test_compute_loss3d_and_2d_match_jax(empty):
    rng = np.random.default_rng(3)
    gt, pred = _targets(rng, empty), _preds(rng)
    w3, w2 = (1.0, 2.0, 0.5, 1.5), (5.0, 1.0)
    tot, d = tl.compute_loss3d(_t(pred), _t(gt), w3)
    jtot, jd = jl.compute_loss3d(_j(pred), _j(gt), w3)
    _close(tot, jtot)
    assert set(d) == set(jd)
    for k in jd:
        _close(d[k], jd[k])
    assert np.isfinite(float(tot))
    tot2, d2 = tl.compute_loss2d(_t(pred), _t(gt), w2)
    jtot2, jd2 = jl.compute_loss2d(_j(pred), _j(gt), w2)
    _close(tot2, jtot2)
    assert set(d2) == set(jd2)
    for k in jd2:
        _close(d2[k], jd2[k])


def test_loss_gradient_is_finite_on_an_empty_frame():
    rng = np.random.default_rng(4)
    gt, pred = _t(_targets(rng, empty=True)), _t(_preds(rng))
    for v in pred.values():
        v.requires_grad_()
    tot, _ = tl.compute_loss3d(pred, gt)
    tot.backward()
    assert all(torch.isfinite(v.grad).all() for v in pred.values())
