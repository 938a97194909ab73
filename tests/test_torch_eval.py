"""The port's eval stack against the JAX package's: the torch rotated IoU
within atol 1e-5 of `vfa_tpu/eval/iou.py`; the AP / AOS matching rows
(`frame_matches`, `all_matches`) equal to JAX's; the MODA and AP / AOS
goldens of tests/fixtures/ at the precision tests/test_metrics.py pins;
and `evaluate_rcll_prec_moda_modp` / `evaluate_ap_aos` on both backends."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_metrics import (
    GOLDEN_ALLRES, GOLDEN_ALLRES_MATLAB, GOLDEN_DEMO, GOLDEN_DEMO_MATLAB,
)
from vfa_tpu.eval import apaos as japaos
from vfa_tpu.eval import iou as jiou
from vfa_tpu.eval import moda as jmoda

from vfa_tpu_torch.eval import apaos, iou, moda
from vfa_tpu_torch.eval.evaluate import (
    evaluate_ap_aos, evaluate_rcll_prec_moda_modp,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:3] = rng.uniform(0, 300, (n, 3))
    b[:, 3:6] = rng.uniform(20, 200, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:10] = a[:10]                                   # identical boxes
    b[10:20] = a[10:20] + rng.normal(0, 15, (10, 7)).astype(np.float32)
    b[10:20, 3:6] = np.abs(b[10:20, 3:6]) + 5
    got = iou.iou_3d_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou.iou_3d_pairwise(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (np.diag(got[:10, :10]) > 1 - 1e-5).all()


def _cows(rng, n):
    """Boxes at MultiviewC's world scale: centers to 3900, cow sizes."""
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(390, 3510, (n, 2))
    b[:, 3:6] = rng.uniform([220, 100, 120], [290, 140, 170], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_iou_at_multiviewc_scale_f6():
    """F6: from the origin, fp32 corners at coordinates near 3900 push
    corners of identical boxes past the 1e-6 inside-tolerance, and JAX's
    IoU scores such pairs 1/3; the port measures both boxes from their
    midpoint and holds fp64's IoU within 1e-5 (1 for identical boxes)."""
    rng = np.random.default_rng(8)
    a = _cows(rng, 60)
    b = a.copy()
    b[30:, 0:2] += rng.normal(0, 40, (30, 2)).astype(np.float32)
    b[30:, 6] += rng.normal(0, 0.3, 30).astype(np.float32)
    got = iou.iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    f64 = iou.iou_3d(torch.from_numpy(a).double(), torch.from_numpy(b).double()).numpy()
    np.testing.assert_allclose(got, f64, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:30], 1.0, atol=1e-5)
    want = np.asarray(jiou.iou_3d(jnp.asarray(a), jnp.asarray(b)))
    assert want[:30].min() < 0.5          # the fault in the reference formula


def test_matches_equal_jax():
    rng = np.random.default_rng(5)
    dets, gts = [], []
    for _ in range(30):
        g = _boxes(rng, int(rng.integers(0, 5))).astype(np.float64)
        p = np.zeros((int(rng.integers(0, 6)), 8))
        if len(g) and len(p):
            p[:, :7] = g[rng.integers(0, len(g), len(p))] + rng.normal(0, 10, (len(p), 7))
            p[:, 3:6] = np.abs(p[:, 3:6]) + 5
        p[:, 7] = rng.choice([0.3, 0.6, 0.9], len(p))
        dets.append(p)
        gts.append(g)
    got = apaos.all_matches(dets, gts, (0.75, 0.5, 0.25))
    want = japaos.all_matches(dets, gts, (0.75, 0.5, 0.25))
    for t in want:
        np.testing.assert_array_equal(got[t][:, :2], want[t][:, :2])
        np.testing.assert_allclose(got[t][:, 2], want[t][:, 2], atol=1e-6)
        assert apaos.ap_aos_sweep(got[t], 40) == japaos.ap_aos_sweep(want[t], 40)
    # frames of one shape: JAX's per-frame path compiles once
    same = [i for i in range(30) if dets[i].shape == (3, 8) and gts[i].shape == (2, 7)]
    assert same
    for p, g in ((dets[i], gts[i]) for i in same):
        np.testing.assert_array_equal(apaos.frame_matches(p, g, 0.5),
                                      japaos.frame_matches(p, g, 0.5))


def test_golden_fixtures():
    """The goldens of tests/test_metrics.py, held as it holds JAX's."""
    import json

    for files, golden in ((("test-demo.txt", "gt-demo.txt"), GOLDEN_DEMO),
                          (("all_res.txt", "all_test_gt.txt"), GOLDEN_ALLRES)):
        paths = [str(FIXTURES / f) for f in files]
        np.testing.assert_allclose(moda.evaluate_detection(*paths, td=30.0),
                                   golden, rtol=1e-9)
        np.testing.assert_allclose(evaluate_rcll_prec_moda_modp(*paths),
                                   golden, rtol=1e-9)
    for files, golden in ((("test-demo.txt", "gt-demo.txt"), GOLDEN_DEMO_MATLAB),
                          (("all_res.txt", "all_test_gt.txt"), GOLDEN_ALLRES_MATLAB)):
        got = moda.evaluate_detection_matlab(*[str(FIXTURES / f) for f in files])
        for k, v in golden.items():
            assert got[k] == pytest.approx(v, rel=1e-12), k
        r = evaluate_rcll_prec_moda_modp(*[str(FIXTURES / f) for f in files],
                                         eval="matlab")
        assert r == (got["recall"], got["precision"], got["moda"], got["modp"])
    with open(FIXTURES / "apaos_golden.json") as f:
        golden = json.load(f)
    got = evaluate_ap_aos(str(FIXTURES / "apaos_pred.txt"), str(FIXTURES / "apaos_gt.txt"))
    names = ["AP_75", "AOS_75", "OS_75", "AP_50", "AOS_50", "OS_50",
             "AP_25", "AOS_25", "OS_25"]
    np.testing.assert_allclose(got, [golden[n] for n in names], rtol=2e-5)
    assert got == japaos.evaluate_ap_aos(str(FIXTURES / "apaos_pred.txt"),
                                         str(FIXTURES / "apaos_gt.txt"))


def test_clear_metrics_match_jax():
    rng = np.random.default_rng(2)
    gt = np.concatenate([np.c_[np.full(6, f), np.arange(6), rng.uniform(0, 200, (6, 2))]
                         for f in range(5)])
    det = gt[rng.permutation(len(gt))[:22]].copy()
    det[:, 2:] += rng.normal(0, 12, (22, 2))
    for td in (30.0, 78.0):
        assert moda.clear_mod_metrics(gt, det, td) == jmoda.clear_mod_metrics(gt, det, td)
        assert moda.clear_mod_matlab(gt, det, td) == jmoda.clear_mod_matlab(gt, det, td)


def test_gt_as_its_own_prediction_scores_100(tmp_path):
    """What chip_smoke.py holds on the card: the GT as the prediction gives
    MODA 100 and AP_50 100."""
    rng = np.random.default_rng(4)
    gt = np.concatenate([np.c_[np.full(6, f), _cows(rng, 6).astype(np.float64)]
                         for f in range(3)])
    pred = np.c_[gt, np.full(len(gt), 0.9)]
    for name, rows in (("gt", gt), ("pred", pred), ("pr_gt", gt[:, :3]),
                       ("pr_pred", pred[:, :3])):
        np.savetxt(tmp_path / f"{name}.txt", rows)
    _, _, m, _ = evaluate_rcll_prec_moda_modp(str(tmp_path / "pr_pred.txt"),
                                              str(tmp_path / "pr_gt.txt"))
    r = evaluate_ap_aos(str(tmp_path / "pred.txt"), str(tmp_path / "gt.txt"))
    assert m == 100.0 and r[3] == pytest.approx(100.0)
