"""Evaluation dispatch (port of `vfa_tpu/eval/evaluate.py`; reference:
`vfa/evaluation/evaluate.py:7-27`).

The reference dispatches between an out-of-process MATLAB engine and a Python
port of it; both are reimplemented here in pure numpy/scipy (plus the native
JV matcher), so `eval_tool` selects *semantics*, not a runtime:

  * 'python' — the pyeval port's behavior (td=30, zero-clamped metrics),
    golden-pinned against the reference pyeval on its fixtures.
  * 'matlab' — the official devkit's behavior (td=78, dist==td matchable,
    unclamped MODA, det-file frame loop), the backend paper-grade numbers
    come from. Golden-pinned in tests/test_metrics.py.

Measured gap between the two on the reference's own demo fixtures
(gt-demo/test-demo == gt.txt/test.txt): MODA 89.496 (pyeval) vs 90.126
(MATLAB), MODP 83.279 vs 93.266 — i.e. the pyeval README's "0-2% MODA
deviation" is real and almost entirely the td difference (30 vs 78).

`td=None` picks each backend's own default; pass a value to override.
"""

from __future__ import annotations

from typing import Optional

from vfa_tpu_torch.eval.apaos import evaluate_ap_aos  # noqa: F401
from vfa_tpu_torch.eval.moda import (
    DEFAULT_TD,
    MATLAB_TD,
    evaluate_detection,
    evaluate_detection_matlab,
)


def evaluate_rcll_prec_moda_modp(
    res_fpath: str,
    gt_fpath: str,
    dataset: str = "Wildtrack",
    eval: str = "python",
    td: Optional[float] = None,
):
    """Returns (recall, precision, MODA, MODP) in percent."""
    del dataset  # kept for reference CLI compatibility
    if eval == "matlab":
        m = evaluate_detection_matlab(
            res_fpath, gt_fpath, td=MATLAB_TD if td is None else td)
        return m["recall"], m["precision"], m["moda"], m["modp"]
    return evaluate_detection(
        res_fpath, gt_fpath, td=DEFAULT_TD if td is None else td)
