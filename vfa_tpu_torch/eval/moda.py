"""CLEAR detection metrics: recall / precision / MODA / MODP (port of
`vfa_tpu/eval/moda.py`).

Replaces both metric backends of the reference — the MATLAB devkit
(`motchallenge-devkit/utils/CLEAR_MOD_HUN.m`, driven out-of-process via
matlab.engine at `vfa/evaluation/evaluate.py:9-16`) and its Python port
(`vfa/evaluation/pyeval/CLEAR_MOD_HUN.py`) — with one vectorized numpy/scipy
implementation. All frames at once: one padded (F, Gmax, Dmax) distance
tensor (costs above the distance threshold set to 1e6) and a single batched
assignment call, matches kept only below the threshold.

The two reference backends disagree on the threshold default (MATLAB td=78,
`CLEAR_MOD_HUN.m:36`; pyeval td=30, `CLEAR_MOD_HUN.py:27`); `td` is an
explicit parameter here, defaulting to the pyeval value.

The matching itself can run through the native C++ Jonker-Volgenant solver
(vfa_tpu_torch/native, built from the repo's native/matching.cpp — the
equivalent of the devkit's MinCostMatching mex) or, where that library
cannot be built, scipy, with the same answers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_TD = 30.0


def _clear_frame_stats(gt: np.ndarray, det: np.ndarray, td: float, F: int,
                       eq_matchable: bool):
    """Batched per-frame matching core shared by both metric variants.

    Pads every frame's gt/det points to the cross-frame maxima, builds ALL
    distance matrices in one (F_active, Gmax, Dmax) tensor, and solves every
    frame's assignment in a single native `solve_lsap_batch` call (scipy
    loop fallback) — replacing the per-frame Python loop the reference
    backends use (`CLEAR_MOD_HUN.py:40-90`, `CLEAR_MOD_HUN.m:53-230`).

    Rows with frame >= F are ignored entirely (both reference backends
    iterate `for t in range(F)` with F from one file's frames only).
    `eq_matchable`: MATLAB semantics — pairs at exactly dist == td are
    matchable (but still contribute 0 to MODP via the strict `< td`).

    Returns (n_c, n_g, n_fp, n_m, modp_sum) totals.
    """
    gtf = gt[:, 0].astype(np.int64) if len(gt) else np.zeros(0, np.int64)
    detf = det[:, 0].astype(np.int64) if len(det) else np.zeros(0, np.int64)
    gt_xy = (gt[:, 2:4] if len(gt) else np.zeros((0, 2)))[gtf < F]
    det_xy = (det[:, 2:4] if len(det) else np.zeros((0, 2)))[detf < F]
    gtf, detf = gtf[gtf < F], detf[detf < F]

    gcnt = np.bincount(gtf, minlength=F)
    dcnt = np.bincount(detf, minlength=F)
    act = np.nonzero((gcnt > 0) & (dcnt > 0))[0]
    c = np.zeros(F)
    modp_sum = 0.0
    if len(act):
        Gm, Dm = int(gcnt[act].max()), int(dcnt[act].max())
        # scatter points into (F, max, 2) padded slabs: position within a
        # frame = running index minus the frame's start offset (stable sort
        # keeps the file's row order within each frame)
        frame_slot = {}
        for which, (f_ids, xy, mx) in enumerate(
                ((gtf, gt_xy, Gm), (detf, det_xy, Dm))):
            order = np.argsort(f_ids, kind="stable")
            f_s, xy_s = f_ids[order], xy[order]
            cnt = gcnt if which == 0 else dcnt
            start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            pos = np.arange(len(f_s)) - start[f_s]
            pad = np.zeros((F, mx, 2))
            pad[f_s, pos] = xy_s
            frame_slot[which] = pad
        gp, dp = frame_slot[0][act], frame_slot[1][act]  # (Fa,Gm,2),(Fa,Dm,2)

        dist = np.linalg.norm(gp[:, :, None, :] - dp[:, None, :, :], axis=-1)
        cost = np.where(dist > td, 1e6, dist)

        from vfa_tpu_torch.native import batch_linear_sum_assignment

        col = batch_linear_sum_assignment(cost, gcnt[act], dcnt[act])
        assigned = col >= 0                              # (Fa, Gm)
        d = np.take_along_axis(dist, np.maximum(col, 0)[:, :, None],
                               axis=2)[:, :, 0]
        keep = assigned & ((d <= td) if eq_matchable else (d < td))
        c[act] = keep.sum(axis=1)
        modp_sum = float(np.sum((1.0 - d / td) * (keep & (d < td))))

    fp = dcnt - c
    miss = gcnt - c
    return c.sum(), float(gcnt.sum()), fp.sum(), miss.sum(), modp_sum


def clear_mod_metrics(gt: np.ndarray, det: np.ndarray, td: float = DEFAULT_TD):
    """CLEAR MOD metrics over reindexed matrices.

    gt, det: (n, 4) rows [frame, obj_id, x, y] with frames 0..F-1 (the format
    produced by `load_detection_files`). Returns (recall, precision, MODA,
    MODP) in percent, with the reference's clamp-at-zero behavior
    (`CLEAR_MOD_HUN.py:94-99`).
    """
    F = int(gt[:, 0].max()) + 1 if len(gt) else 0
    n_c, n_g, n_fp, n_m, modp_sum = _clear_frame_stats(
        gt, det if len(det) else np.zeros((0, 4)), td, F, eq_matchable=False)
    modp = modp_sum / n_c * 100 if n_c > 0 else 0.0
    moda = (1.0 - (n_m + n_fp) / n_g) * 100 if n_g > 0 else 0.0
    recall = n_c / n_g * 100 if n_g > 0 else 0.0
    precision = n_c / (n_fp + n_c) * 100 if (n_fp + n_c) > 0 else 0.0
    # reference clamps each metric at zero (`CLEAR_MOD_HUN.py:94-99`)
    return max(recall, 0.0), max(precision, 0.0), max(moda, 0.0), max(modp, 0.0)


MATLAB_TD = 78.0


def clear_mod_matlab(gt: np.ndarray, det: np.ndarray, td: float = MATLAB_TD):
    """Exact semantics of the official MATLAB devkit detection path
    (`motchallenge-devkit/utils/CLEAR_MOD_HUN.m`, driven by
    `evaluateDetection.m` / `eval_demo.m`) — the backend the paper-grade
    numbers come from.

    Differences vs the pyeval port (`clear_mod_metrics`):
      * td defaults to 78 (`CLEAR_MOD_HUN.m:33-39`), not 30;
      * pairs at exactly dist == td are matchable (MATLAB forbids only
        dist > td, `CLEAR_MOD_HUN.m:189`) though they contribute 0 to MODP
        (`distances<td` is strict, `:258`);
      * the frame loop runs over the detection file's frames
        (`evaluateDetection.m:38`, `CLEAR_MOD_HUN.m:53` F=max det frame),
        so trailing det-only frames still count their false positives;
      * no clamp-at-zero — MODA can go negative; MATLAB only maps NaN->0
        (`CLEAR_MOD_HUN.m:270`);
      * the full 9-metric row [Rcll Prcn FAR GT TP FP FN MODA MODP].

    MATLAB's `Hungarian.m` computes a maximum-cardinality minimum-cost
    matching over the allowed (dist <= td) pairs: its padding construction
    (deficiency `cnum` extra rows/cols, `Hungarian.m:48-55`) forces maximum
    cardinality, and Inf edges are never taken. A uniform big-M substitute
    with post-filtering is equivalent: minimizing total cost first minimizes
    the number of big-M (forbidden) assignments — i.e. maximizes allowed
    cardinality — and then minimizes the allowed-pair cost. The metric values
    depend only on the matching's cardinality and total matched distance,
    both of which are unique across optimal matchings.

    Returns a dict with keys recall/precision/far/gt/tp/fp/fn/moda/modp.
    """
    F = int(det[:, 0].max()) + 1 if len(det) else 0
    Fgt = int(gt[:, 0].max()) + 1 if len(gt) else 0
    n_c, n_g, n_fp, n_m, modp_sum = _clear_frame_stats(
        gt if len(gt) else np.zeros((0, 4)), det, td, F, eq_matchable=True)
    out = {
        "recall": n_c / n_g * 100 if n_g > 0 else 0.0,
        "precision": n_c / (n_fp + n_c) * 100 if (n_fp + n_c) > 0 else 0.0,
        "far": n_fp / Fgt if Fgt > 0 else 0.0,
        "gt": n_g,
        "tp": n_c,
        "fp": n_fp,
        "fn": n_m,
        "moda": (1.0 - (n_m + n_fp) / n_g) * 100 if n_g > 0 else 0.0,
        "modp": modp_sum / n_c * 100 if n_c > 0 else 0.0,
    }
    return out


def evaluate_detection_matlab(res_fpath: str, gt_fpath: str,
                              td: float = MATLAB_TD):
    """File-level MATLAB-devkit-semantics entry point (td=78 default)."""
    gt, det = load_detection_files(res_fpath, gt_fpath)
    if len(det) == 0:
        return {k: 0.0 for k in
                ("recall", "precision", "far", "gt", "tp", "fp", "fn",
                 "moda", "modp")}
    return clear_mod_matlab(gt, det, td)


def load_detection_files(res_fpath: str, gt_fpath: str):
    """Load `frame x y` txt files and reindex frames to 0..F-1.

    Follows `pyeval/evaluateDetection.py:28-70`: the frame list comes from the
    *detection* file; gt rows in frames with no detections are dropped
    (reference quirk, kept for parity).
    """
    gt_raw = np.atleast_2d(np.loadtxt(gt_fpath))
    det_raw = np.atleast_2d(np.loadtxt(res_fpath))
    if det_raw.size == 0:
        return np.zeros((0, 4)), np.zeros((0, 4))
    frames = np.unique(det_raw[:, 0])
    gt_rows, det_rows = [], []
    for fc, t in enumerate(frames):
        for raw, out in ((gt_raw, gt_rows), (det_raw, det_rows)):
            sel = raw[raw[:, 0] == t]
            a = np.zeros((len(sel), 4))
            a[:, 0] = fc
            a[:, 1] = np.arange(len(sel))
            a[:, 2:4] = sel[:, 1:3]
            out.append(a)
    return np.concatenate(gt_rows), np.concatenate(det_rows)


def evaluate_detection(
    res_fpath: str, gt_fpath: str, td: float = DEFAULT_TD
) -> Tuple[float, float, float, float]:
    """File-level entry point: (recall, precision, MODA, MODP)."""
    gt, det = load_detection_files(res_fpath, gt_fpath)
    if len(det) == 0:
        return 0.0, 0.0, 0.0, 0.0
    return clear_mod_metrics(gt, det, td)
