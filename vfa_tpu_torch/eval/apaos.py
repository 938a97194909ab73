"""3D detection AP / AOS / OS at IoU thresholds 0.75 / 0.5 / 0.25 (port of
`vfa_tpu/eval/apaos.py`).

Replaces `vfa/evaluation/pyeval/evaluateAPAOS.py`: the reference computes one
CUDA IoU3D round trip per (pred, gt) pair per frame (`:79-83`) and an O(n^2)
AOS prefix rescan (`:36-40`); here each frame's full IoU matrix is one
batched torch call (`iou_3d_pairwise`, on the caller's device) and the
sweep is a cumsum.

Matching semantics are kept bit-for-bit with the reference:
  * each prediction matches its best-IoU gt with IoU >= thresh — matched gts
    are NOT removed (reference behavior: `cal_frame_TPFP_iou` collects
    `passed_index` but never uses it), so several predictions can claim the
    same gt;
  * predictions are sorted by confidence descending over ALL frames, the
    precision / recall / AOS curves are prefix statistics, and AP/AOS are
    11-point interpolations (`:41-63`);
  * orientation similarity uses (1 + cos(pred_rot - gt_rot)) / 2 for TPs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vfa_tpu_torch.eval.iou import iou_3d, iou_3d_pairwise


def frame_matches(preds: np.ndarray, gts: np.ndarray, thresh: float,
                  device="cpu"):
    """Per-frame TP/FP info rows: [conf, tp_flag, delta_ori].

    preds: (P, 8) [x y z l w h rot conf]; gts: (G, 7) [x y z l w h rot].
    Single-frame reference semantics; the file-level sweep goes through the
    batched `all_matches` instead (one IoU tensor for every frame and all
    three thresholds).
    """
    P = len(preds)
    if P == 0:
        return np.zeros((0, 3))
    out = np.zeros((P, 3))
    out[:, 0] = preds[:, 7]
    if len(gts) == 0:
        return out  # all FP, delta 0
    M = iou_3d_pairwise(
        torch.as_tensor(preds[:, :7], dtype=torch.float32, device=device),
        torch.as_tensor(gts[:, :7], dtype=torch.float32, device=device)
    ).cpu().numpy()
    M = np.where(M >= thresh, M, -np.inf)
    best = M.argmax(axis=1)
    matched = M[np.arange(P), best] > -np.inf
    out[:, 1] = matched
    out[:, 2] = np.where(matched, preds[:, 6] - gts[best, 6], 0.0)
    return out


def _pad_to(n: int, multiple: int = 16) -> int:
    """Round up to a multiple of 16 (the JAX package's padded shape; the
    padding is masked, so it changes no result)."""
    return max(multiple, -(-n // multiple) * multiple)


def all_matches(det_frames, gt_frames, threshs, device="cpu"):
    """Batched frame_matches over every frame and threshold at once.

    Pads frames to (F, Pmax, 8)/(F, Gmax, 7), computes the full (F, Pmax,
    Gmax) IoU3D tensor in ONE batched call on `device` (the per-frame path
    recomputes the matrix per threshold — replaces
    `evaluateAPAOS.py:79-83`'s per-pair launches),
    then applies each threshold to the shared tensor in numpy. Returns
    {thresh: info rows} with rows in frame order / file order within a
    frame — the order the stable confidence sort's tie-break depends on.
    """
    F = len(det_frames)
    pmax = _pad_to(max((len(p) for p in det_frames), default=0))
    gmax = _pad_to(max((len(g) for g in gt_frames), default=0))
    # info rows (conf, delta_ori) stay float64 like the file contents —
    # only the IoU itself runs fp32 (as the per-frame path always did)
    preds = np.zeros((F, pmax, 8), np.float64)
    gts = np.zeros((F, gmax, 7), np.float64)
    pmask = np.zeros((F, pmax), bool)
    gmask = np.zeros((F, gmax), bool)
    for i, (p, g) in enumerate(zip(det_frames, gt_frames)):
        preds[i, : len(p)] = p
        pmask[i, : len(p)] = True
        gts[i, : len(g)] = g
        gmask[i, : len(g)] = True

    p = torch.as_tensor(preds[..., :7], dtype=torch.float32, device=device)
    g = torch.as_tensor(gts, dtype=torch.float32, device=device)
    shp = (F, pmax, gmax, 7)
    M = iou_3d(p[:, :, None, :].expand(shp),
               g[:, None, :, :].expand(shp)).cpu().numpy()
    # padded boxes have zero volume (0/0 -> nan); mask every invalid pair
    M = np.where(pmask[:, :, None] & gmask[:, None, :], M, -np.inf)

    conf = preds[..., 7]
    out = {}
    for thresh in threshs:
        Mt = np.where(M >= thresh, M, -np.inf)
        best = Mt.argmax(axis=2)                         # (F, Pmax)
        matched = np.take_along_axis(Mt, best[..., None], 2)[..., 0] > -np.inf
        delta = np.where(
            matched,
            preds[..., 6] - np.take_along_axis(gts[..., 6], best, axis=1),
            0.0)
        rows = np.stack([conf, matched.astype(np.float64), delta], axis=-1)
        out[thresh] = rows[pmask]                        # row-major: frame order
    return out


def ap_aos_sweep(info: np.ndarray, total_gt: int) -> Tuple[float, float]:
    """11-point AP and AOS from [conf, tp, delta_ori] rows."""
    if len(info) == 0 or total_gt == 0:
        return 0.0, 0.0
    # reference sort: argsort ascending then reversed (`evaluateAPAOS.py:21-23`)
    order = np.argsort(info[:, 0], kind="stable")[::-1]
    info = info[order]
    tp = info[:, 1]
    cum_tp = np.cumsum(tp)
    ranks = np.arange(1, len(info) + 1)
    precision = cum_tp / ranks
    recall = cum_tp / total_gt
    aos = np.cumsum(tp * (1.0 + np.cos(info[:, 2])) / 2.0) / ranks

    ap = 0.0
    aos_11 = 0.0
    for r in np.arange(0, 1.1, 0.1):
        sel = recall >= r
        if sel.any():
            k = sel.argmax()
            ap += precision[k:].max()
            aos_11 += aos[k:].max()
    return ap / 11.0, aos_11 / 11.0


def _reindex(raw: np.ndarray, frames: np.ndarray, with_conf: bool):
    """Group rows per frame (reference format: `evaluateAPAOS.py:121-165`)."""
    per_frame = []
    for t in frames:
        sel = raw[raw[:, 0] == t][:, 1:]  # drop frame col
        per_frame.append(sel)
    return per_frame


def evaluate_ap_aos(res_fpath: str, gt_fpath: str, device="cpu"):
    """File-level entry: returns (AP_75, AOS_75, OS_75, AP_50, AOS_50, OS_50,
    AP_25, AOS_25, OS_25) matching `evaluateDetectionAPAOS` (`:107-170`).

    pred rows: frame x y z l w h rot conf; gt rows: frame x y z l w h rot.
    The IoU tensor is computed on `device`.
    """
    gt_raw = np.atleast_2d(np.loadtxt(gt_fpath))
    det_raw = np.atleast_2d(np.loadtxt(res_fpath))
    assert det_raw.size, "detection is empty"
    frames = np.unique(det_raw[:, 0])
    gt_frames = _reindex(gt_raw, frames, with_conf=False)
    det_frames = _reindex(det_raw, frames, with_conf=True)
    total_gt = sum(len(g) for g in gt_frames)

    info_by_thresh = all_matches(det_frames, gt_frames, (0.75, 0.5, 0.25),
                                 device=device)
    results = []
    for thresh in (0.75, 0.5, 0.25):
        ap, aos = ap_aos_sweep(info_by_thresh[thresh], total_gt)
        os_metric = aos / ap if ap > 0 else 0.0
        results += [ap * 100, aos * 100, os_metric]
    # reorder to the reference's return signature
    return (
        results[0], results[1], results[2],
        results[3], results[4], results[5],
        results[6], results[7], results[8],
    )
