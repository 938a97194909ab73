"""Detection losses (port of `vfa_tpu/losses.py`; reference
`vfa/model/loss.py`).

focal_loss: CenterNet-style heatmap focal loss with (1-gt)^4 negative
down-weighting on sigmoid scores. csl_angle_focal_loss: the same focal
applied only at positive cells of the 360-bin CSL targets, and its sparse
`_cells` form over pre-gathered object cells. compute_loss3d /
compute_loss2d: weighted sums with SmoothL1 on sigmoid(loc_offset) and raw
dim_offset, masked by the gt mask and normalized by the number of
positives. All in fp32 with masked sums and `where(n > 0, ...)` guards, so
an empty frame gives 0, not NaN. `count_sum` (a function, default none)
sums every count over the ranks of a data-parallel mesh
(`parallel.sum_nograd`): each rank's loss is then its share of the global
batch's, and their sum the global loss.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.SmoothL1Loss(reduction='none') with beta=1."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _counted(count_sum, n):
    return n if count_sum is None else count_sum(n)


def _focal_sums(pred_logits, gt, pos, neg, alpha, beta, eps, count_sum=None):
    """Per-branch mean focal terms over the boolean pos / neg selections;
    a branch with no element contributes 0."""
    pred = torch.sigmoid(pred_logits).clamp(eps, 1.0 - eps)
    posf = pos.to(pred.dtype)
    negf = neg.to(pred.dtype)
    n_pos = _counted(count_sum, posf.sum())
    n_neg = _counted(count_sum, negf.sum())
    pos_loss = -(((1.0 - pred) ** alpha) * torch.log(pred) * posf).sum()
    neg_loss = -(((1.0 - gt) ** beta) * (pred ** alpha)
                 * torch.log(1.0 - pred) * negf).sum()
    zero = torch.zeros_like(pos_loss)
    pos_loss = torch.where(n_pos > 0, pos_loss / n_pos.clamp(min=1.0), zero)
    neg_loss = torch.where(n_neg > 0, neg_loss / n_neg.clamp(min=1.0), zero)
    return pos_loss + neg_loss


def focal_loss(pred_logits, gt, alpha=2.0, beta=4.0, eps=1e-5, count_sum=None):
    """Heatmap focal loss, mean-reduced as in `loss.py:5-31`: positives are
    cells where gt == 1; each branch is normalized by its own count."""
    pos = gt == 1.0
    return _focal_sums(pred_logits, gt, pos, ~pos, alpha, beta, eps, count_sum)


def csl_angle_focal_loss(pred_logits, gt, foreground, alpha=2.0, beta=4.0,
                         eps=1e-5, count_sum=None):
    """Focal loss on CSL bins at positive BEV cells only (`loss.py:33-42`).
    pred_logits / gt: (B, L, W, A); foreground: (B, 1, L, W)."""
    cell_mask = foreground.movedim(1, -1) == 1.0          # (B, L, W, 1)
    return _focal_sums(pred_logits, gt, (gt == 1.0) & cell_mask,
                       (gt != 1.0) & cell_mask, alpha, beta, eps, count_sum)


def csl_angle_focal_loss_cells(pred_cells, gt_cells, owner, alpha=2.0,
                               beta=4.0, eps=1e-5, count_sum=None):
    """`csl_angle_focal_loss` evaluated at the object cells only: the dense
    form is masked by the foreground map, the scatter of <= M object cells,
    so every other cell contributes exactly 0. pred_cells / gt_cells:
    (..., M, A) logits / CSL targets gathered at the cells; owner: (..., M)
    (`codec.object_cells`). Same value as the dense form."""
    m = owner[..., None]
    return _focal_sums(pred_cells, gt_cells, (gt_cells == 1.0) & m,
                       (gt_cells != 1.0) & m, alpha, beta, eps, count_sum)


def compute_loss3d(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
                   loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                   rotation_cells=None, count_sum=None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """3D-mode loss (`loss.py:45-75`). Returns (total, loss_dict).

    rotation_cells: optional (pred_cells, gt_cells, owner), the rotation
    logits / targets pre-gathered at the object cells; when given, pred and
    gt need no dense 'rotation' entries."""
    hm_w, pos_w, dim_w, ang_w = loss_weight
    mask = gt["mask"].movedim(1, -1)                      # (B, L, W, 1)

    loss_yx = smooth_l1(torch.sigmoid(pred["loc_offset"]), gt["loc_offset"]) * mask
    loss_hwl = smooth_l1(pred["dim_offset"], gt["dim_offset"]) * mask
    loss_heatmap = focal_loss(pred["heatmap"], gt["heatmap"], count_sum=count_sum)
    if rotation_cells is not None:
        loss_angle = csl_angle_focal_loss_cells(*rotation_cells, count_sum=count_sum)
    else:
        loss_angle = csl_angle_focal_loss(pred["rotation"], gt["rotation"],
                                          gt["mask"], count_sum=count_sum)

    n_pos = _counted(count_sum, gt["mask"].sum()).clamp(min=1.0)
    loss_yx = loss_yx.sum() / n_pos
    loss_hwl = loss_hwl.sum() / n_pos

    total = (loss_yx * pos_w + loss_hwl * dim_w + loss_heatmap * hm_w
             + loss_angle * ang_w)
    return total, {
        "loss": total,
        "loss_heatmap": loss_heatmap * hm_w,
        "loss_pos": loss_yx * pos_w,
        "loss_hwl": loss_hwl * dim_w,
        "loss_ang": loss_angle * ang_w,
    }


def compute_loss2d(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
                   loss_weight: Sequence[float] = (1.0, 1.0), count_sum=None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """2D-mode loss (`loss.py:77-102`)."""
    hm_w, pos_w = loss_weight
    mask = gt["mask"].movedim(1, -1)

    loss_yx = smooth_l1(torch.sigmoid(pred["loc_offset"]), gt["loc_offset"]) * mask
    loss_heatmap = focal_loss(pred["heatmap"], gt["heatmap"], count_sum=count_sum)
    loss_yx = loss_yx.sum() / _counted(count_sum, gt["mask"].sum()).clamp(min=1.0)

    total = loss_yx * pos_w + loss_heatmap * hm_w
    return total, {
        "loss": total,
        "loss_heatmap": loss_heatmap * hm_w,
        "loss_pos": loss_yx * pos_w,
    }
