"""The numbers that decide `correct`, each the program's distance from the
plain reference (`reference/`), and their limits (`workloads/<cell>.json`,
under "limits"; `PERF.md` gives the readings each was set from).

Serving:
- pred_vs_bf16: over the prediction heads (the heatmap logits, the
  offsets, the angle logits), the largest relative L2 distance of the
  program's predictions of the sampled scenes from the reference's, in
  units of the same distance of the reference's bf16 twin (`vs_twin`);
  the twin's distance swings tenfold from seed to seed with the weights,
  the ratio does not (PERF.md, §6).
- decode_mismatch: detections (scene, rank) in which any field of the
  program's decode differs from the reference decoder's on the program's
  own predictions: an exact comparison, limit 0.

Training (the first three steps, `reference.train_steps`):
- pred1_vs_bf16: the first step's predictions (training mode), as
  pred_vs_bf16;
- loss_gap: the largest relative gap between the program's and the
  reference's loss over the steps; loss1_gap, the first step's;
- grad_gap: the first step's gradient, by the worst leaf: the gap between
  the norms of the program's and the reference's gradient of the leaf,
  over the larger of the reference's norm of that leaf and of the median
  leaf; grad_gap_median, the median leaf's gap;
- change_gap, change_gap_median: the same of each parameter's change over
  the three steps, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (a bias in front of a norm:
  nought to rounding).
Which of them a cell compares is what its limits name.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

ZERO_GRAD = 1e-3
# the bf16 twin's relative distance is taken no lower than this: a head that
# rounding leaves all but unmoved would otherwise turn any difference into a
# large multiple
TWIN_FLOOR = 1e-4


def sq(t: torch.Tensor) -> float:
    return float((t.double() ** 2).sum())


def vs_twin(parts: list, floor: float = TWIN_FLOOR) -> float:
    """From rows (head, ref2, err2, twin_err2) of one or more scenes: the
    largest over the heads of the distance from the reference, pooled over
    the scenes, in units of the bf16 twin's (the reference with bf16
    operands: what rounding alone moves on these weights and inputs), the
    twin's relative distance taken no lower than `floor`."""
    heads = {}
    for h, ref2, err2, twin2 in parts:
        a = heads.setdefault(h, [0.0, 0.0, 0.0])
        a[0] += ref2
        a[1] += err2
        a[2] += twin2
    return max(math.sqrt(e / max(r, 1e-300)) / max(math.sqrt(t / max(r, 1e-300)), floor)
               for r, e, t in heads.values())


def head_parts(pred: dict, want: dict, twin: dict) -> list:
    """(head, ref2, err2, twin_err2) of one call's predictions (and any
    leading scene axis); a head whose shape differs from the reference's
    reads an infinite error."""
    rows = []
    for k, w in want.items():
        p = pred.get(k)
        err2 = sq(p.float() - w) if p is not None and p.shape == w.shape else math.inf
        rows.append((k, sq(w), err2, sq(twin[k] - w)))
    return rows


def decode_mismatch(prog: dict, ref: dict) -> int:
    """Detections (scene, rank) with any field unequal; fields are (B, K)
    or (B, K, D) arrays or tensors."""
    bad = None
    for k, r in ref.items():
        p = prog[k]
        p = torch.as_tensor(np.asarray(p)) if not isinstance(p, torch.Tensor) else p.cpu()
        r = r.cpu()
        if p.shape != r.shape:
            return int(np.prod(r.shape[:2]))
        ne = (p != r).reshape(*r.shape[:2], -1).any(-1)
        bad = ne if bad is None else bad | ne
    return int(bad.sum())


def moving_leaves(ref_grad_norms: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= ZERO_GRAD * med]


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> list:
    """[leaf, norm(prog), norm(ref), gap] of each leaf, the worst first."""
    names = list(ref) if leaves is None else leaves
    med = statistics.median(ref.values())
    rows = [[k, prog[k], ref[k], abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)] for k in names]
    return sorted(rows, key=lambda r: -r[3])


def train_numbers(prog: dict, ref: dict, detail: bool = False) -> dict:
    """The gaps of the program's first steps from the reference's; each
    side gives 'losses' (a list), and 'grads' and 'change' as leaf name ->
    norm. loss_gap over all steps and loss1_gap of the first; grad_gap and
    change_gap by the worst leaf, grad_gap_median and change_gap_median by
    the median leaf. `detail` adds each step's loss gap and the five worst
    leaves of each."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    grads = leaf_gaps(prog["grads"], ref["grads"])
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["grads"]))
    out = {"loss_gap": max(gaps), "loss1_gap": gaps[0],
           "grad_gap": grads[0][3], "grad_gap_median": statistics.median(r[3] for r in grads),
           "change_gap": change[0][3],
           "change_gap_median": statistics.median(r[3] for r in change)}
    if detail:
        out.update({"loss_gap.steps": gaps, "grad_gap.worst": grads[:5],
                    "change_gap.worst": change[:5]})
    return out


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, number, limit], ...]): correct when every number
    is at or under its limit."""
    rows = [[k, numbers[k], limits[k]] for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
