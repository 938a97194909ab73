"""Rotated-box 2D IoU and 3D IoU in torch (port of `vfa_tpu/eval/iou.py`).

The intersection polygon of two rotated boxes has at most 24 candidate
vertices (4 + 4 corners + 16 edge intersections); the reference CUDA
kernel's angle-around-centroid CCW ordering (`sort_vert_kernel.cu:15-40`)
is a fixed-shape stable `argsort` over masked angle keys, and the shoelace
area a masked reduction — fully batched, on whatever device the boxes are
on (the evaluate CLI passes its `--device`).

Degenerate cases: identical boxes produce duplicate vertices at equal
angles; adjacent duplicates contribute zero to the shoelace sum, so the
area is correct without the special-casing of `sort_vert_kernel.cu:110-129`.
Fewer than 3 valid vertices likewise sum to zero area.
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-8


def boxes_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, h, alpha] -> (..., 4, 2) corners.

    Corner order and rotation convention match `IoU.py:6-35`:
    offsets (+w/2,+h/2), (-w/2,+h/2), (-w/2,-h/2), (+w/2,-h/2) rotated by
    [[cos, sin], [-sin, cos]] applied on the right.
    """
    x, y, w, h, a = (boxes[..., i] for i in range(5))
    sx = torch.tensor([0.5, -0.5, -0.5, 0.5], dtype=boxes.dtype, device=boxes.device)
    sy = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=boxes.dtype, device=boxes.device)
    tx = sx * w[..., None]
    ty = sy * h[..., None]
    cos, sin = torch.cos(a)[..., None], torch.sin(a)[..., None]
    rx = tx * cos - ty * sin
    ry = tx * sin + ty * cos
    return torch.stack([x[..., None] + rx, y[..., None] + ry], dim=-1)


def _edge_intersections(c1, c2):
    """All 16 pairwise edge intersections of two quads.

    c1, c2: (..., 4, 2). Returns points (..., 16, 2) and validity (..., 16).
    Matches `IoU.py:38-86`: strict t, u in (0, 1), points zeroed when invalid.
    """
    n1 = torch.cat([c1, torch.roll(c1, -1, dims=-2)], dim=-1)     # (...,4,4)
    n2 = torch.cat([c2, torch.roll(c2, -1, dims=-2)], dim=-1)
    e1 = n1[..., :, None, :].expand(*n1.shape[:-2], 4, 4, 4)        # (...,4,4,4)
    e2 = n2[..., None, :, :].expand(*n2.shape[:-2], 4, 4, 4)

    x1, y1, x2, y2 = (e1[..., i] for i in range(4))
    x3, y3, x4, y4 = (e2[..., i] for i in range(4))

    den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    num_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    num_u = (x2 - x1) * (y1 - y3) - (y2 - y1) * (x1 - x3)

    t_exact = num_t / den
    u_exact = num_u / den
    mask = (t_exact > 0.0) & (t_exact < 1.0) & (u_exact > 0.0) & (u_exact < 1.0)
    t = num_t / (den + EPSILON)
    px = x1 + t * (x2 - x1)
    py = y1 + t * (y2 - y1)
    pts = torch.stack([px, py], dim=-1) * mask[..., None]

    shp = pts.shape[:-3]
    return pts.reshape(*shp, 16, 2), mask.reshape(*shp, 16)


def _corners_inside(c1, c2):
    """Which corners of box1 lie inside box2 (`IoU.py:89-117`): projection
    onto two box2 edges within [-1e-6, 1+1e-6] of the edge length."""
    a = c2[..., 0:1, :]
    b = c2[..., 1:2, :]
    d = c2[..., 3:4, :]
    ab = b - a
    ad = d - a
    am = c1 - a
    p_ab = torch.sum(am * ab, dim=-1) / torch.sum(ab * ab, dim=-1)
    p_ad = torch.sum(am * ad, dim=-1) / torch.sum(ad * ad, dim=-1)
    in_ab = (p_ab > -1e-6) & (p_ab < 1.0 + 1e-6)
    in_ad = (p_ad > -1e-6) & (p_ad < 1.0 + 1e-6)
    return in_ab & in_ad


def intersection_area(c1, c2):
    """Overlap area of two convex quads given their corners (..., 4, 2)."""
    inters, m_int = _edge_intersections(c1, c2)
    in12 = _corners_inside(c1, c2)
    in21 = _corners_inside(c2, c1)
    verts = torch.cat([c1, c2, inters], dim=-2)               # (..., 24, 2)
    mask = torch.cat([in12, in21, m_int], dim=-1)              # (..., 24)

    nv = torch.sum(mask, dim=-1)                               # (...,)
    maskf = mask[..., None].to(verts.dtype)
    mean = torch.sum(verts * maskf, dim=-2, keepdim=True) / torch.clamp(
        nv[..., None, None], min=1).to(verts.dtype)
    centered = verts - mean
    ang = torch.atan2(centered[..., 1], centered[..., 0])
    key = torch.where(mask, torch.remainder(ang, 2.0 * math.pi),
                      torch.full_like(ang, math.inf))
    order = torch.argsort(key, dim=-1, stable=True)            # valid first, CCW
    sorted_v = torch.take_along_dim(verts, order[..., None], dim=-2)

    idx = torch.arange(24, device=verts.device)
    # next vertex: wrap the last *valid* one back to the first
    nxt = torch.roll(sorted_v, -1, dims=-2)
    first = sorted_v[..., 0:1, :]
    is_last = idx == (nv[..., None] - 1)
    nxt = torch.where(is_last[..., None], first, nxt)
    contrib = (
        sorted_v[..., 0] * nxt[..., 1] - sorted_v[..., 1] * nxt[..., 0]
    ) * (idx < nv[..., None])
    return torch.abs(torch.sum(contrib, dim=-1)) * 0.5


def iou_2d(box1, box2):
    """Rotated 2D IoU. box1, box2: (..., 5) [x, y, w, h, alpha].

    Returns (iou, overlap, union) — matching `IoUs2D` (`IoU.py:178-204`).
    Both boxes are measured from the midpoint of their centers (the IoU
    does not change under a common translation): at MultiviewC's world
    scale (coordinates to 3900) fp32 corners taken from the origin carry
    rounding errors that push corners of two identical boxes outside each
    other's 1e-6 tolerance, and the JAX package's formula scores them 1/3
    (fault F6, ROADMAP Queue 3); from the midpoint the rounding is relative
    to the boxes' own size.
    """
    mid = (box1[..., :2] + box2[..., :2]) * 0.5
    c1 = boxes_to_corners(torch.cat([box1[..., :2] - mid, box1[..., 2:]], dim=-1))
    c2 = boxes_to_corners(torch.cat([box2[..., :2] - mid, box2[..., 2:]], dim=-1))
    overlap = intersection_area(c1, c2)
    area1 = box1[..., 2] * box1[..., 3]
    area2 = box2[..., 2] * box2[..., 3]
    union = area1 + area2 - overlap
    return overlap / union, overlap, union


_BEV = [0, 1, 3, 4, 6]


def iou_3d(box1, box2):
    """3D IoU of z-axis-aligned rotated boxes (..., 7) [x y z l w h alpha].

    Matches `IoU3D` (`IoU.py:206-225`): 2D rotated IoU x z-overlap; the
    z-overlap is intentionally NOT clamped at zero (reference behavior —
    disjoint-in-z boxes yield a negative value that fails any IoU threshold).
    """
    b1 = box1[..., _BEV]
    b2 = box2[..., _BEV]
    zmax1 = box1[..., 2] + 0.5 * box1[..., 5]
    zmin1 = box1[..., 2] - 0.5 * box1[..., 5]
    zmax2 = box2[..., 2] + 0.5 * box2[..., 5]
    zmin2 = box2[..., 2] - 0.5 * box2[..., 5]
    z_overlap = torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)

    iou2, overlap, union = iou_2d(b1, b2)
    inter3d = iou2 * union * z_overlap
    v1 = box1[..., 3] * box1[..., 4] * box1[..., 5]
    v2 = box2[..., 3] * box2[..., 4] * box2[..., 5]
    return inter3d / (v1 + v2 - inter3d)


def iou_3d_pairwise(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """(N, 7), (M, 7) -> (N, M) full IoU3D matrix in one call — replaces the
    reference's per-pair CUDA round trips (`pyeval/evaluateAPAOS.py:79-83`)."""
    n, m = box1.shape[0], box2.shape[0]
    return iou_3d(box1[:, None, :].expand(n, m, 7), box2[None, :, :].expand(n, m, 7))
