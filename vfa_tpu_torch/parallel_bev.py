"""BEV-grid spatial sharding over a (data, bev) mesh of ranks (port of
`vfa_tpu/parallel_bev.py`).

The voxel rig's A matrices scale with the BEV cell count (the 2x-voxel
MultiviewC config builds a 5.4 GB window rig), and so do the BEV
activations. This module splits the BEV plane into contiguous row slabs,
one a rank of the mesh's `bev` axis: each rank holds only its slab's rig
and samples only its slab's cells. JAX then lets GSPMD partition the
downstream 3x3 convs with halo exchanges; here they are written out
(`RowSlab`, `heads`): each conv reads `halo` rows of its neighbours (the
rows its receptive field reaches past the slab: 1 for a 3x3 conv, 2 and 4
for the dilated ones), the fuse BatchNorms and the heads' GroupNorms sum
their statistics over the slabs, and the predictions are gathered to the
whole plane for the loss, which every rank of a bev group computes alike.

Design, as in JAX: each slab is built by `ops.rig.build_rig` (through the
rig cache), then the slabs are unified to one bucket structure (the same
bucket count and (T, band, window) per bucket, cross-slab maxima,
zero-padded, window origins re-clamped and A's columns re-laid,
`_unify_scale`) so that they stack on a leading shard axis; zero A tiles
add nothing, padded output slots are never read by a slab's inv_perm.
Every rank runs the same kernels as the single-card path
(`ops/rig_cuda.py`) on its slab; the gradient of the replicated features
is the sum of the slabs' dII (`parallel.copy_to_partial`). The bf16
backward's dII order (`ScaleRig.dii_order`) is rebuilt for the unified
buckets. The grid's row count is padded to a multiple of the shard count
by repeating its last row; those rows are sampled and then masked.

Gradients (`parallel.reduce_gradients`): the collapses and everything
downstream of the sampling sum over `bev` (each rank differentiates its
slab); the backbone's gradients are whole already (the features' dII was
summed).

Every collective is an `all_reduce`, so halos and the gather are
all-reduces of zero-filled buffers into which each rank writes its rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vfa_tpu_torch import parallel
from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.ops import rig_cuda
from vfa_tpu_torch.ops.rig import ScaleRig, _dii_orders, _round_up, build_rig, rig_bev

@dataclasses.dataclass
class BevShardedRig:
    """Slab-stacked rig, on the host: every ScaleRig array carries a
    leading shard axis (A: (D, N, T_b, rows, band_b), starts:
    (D, N, T_b, 2), inv_perm: (D, N, slab_rows*W)); no dii_order (`slab`
    makes it)."""

    scales: List[ScaleRig]
    grid_shape: Tuple[int, int]   # true (L, W); slabs cover rup(L, D) rows
    slab_rows: int
    num_shards: int

    def slab(self, mesh: parallel.Mesh, device) -> "BevSlab":
        """This rank's slab (its coordinate on the mesh's bev axis) on
        `device`."""
        d = mesh.index("bev")
        scales = []
        for sr in self.scales:
            starts = [s[d].numpy() for s in sr.starts]
            A = tuple(a[d].to(device) for a in sr.A)
            scales.append(ScaleRig(
                A=A, starts=tuple(torch.from_numpy(s).to(device) for s in starts),
                inv_perm=sr.inv_perm[d].to(device), feat_hw=sr.feat_hw,
                nl=sr.nl, tile_v=sr.tile_v, on_raw=True, window_hw=sr.window_hw,
                dii_order=_dii_orders(starts, sr.window_hw,
                                      [a.shape[-1] for a in A], sr.feat_hw,
                                      device)))
        return BevSlab(scales=scales, grid_shape=self.grid_shape,
                       slab_rows=self.slab_rows, num_shards=self.num_shards,
                       rows=RowSlab(mesh.group("bev"), d, self.num_shards,
                                    self.slab_rows, self.grid_shape[0]),
                       mesh=mesh)


@dataclasses.dataclass
class BevSlab:
    """One rank's slab of a BevShardedRig: ScaleRigs over its
    slab_rows x W cells (the model samples through it as through a
    CameraRig), its place among the slabs and the mesh it was cut for
    (the model that samples through it runs on that mesh)."""

    scales: List[ScaleRig]
    grid_shape: Tuple[int, int]
    slab_rows: int
    num_shards: int
    rows: "RowSlab"
    mesh: object = None


class RowSlab:
    """A rank's rows [index*rows, (index+1)*rows) of an L-row plane split
    over `count` ranks of `group`; rows past L are padding, kept at zero.
    With count 1 it is the unsplit plane (no collective)."""

    def __init__(self, group, index: int, count: int, rows: int, L: int):
        self.group, self.index, self.count, self.rows, self.L = (
            group, index, count, rows, L)
        self.valid = int(min(max(L - index * rows, 0), rows))

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, rows, W) with the padding rows set to zero."""
        if self.valid == self.rows:
            return x
        keep = torch.arange(self.rows, device=x.device) < self.valid
        return x * keep.to(x.dtype)[:, None]

    def halo(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """x (B, C, rows, W) -> (B, C, rows + 2h, W): the h rows above and
        below the slab from its neighbours (zeros past the plane, as a
        conv's zero padding), through one all-reduce of every rank's first
        and last min(h, rows) rows."""
        x = self.mask(x)
        if self.count == 1:
            return F.pad(x, (0, 0, h, h))
        e = min(h, self.rows)
        k = -(-h // self.rows)                  # slabs a halo reaches across
        edges = torch.stack([x[:, :, :e], x[:, :, self.rows - e:]])
        buf = F.pad(edges[None], (0,) * 10 + (self.index, self.count - 1 - self.index))
        buf = parallel.sum_shared(buf, self.group)   # (count, 2, B, C, e, W)
        zero = torch.zeros_like(edges[0])
        above = [buf[s, 1] if s >= 0 else zero for s in range(self.index - k, self.index)]
        below = [buf[s, 0] if s < self.count else zero
                 for s in range(self.index + 1, self.index + 1 + k)]
        return torch.cat([torch.cat(above, 2)[:, :, k * e - h:], x,
                          torch.cat(below, 2)[:, :, :h]], 2)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, rows, W) -> the whole plane (B, C, L, W) on every rank,
        for consumers that every rank runs alike (its backward keeps this
        rank's rows of their cotangent)."""
        if self.count == 1:
            return x
        full = F.pad(self.mask(x), (0, 0, self.index * self.rows,
                                    (self.count - 1 - self.index) * self.rows))
        return parallel.sum_replicated(full, self.group)[:, :, :self.L]


def make_bev_mesh(data: int = 1, bev: int = -1) -> parallel.Mesh:
    """A (data, bev) mesh of all ranks; bev=-1 takes the rest."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if bev == -1:
        if world % data:
            raise ValueError(f"{world} ranks not divisible by data={data}")
        bev = world // data
    return parallel.Mesh(("data", "bev"), (data, bev))


def _np_a(a: torch.Tensor) -> np.ndarray:
    """A as numpy bits: bf16 as its uint16 pattern (numpy has no bf16)."""
    a = a.detach().cpu()
    return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()


def _unify_scale(slabs: Sequence[ScaleRig], dtype) -> ScaleRig:
    """Pad per-slab bucket structures to common static shapes and stack
    (`vfa_tpu/parallel_bev.py:77-147`, the same arrays).

    Window origins are re-clamped for the (possibly larger) common window
    dims and the A columns re-laid for the common row-major (wh, ww)
    flattening; content shifts inside the window by exactly the origin
    shift, so the sampled values are unchanged."""
    if not all(s.window_hw for s in slabs):
        raise ValueError("BEV sharding takes the window layout only")
    fh, fw = slabs[0].feat_hw
    nl, tile_v = slabs[0].nl, slabs[0].tile_v
    rows = nl * tile_v
    fh_pad, fw_pad = _round_up(fh, 8), _round_up(fw, 16)
    nb = max(len(s.A) for s in slabs)

    # common bucket dims (cross-slab maxima; missing buckets -> minimal)
    wh_b, ww_b, T_b = [], [], []
    for b in range(nb):
        whs = [s.window_hw[b][0] for s in slabs if b < len(s.A)]
        wws = [s.window_hw[b][1] for s in slabs if b < len(s.A)]
        Ts = [s.A[b].shape[1] for s in slabs if b < len(s.A)]
        wh_b.append(_round_up(max(whs), 8))
        ww_b.append(_round_up(max(wws), 16))
        T_b.append(max(Ts))

    num_cam = slabs[0].A[0].shape[0]
    A_stk = [[] for _ in range(nb)]
    s_stk = [[] for _ in range(nb)]
    ip_stk = []
    np_dtype = _np_a(slabs[0].A[0]).dtype
    for sr in slabs:
        T_old = [sr.A[b].shape[1] if b < len(sr.A) else 0 for b in range(nb)]
        off_old = np.cumsum([0] + T_old[:-1]) * tile_v
        off_new = np.cumsum([0] + T_b[:-1]) * tile_v
        for b in range(nb):
            A_new = np.zeros((num_cam, T_b[b], rows, wh_b[b] * ww_b[b]), np_dtype)
            st_new = np.zeros((num_cam, T_b[b], 2), np.int32)
            if b < len(sr.A):
                A_old = _np_a(sr.A[b])
                st_old = sr.starts[b].cpu().numpy()
                who, wwo = sr.window_hw[b]
                # re-clamp origins for the common (larger) window dims;
                # fw_pad - ww_b stays 8-aligned (both 16-aligned)
                ry2 = np.minimum(st_old[..., 0], max(fh_pad - wh_b[b], 0))
                rx2 = np.minimum(st_old[..., 1], max(fw_pad - ww_b[b], 0))
                st_new[:, :T_old[b], 0] = ry2
                st_new[:, :T_old[b], 1] = rx2
                oy = st_old[..., 0] - ry2          # content shift >= 0
                ox = st_old[..., 1] - rx2
                A5 = A_old.reshape(num_cam, T_old[b], rows, who, wwo)
                A5_new = A_new.reshape(num_cam, T_b[b], rows, wh_b[b], ww_b[b])
                for n in range(num_cam):
                    for t in range(T_old[b]):
                        y0, x0 = int(oy[n, t]), int(ox[n, t])
                        A5_new[n, t, :, y0:y0 + who, x0:x0 + wwo] = A5[n, t]
            A_stk[b].append(A_new)
            s_stk[b].append(st_new)
        # remap inv_perm slots for the padded bucket layout
        ip = sr.inv_perm.cpu().numpy().astype(np.int64)
        bounds = np.cumsum([t * tile_v for t in T_old])
        b_of = np.searchsorted(bounds, ip, side="right")
        ip_stk.append((ip - off_old[b_of] + off_new[b_of]).astype(np.int32))

    def tensor(a):
        if a.dtype == np.uint16:                 # bf16 bits
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a).to(dtype)

    return ScaleRig(
        A=tuple(tensor(np.stack(A_stk[b])) for b in range(nb)),
        starts=tuple(torch.from_numpy(np.stack(s_stk[b])) for b in range(nb)),
        inv_perm=torch.from_numpy(np.stack(ip_stk).astype(np.int64)),
        feat_hw=(fh, fw), nl=nl, tile_v=tile_v, on_raw=True,
        window_hw=tuple(zip(wh_b, ww_b)),
    )


def bev_rig_cache_path(cache_dir: str, calibs, cfg: DatasetConfig, grid,
                       feat_shapes, num_shards: int, tile_v: int, dtype,
                       crange, band_buckets: int) -> str:
    """The npz a unified BEV-sharded rig with these inputs is cached in
    (`ops.rig.rig_cache_path`'s key, with the shard count)."""
    from vfa_tpu_torch.ops.rig import rig_cache_path

    base = rig_cache_path(cache_dir, calibs, cfg, grid, feat_shapes, tile_v,
                          dtype, crange, True, band_buckets, "window")
    return base.replace("torch_rig_", f"torch_bevrig{int(num_shards)}_")


def _save_bev(path: str, srig: BevShardedRig) -> None:
    saved = {"meta": np.asarray([*srig.grid_shape, srig.slab_rows, srig.num_shards])}
    for i, sr in enumerate(srig.scales):
        saved[f"scale{i}"] = np.asarray([len(sr.A), sr.nl, sr.tile_v, *sr.feat_hw])
        saved[f"p{i}"] = sr.inv_perm.numpy().astype(np.int32)
        for b, (a, st) in enumerate(zip(sr.A, sr.starts)):
            saved[f"A{i}_{b}"] = _np_a(a)
            saved[f"s{i}_{b}"] = st.numpy()
            saved[f"w{i}_{b}"] = np.asarray(sr.window_hw[b], np.int64)
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **saved)
    os.replace(tmp, path)


def _load_bev(path: str, dtype) -> BevShardedRig:
    scales = []
    with np.load(path) as z:
        L, W, slab_rows, D = (int(x) for x in z["meta"])
        i = 0
        while f"scale{i}" in z:
            nb, nl, tile_v, fh, fw = (int(x) for x in z[f"scale{i}"])
            A = []
            for b in range(nb):
                a = z[f"A{i}_{b}"]
                A.append(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                         if a.dtype == np.uint16 else torch.from_numpy(a).to(dtype))
            scales.append(ScaleRig(
                A=tuple(A), starts=tuple(torch.from_numpy(z[f"s{i}_{b}"]) for b in range(nb)),
                inv_perm=torch.from_numpy(z[f"p{i}"].astype(np.int64)),
                feat_hw=(fh, fw), nl=nl, tile_v=tile_v, on_raw=True,
                window_hw=tuple(tuple(int(x) for x in z[f"w{i}_{b}"]) for b in range(nb))))
            i += 1
    return BevShardedRig(scales=scales, grid_shape=(L, W), slab_rows=slab_rows,
                         num_shards=D)


def build_bev_sharded_rig(
    calibs: np.ndarray,
    cfg: DatasetConfig,
    grid: np.ndarray,
    feat_shapes: Sequence[Tuple[int, int]],
    num_shards: int,
    tile_v: int = 160,
    dtype=torch.bfloat16,
    crange=(-1.0, 0.95),
    cache_dir: str | None = None,
    band_buckets: int = 8,
) -> BevShardedRig:
    """Build one window rig per BEV row slab (on the host) and stack them
    (`BevShardedRig.slab` places one on a rank's device). With
    `cache_dir`, each slab goes through the rig cache (`ops.rig.build_rig`)
    and the unified rig is kept there too (`bev_rig_cache_path`), so a
    repeated run loads it.

    The grid's row count is padded to a multiple of `num_shards` by
    repeating the last row (the padded cells compute but are masked)."""
    grid_np = np.asarray(grid)
    path = None
    if cache_dir is not None:
        cache_dir = os.path.expanduser(cache_dir)
        path = bev_rig_cache_path(cache_dir, np.asarray(calibs), cfg, grid_np,
                                  feat_shapes, num_shards, tile_v, dtype, crange,
                                  band_buckets)
        if os.path.exists(path):
            return _load_bev(path, dtype)
    L, W = grid_np.shape[0], grid_np.shape[1]
    D = num_shards
    L_pad = _round_up(L, D)
    if L_pad > L:
        grid_np = np.concatenate(
            [grid_np, np.repeat(grid_np[-1:], L_pad - L, axis=0)], axis=0)
    slab = L_pad // D
    slabs = [
        build_rig(calibs, cfg, grid_np[d * slab:(d + 1) * slab], feat_shapes,
                  tile_v=tile_v, dtype=dtype, crange=crange,
                  cache_dir=cache_dir, band_buckets=band_buckets,
                  layout="window", device="cpu")
        for d in range(D)
    ]
    scales = [_unify_scale([s.scales[si] for s in slabs], dtype)
              for si in range(len(feat_shapes))]
    srig = BevShardedRig(scales=scales, grid_shape=(L, W), slab_rows=slab,
                         num_shards=D)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        _save_bev(path, srig)
    return srig


def sample_bev_sharded(lats, srig: BevSlab, kernels, biases, out_dtype=None,
                       impl: str = "cuda"):
    """This rank's slab of the fused BEV features.

    lats: per-scale (B, N, fh, fw, C) feature pyramids, the same on every
    rank of the bev group; kernels / biases: per-scale collapse Linears
    ((C*nl, n_out), c-major, and (n_out,)). The slab's scales go through
    `ops.rig_cuda.rig_bev` (`impl` 'cuda': the kernels on CUDA tensors,
    their plain versions on CPU tensors) or the plain `ops.rig.rig_bev`
    ('plain') with fp32 out: the per-scale chain. Returns (B, slab_rows,
    W, n_out) in `out_dtype` (default the features'), its padding rows
    masked; the features' gradient is summed over the slabs."""
    W = srig.grid_shape[1]
    B = lats[0].shape[0]
    n_out = kernels[0].shape[-1]
    out_dtype = out_dtype or lats[0].dtype
    lats = [parallel.copy_to_partial(lat, srig.rows.group) for lat in lats]
    ortho = (rig_cuda.rig_bev if impl == "cuda" else rig_bev)(
        lats, srig.scales, kernels, biases, torch.float32)
    ortho = ortho.reshape(B, srig.slab_rows, W, n_out)
    return srig.rows.mask(ortho.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).to(out_dtype)


def gather_bev(x: torch.Tensor, srig: BevSlab) -> torch.Tensor:
    """A slab (B, slab_rows, W, C) -> the whole plane (B, L, W, C) on
    every rank of the bev group."""
    return srig.rows.gather(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# --- the fuse block and the heads on row slabs ----------------------------

def conv_rows(conv, x: torch.Tensor) -> torch.Tensor:
    """`conv` on x whose rows already hold its halo: zero padding along the
    width only; rounds a bf16 bias as `model.vfanet.Conv2d` does."""
    from vfa_tpu_torch.model.vfanet import Conv2d

    pad = (0, conv.padding[1])
    if isinstance(conv, Conv2d) and x.dtype == torch.bfloat16 and conv.bias is not None:
        return (F.conv2d(x, conv.weight, None, conv.stride, pad, conv.dilation)
                + conv.bias.view(1, -1, 1, 1))
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, pad, conv.dilation)


def group_norm_rows(gn, x: torch.Tensor, reduce, count: int) -> torch.Tensor:
    """GroupNorm of x (B, C, rows, W) with each (scene, group)'s sums of x
    and x^2 taken by `reduce` (over the slabs) and divided by `count`
    elements (C/G * L * W): fp32 statistics, var = E[x^2] - E[x]^2, one
    rounding to x's dtype."""
    B, C, R, W = x.shape
    G = gn.num_groups
    xs = x.float().reshape(B, G, C // G, R, W)
    s = reduce(torch.stack([xs.sum((2, 3, 4)), (xs * xs).sum((2, 3, 4))]))
    mean = s[0] / count
    var = torch.clamp(s[1] / count - mean * mean, min=0.0)
    y = (xs - mean[..., None, None, None]) * torch.rsqrt(var + gn.eps)[..., None, None, None]
    y = y.reshape(B, C, R, W) * gn.weight.float().view(1, -1, 1, 1) \
        + gn.bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def heads(model, ortho: torch.Tensor, mesh: parallel.Mesh, rows: RowSlab):
    """VFANet's fuse block and heads on this rank's rows of the BEV
    features ortho (B, rows, W, 256), each conv with its halo, the
    BatchNorms' statistics summed over the slabs and the global batch
    (`data`), the GroupNorms' over the slabs; returns the prediction dict
    of the whole plane (gathered), as `VFANet.forward`."""
    x = rows.mask(ortho.permute(0, 3, 1, 2))
    B, _, _, W = x.shape
    L = rows.L
    bev = mesh.group("bev") if rows.count > 1 else None
    bn_group = mesh.group(("data", "bev") if rows.count > 1 else ("data",))
    bn_count = B * mesh.size("data") * L * W

    def conv(mod, t):
        # a 'same' conv reads as many rows past the slab as it pads
        return rows.mask(conv_rows(mod, rows.halo(t, mod.padding[0])))

    def bn(mod, t):
        if bn_group is None:
            return mod(t)
        return mod.synced(t, lambda s: parallel.sum_shared(s, bn_group), bn_count)

    def gn(mod, t):
        if bev is None:
            return mod(t)
        return group_norm_rows(mod, t, lambda s: parallel.sum_shared(s, bev),
                               t.shape[1] // mod.num_groups * L * W)

    f = rows.mask(torch.relu(bn(model.fuse[1], conv(model.fuse[0], x))))
    fused = rows.mask(torch.relu(bn(model.fuse[4], conv(model.fuse[3], f))))

    def head(seq):
        return conv(seq[3], rows.mask(torch.relu(gn(seq[1], conv(seq[0], x)))))

    nhwc = lambda t: rows.gather(t).permute(0, 2, 3, 1)
    pred = {"heatmap": rows.gather(conv(model.map_classifier[0], fused)),
            "loc_offset": nhwc(head(model.tytx_pred))}
    if model.cfg.mode == "3D":
        pred["dim_offset"] = nhwc(head(model.thtwtl_pred))
        pred["rotation"] = nhwc(conv(model.orient_pred[0], fused))
    return pred
