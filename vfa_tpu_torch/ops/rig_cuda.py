"""Compiled-rig sampling through the hand-written Hopper kernels.

Port of `vfa_tpu/ops/rig_pallas.py`. Window layout: `rig_window_fwd` wraps
`csrc/rig_window_fwd.cu`, the replacement of `_kernel_win`;
`rig_window_bwd` wraps `csrc/rig_window_bwd.cu`, the replacement of
`_bwd_kernel_win_pipe` and `_bwd_kernel_win`. Flat layout: `rig_flat_fwd`
wraps `csrc/rig_flat_fwd.cu`, the replacement of `_kernel`; `rig_flat_bwd`
wraps `csrc/rig_flat_bwd.cu`, the replacement of `_bwd_kernel`.
`RigScaleTiles` is the per-scale autograd function that mirrors
`_make_scale_op` (`rig_pallas.py:802-870`) and takes either layout, and
`rig_sample_scale_cuda` has the contract of `rig_sample_scale_pallas`
(`:917-988`): one launch per bucket, each writing its tile range of one
shared (N, B, T_total*tile_v, n_out) buffer, then the plain epilogue
(inv_perm gather, bias + ReLU, fp32 camera sum), which autograd
differentiates.

The forward kernels are fp32 SGEMM passes on the CUDA cores; the backward
kernels run on the tensor cores and stay fp32-accurate through a 3xTF32
split (`csrc/rig_mma.cuh`; the same arithmetic in plain PyTorch is
`ops/rig.matmul_3xtf32`).

On a CPU tensor a wrapper runs its kernel's plain version
(`ops/rig.window_tiles`, `window_tiles_bwd`, `flat_tiles`,
`flat_tiles_bwd`); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from vfa_tpu_torch.ops.rig import (
    ScaleRig, collapse_per_layer, flat_tiles, flat_tiles_bwd, rig_epilogue,
    scale_features, window_tiles, window_tiles_bwd,
)


def _check_launch(what, ii, tensors, shapes_ok, C, n_out, K, describe,
                  k_multiple=16):
    """Shared argument checks of the kernels' wrappers: one device,
    contiguous, float32 (int32 starts), consistent shapes, and the widths
    the kernels are written for: C = n_out = 256 (the width of the CTA
    tiles, of the forward's SGEMM passes and of the backward's tensor-core
    passes alike) and a band length K that is a multiple of 16 for a
    window, of 8 for a flat band (both stage 16-deep slices and mask whole
    16-byte quads past a band; any nl, tile_v and T go)."""
    if ii.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ii.device}")
    for name, t in tensors.items():
        if t.device != ii.device:
            raise ValueError(f"{what}: {name} on {t.device}, ii on {ii.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        want = torch.int32 if name == "starts" else torch.float32
        if t.dtype != want:
            raise TypeError(
                f"{what}: {name} must be {str(want).split('.')[-1]}"
                + (" (the bf16 variants are not ported yet: ROADMAP.md "
                   "Queue 2)" if want == torch.float32 else "")
                + f", got {t.dtype}")
    if not shapes_ok:
        raise ValueError(f"{what}: inconsistent shapes {describe}")
    if C != 256 or n_out != 256 or K % k_multiple:
        raise ValueError(f"{what}: the kernel takes C = n_out = 256 and a "
                         f"band length that is a multiple of {k_multiple}, "
                         f"got C {C}, n_out {n_out}, band length {K}")


# depth chunks of the backward's dKr pass (DKR_MAX_SPLITS in csrc/rig_mma.cuh)
DKR_MAX_SPLITS = 16


def _bwd_scratch(ii, T, R, nl, n_out):
    """Scratch of one backward launch: vox (the recomputed A product, then
    dvox written over it) and the dKr pass's workspace (one partial dKr per
    depth chunk, added into dKr in a fixed order by the pass's second
    stage)."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    ws = torch.empty((DKR_MAX_SPLITS, nl, C, n_out), dtype=torch.float32,
                     device=ii.device)
    return vox, ws


def _launch(name, ii, *args):
    from vfa_tpu_torch.kernels import launch

    launch(name, f"{name}_f32", ii.device, *args)


def rig_window_fwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                   Kr: torch.Tensor, out: torch.Tensor, *, off_t: int,
                   tile_v: int, window) -> torch.Tensor:
    """Write one bucket's tiles into `out` rows [off_t*tile_v, (off_t+T)*tile_v).

    ii (N, B, Hp, Wp, C) padded features; A_b (N, T, nl*tile_v, wh*ww);
    starts_b (N, T, 2) int32; Kr (nl, C, n_out); out (N, B, rows, n_out).
    `rig_window_fwd.launches` counts kernel launches."""
    N, B, Hp, Wp, C = ii.shape
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    wh, ww = window
    rows = out.shape[2]
    if ii.device.type == "cpu":
        out[:, :, off_t * tile_v:(off_t + T) * tile_v] = window_tiles(
            ii, A_b, starts_b, Kr, window, tile_v)
        return out
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "out": out}
    _check_launch(
        "rig_window_fwd", ii, tensors,
        A_b.shape[0] == N and R == nl * tile_v and K == wh * ww
        and tuple(starts_b.shape) == (N, T, 2)
        and tuple(Kr.shape) == (nl, C, n_out)
        and tuple(out.shape) == (N, B, rows, n_out)
        and (off_t + T) * tile_v <= rows and wh <= Hp and ww <= Wp,
        C, n_out, K,
        f"ii {tuple(ii.shape)}, A {tuple(A_b.shape)}, starts "
        f"{tuple(starts_b.shape)}, Kr {tuple(Kr.shape)}, out "
        f"{tuple(out.shape)}, off_t {off_t}, tile_v {tile_v}, window {window}")
    # vox scratch between the kernel's two passes (A-product, collapse)
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    _launch("rig_window_fwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), Kr.data_ptr(), vox.data_ptr(), out.data_ptr(),
            N, B, Hp, Wp, C, T, nl, tile_v, wh, ww, n_out, off_t, rows)
    rig_window_fwd.launches += 1
    return out


rig_window_fwd.launches = 0


def rig_window_bwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                   Kr: torch.Tensor, g: torch.Tensor, dII: torch.Tensor,
                   dKr: torch.Tensor, *, off_t: int, tile_v: int, window,
                   KrT: torch.Tensor = None):
    """Add one bucket's gradients into the scale's accumulators.

    ii, A_b, starts_b, Kr as `rig_window_fwd`; g (N, B, rows, n_out) is the
    cotangent of the whole tiles buffer (the bucket reads its rows at
    off_t); dII (N, B, Hp, Wp, C) and dKr (nl, C, n_out) are fp32
    accumulators that are added to in place. KrT is Kr with its last two
    axes swapped, contiguous (made here if not given). Returns (dII, dKr).
    `rig_window_bwd.launches` counts kernel launches."""
    N, B, Hp, Wp, C = ii.shape
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    wh, ww = window
    rows = g.shape[2]
    if ii.device.type == "cpu":
        _, dKr_b = window_tiles_bwd(
            ii, A_b, starts_b, Kr,
            g[:, :, off_t * tile_v:(off_t + T) * tile_v], window, tile_v,
            dII=dII)
        dKr += dKr_b
        return dII, dKr
    if KrT is None:
        KrT = Kr.transpose(1, 2).contiguous()
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "KrT": KrT,
               "g": g, "dII": dII, "dKr": dKr}
    _check_launch(
        "rig_window_bwd", ii, tensors,
        A_b.shape[0] == N and R == nl * tile_v and K == wh * ww
        and tuple(starts_b.shape) == (N, T, 2)
        and tuple(Kr.shape) == (nl, C, n_out)
        and tuple(KrT.shape) == (nl, n_out, C)
        and tuple(g.shape) == (N, B, rows, n_out)
        and dII.shape == ii.shape and dKr.shape == Kr.shape
        and (off_t + T) * tile_v <= rows and wh <= Hp and ww <= Wp,
        C, n_out, K,
        f"ii {tuple(ii.shape)}, A {tuple(A_b.shape)}, starts "
        f"{tuple(starts_b.shape)}, Kr {tuple(Kr.shape)}, g {tuple(g.shape)}, "
        f"dII {tuple(dII.shape)}, dKr {tuple(dKr.shape)}, off_t {off_t}, "
        f"tile_v {tile_v}, window {window}")
    vox, ws = _bwd_scratch(ii, T, R, nl, n_out)
    _launch("rig_window_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(), vox.data_ptr(),
            ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(), N, B, Hp, Wp, C, T,
            nl, tile_v, wh, ww, n_out, off_t, rows)
    rig_window_bwd.launches += 1
    return dII, dKr


rig_window_bwd.launches = 0


def rig_flat_fwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                 Kr: torch.Tensor, out: torch.Tensor, *, off_t: int,
                 tile_v: int) -> torch.Tensor:
    """Write one flat bucket's tiles into `out` rows
    [off_t*tile_v, (off_t+T)*tile_v).

    ii (N, B, P + max_band, C) padded flat features; A_b
    (N, T, nl*tile_v, band); starts_b (N, T) int32; Kr (nl, C, n_out); out
    (N, B, rows, n_out). `rig_flat_fwd.launches` counts kernel launches."""
    N, B, pixels, C = ii.shape
    T, R, band = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    rows = out.shape[2]
    if ii.device.type == "cpu":
        out[:, :, off_t * tile_v:(off_t + T) * tile_v] = flat_tiles(
            ii, A_b, starts_b, Kr, tile_v)
        return out
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "out": out}
    _check_launch(
        "rig_flat_fwd", ii, tensors,
        A_b.shape[0] == N and R == nl * tile_v
        and tuple(starts_b.shape) == (N, T)
        and tuple(Kr.shape) == (nl, C, n_out)
        and tuple(out.shape) == (N, B, rows, n_out)
        and (off_t + T) * tile_v <= rows and band <= pixels,
        C, n_out, band,
        f"ii {tuple(ii.shape)}, A {tuple(A_b.shape)}, starts "
        f"{tuple(starts_b.shape)}, Kr {tuple(Kr.shape)}, out "
        f"{tuple(out.shape)}, off_t {off_t}, tile_v {tile_v}", k_multiple=8)
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    _launch("rig_flat_fwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), Kr.data_ptr(), vox.data_ptr(), out.data_ptr(),
            N, B, pixels, C, T, nl, tile_v, band, n_out, off_t, rows)
    rig_flat_fwd.launches += 1
    return out


rig_flat_fwd.launches = 0


def rig_flat_bwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                 Kr: torch.Tensor, g: torch.Tensor, dII: torch.Tensor,
                 dKr: torch.Tensor, *, off_t: int, tile_v: int,
                 KrT: torch.Tensor = None):
    """Add one flat bucket's gradients into the scale's accumulators: as
    `rig_window_bwd`, with ii and dII (N, B, P + max_band, C) (dII's last
    max_band rows are padding). `rig_flat_bwd.launches` counts kernel
    launches."""
    N, B, pixels, C = ii.shape
    T, R, band = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    rows = g.shape[2]
    if ii.device.type == "cpu":
        _, dKr_b = flat_tiles_bwd(
            ii, A_b, starts_b, Kr,
            g[:, :, off_t * tile_v:(off_t + T) * tile_v], tile_v, dII=dII)
        dKr += dKr_b
        return dII, dKr
    if KrT is None:
        KrT = Kr.transpose(1, 2).contiguous()
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "KrT": KrT,
               "g": g, "dII": dII, "dKr": dKr}
    _check_launch(
        "rig_flat_bwd", ii, tensors,
        A_b.shape[0] == N and R == nl * tile_v
        and tuple(starts_b.shape) == (N, T)
        and tuple(Kr.shape) == (nl, C, n_out)
        and tuple(KrT.shape) == (nl, n_out, C)
        and tuple(g.shape) == (N, B, rows, n_out)
        and dII.shape == ii.shape and dKr.shape == Kr.shape
        and (off_t + T) * tile_v <= rows and band <= pixels,
        C, n_out, band,
        f"ii {tuple(ii.shape)}, A {tuple(A_b.shape)}, starts "
        f"{tuple(starts_b.shape)}, Kr {tuple(Kr.shape)}, g {tuple(g.shape)}, "
        f"dII {tuple(dII.shape)}, dKr {tuple(dKr.shape)}, off_t {off_t}, "
        f"tile_v {tile_v}", k_multiple=8)
    vox, ws = _bwd_scratch(ii, T, R, nl, n_out)
    _launch("rig_flat_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(), vox.data_ptr(),
            ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(), N, B, pixels, C, T,
            nl, tile_v, band, n_out, off_t, rows)
    rig_flat_bwd.launches += 1
    return dII, dKr


rig_flat_bwd.launches = 0


def _buckets(rig: ScaleRig):
    """(A_b, starts_b, off_t, window or None) of every bucket of a scale."""
    off_t = 0
    for bi, (A_b, s_b) in enumerate(zip(rig.A, rig.starts)):
        yield A_b, s_b, off_t, rig.window_hw[bi] if rig.window_hw else None
        off_t += A_b.shape[1]


def rig_scale_bwd(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor,
                  g: torch.Tensor):
    """(dII, dKr) of one scale's tiles: one zero-filled dII threaded through
    every bucket's launch, dKr summed over buckets, both fp32."""
    dII = torch.zeros(ii.shape, dtype=torch.float32, device=ii.device)
    dKr = torch.zeros(Kr.shape, dtype=torch.float32, device=ii.device)
    KrT = Kr.transpose(1, 2).contiguous()
    g = g.contiguous()
    for A_b, s_b, off_t, win in _buckets(rig):
        if win is None:
            rig_flat_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off_t,
                         tile_v=rig.tile_v, KrT=KrT)
        else:
            rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off_t,
                           tile_v=rig.tile_v, window=win, KrT=KrT)
    return dII, dKr


class RigScaleTiles(torch.autograd.Function):
    """(ii, Kr) -> the scale's (N, B, T_total*tile_v, n_out) tiles, every
    bucket written in place into one buffer; the backward runs the backward
    kernel bucket by bucket. ii is the scale's padded features in the rig's
    layout (`ops.rig.scale_features`). A and starts are rig structure and
    get no gradient."""

    @staticmethod
    def forward(ctx, ii, Kr, rig: ScaleRig):
        N, B = ii.shape[:2]
        T_total = sum(a.shape[1] for a in rig.A)
        out = torch.empty((N, B, T_total * rig.tile_v, Kr.shape[-1]),
                          dtype=ii.dtype, device=ii.device)
        for A_b, s_b, off_t, win in _buckets(rig):
            if win is None:
                rig_flat_fwd(ii, A_b, s_b, Kr, out, off_t=off_t,
                             tile_v=rig.tile_v)
            else:
                rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=off_t,
                               tile_v=rig.tile_v, window=win)
        ctx.save_for_backward(ii, Kr)
        ctx.rig = rig
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ii, Kr = ctx.saved_tensors
        dII, dKr = rig_scale_bwd(ii, ctx.rig, Kr, g)
        return dII.to(ii.dtype), dKr.to(Kr.dtype), None


def rig_tiles_cuda(lat: torch.Tensor, rig: ScaleRig,
                   collapse_kernel: torch.Tensor) -> torch.Tensor:
    """All buckets of one scale: (N, B, T_total*tile_v, n_out) tiles.
    Differentiable in lat and collapse_kernel (for a flat rig the padding,
    and the cumsum of a 16-tap rig, are differentiated by autograd)."""
    ii = scale_features(lat, rig)
    Kr = collapse_per_layer(collapse_kernel, lat.shape[-1], rig.nl, lat.dtype)
    return RigScaleTiles.apply(ii, Kr, rig)


def rig_sample_scale_cuda(lat, rig: ScaleRig, collapse_kernel, collapse_bias,
                          out_dtype=None, camera_sum=False):
    """Same contract as `ops.rig.rig_sample_scale`, through the kernel."""
    out_dtype = out_dtype or lat.dtype
    tiles = rig_tiles_cuda(lat, rig, collapse_kernel)
    return rig_epilogue(tiles, rig.inv_perm, collapse_bias, out_dtype,
                        camera_sum)
