"""Compiled-rig sampling through the hand-written Hopper window kernels.

Port of `vfa_tpu/ops/rig_pallas.py`: `rig_window_fwd` wraps
`csrc/rig_window_fwd.cu`, the replacement of `_kernel_win`;
`rig_window_bwd` wraps `csrc/rig_window_bwd.cu`, the replacement of
`_bwd_kernel_win_pipe` and `_bwd_kernel_win`; `RigScaleTiles` is the
per-scale autograd function that mirrors `_make_scale_op`
(`rig_pallas.py:802-870`), and `rig_sample_scale_cuda` has the contract of
`rig_sample_scale_pallas` (`:917-988`): one launch per bucket, each writing
its tile range of one shared (N, B, T_total*tile_v, n_out) buffer, then the
plain epilogue (inv_perm gather, bias + ReLU, fp32 camera sum), which
autograd differentiates.

On a CPU tensor a wrapper runs its kernel's plain version
(`ops/rig.window_tiles`, `ops/rig.window_tiles_bwd`); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from vfa_tpu_torch.ops.rig import (
    ScaleRig, collapse_per_layer, pad_features, rig_epilogue, window_tiles,
    window_tiles_bwd,
)


def _check_launch(what, ii, tensors, shapes_ok, C, n_out, K, describe):
    """Shared argument checks of the two kernels' wrappers: one device,
    contiguous, float32 (int32 starts), consistent shapes, and the widths
    the kernels are written for."""
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
                + (" (bf16 is not ported yet)" if want == torch.float32 else "")
                + f", got {t.dtype}")
    if not shapes_ok:
        raise ValueError(f"{what}: inconsistent shapes {describe}")
    if C != 256 or n_out != 256 or K % 16:
        raise ValueError(f"{what}: the kernel takes C = n_out = 256 and "
                         f"wh*ww % 16 == 0, got C {C}, n_out {n_out}, "
                         f"wh*ww {K}")


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
    from vfa_tpu_torch.kernels import LIBRARY, check

    lib = LIBRARY.load("rig_window_fwd")
    # vox scratch between the kernel's two passes (A-product, collapse)
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    with torch.cuda.device(ii.device):
        stream = torch.cuda.current_stream(ii.device).cuda_stream
        err = lib.rig_window_fwd_f32(
            ii.data_ptr(), A_b.data_ptr(), starts_b.data_ptr(), Kr.data_ptr(),
            vox.data_ptr(), out.data_ptr(), N, B, Hp, Wp, C, T, nl, tile_v,
            wh, ww, n_out, off_t, rows, stream)
    check(err, "rig_window_fwd launch")
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
    from vfa_tpu_torch.kernels import LIBRARY, check

    lib = LIBRARY.load("rig_window_bwd")
    # scratch shared by the passes: vox (recomputed), then dvox over it
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    with torch.cuda.device(ii.device):
        stream = torch.cuda.current_stream(ii.device).cuda_stream
        err = lib.rig_window_bwd_f32(
            ii.data_ptr(), A_b.data_ptr(), starts_b.data_ptr(), KrT.data_ptr(),
            g.data_ptr(), vox.data_ptr(), dII.data_ptr(), dKr.data_ptr(),
            N, B, Hp, Wp, C, T, nl, tile_v, wh, ww, n_out, off_t, rows, stream)
    check(err, "rig_window_bwd launch")
    rig_window_bwd.launches += 1
    return dII, dKr


rig_window_bwd.launches = 0


def rig_scale_bwd(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor,
                  g: torch.Tensor):
    """(dII, dKr) of one scale's tiles: one zero-filled dII threaded through
    every bucket's launch, dKr summed over buckets, both fp32."""
    dII = torch.zeros(ii.shape, dtype=torch.float32, device=ii.device)
    dKr = torch.zeros(Kr.shape, dtype=torch.float32, device=ii.device)
    KrT = Kr.transpose(1, 2).contiguous()
    g = g.contiguous()
    off_t = 0
    for A_b, s_b, win in zip(rig.A, rig.starts, rig.window_hw):
        rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off_t,
                       tile_v=rig.tile_v, window=win, KrT=KrT)
        off_t += A_b.shape[1]
    return dII, dKr


class RigScaleTiles(torch.autograd.Function):
    """(ii, Kr) -> the scale's (N, B, T_total*tile_v, n_out) tiles, every
    bucket written in place into one buffer; the backward runs the backward
    kernel bucket by bucket. A and starts are rig structure and get no
    gradient."""

    @staticmethod
    def forward(ctx, ii, Kr, rig: ScaleRig):
        N, B = ii.shape[:2]
        T_total = sum(a.shape[1] for a in rig.A)
        out = torch.empty((N, B, T_total * rig.tile_v, Kr.shape[-1]),
                          dtype=ii.dtype, device=ii.device)
        off_t = 0
        for A_b, s_b, win in zip(rig.A, rig.starts, rig.window_hw):
            rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=off_t,
                           tile_v=rig.tile_v, window=win)
            off_t += A_b.shape[1]
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
    Differentiable in lat and collapse_kernel."""
    ii = pad_features(lat)
    Kr = collapse_per_layer(collapse_kernel, lat.shape[-1], rig.nl, lat.dtype)
    return RigScaleTiles.apply(ii, Kr, rig)


def rig_sample_scale_cuda(lat, rig: ScaleRig, collapse_kernel, collapse_bias,
                          out_dtype=None, camera_sum=False):
    """Same contract as `ops.rig.rig_sample_scale`, through the kernel."""
    out_dtype = out_dtype or lat.dtype
    tiles = rig_tiles_cuda(lat, rig, collapse_kernel)
    return rig_epilogue(tiles, rig.inv_perm, collapse_bias, out_dtype,
                        camera_sum)
