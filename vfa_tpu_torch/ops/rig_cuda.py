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

All four kernels run on one tensor-core tile and stay fp32-accurate
through a 3xTF32 split (`csrc/rig_mma.cuh`; the same arithmetic in plain
PyTorch is `ops/rig.matmul_3xtf32`). Each has a bf16 variant
(`rig_window_fwd_bf16`, `rig_flat_fwd_bf16`, `rig_window_bwd_bf16`,
`rig_flat_bwd_bf16` in the same sources), taken when every floating input
is bfloat16, on the warp-specialised TMA + wgmma tile of `csrc/rig_ws.cuh`:
vox and the tiles are rounded to bf16 where JAX's kernels round them. The
bf16 forwards run once per scale over all its buckets (`rig_fwd_scale`),
the bf16 backwards per bucket: vox, dvox and dKr stay fp32, and the bf16
dII accumulator rounds as `ops/rig._tiles_bwd` says, once per band add or,
on a window bucket that JAX runs serially (`ops/rig.window_bwd_serial`),
once per layer, without atomics in the fixed order of
`ops/rig.window_dii_index` / `flat_dii_index` (`ScaleRig.dii_order`, made
when the rig is built), through an fp32 scratch of each band's gradient,
so its dII has JAX's order and the same bits every run.

Serving on bf16 does without that epilogue: `rig_bev_epilogue` wraps
`csrc/rig_bev_epilogue.cu`, which takes every scale's tiles to the BEV
features in one launch with the epilogue's roundings and saves nothing for
a backward. `rig_bev` chooses between the two routes for a whole rig.

On a CPU tensor a wrapper runs its kernel's plain version
(`ops/rig.window_tiles`, `window_tiles_bwd`, `flat_tiles`,
`flat_tiles_bwd`, `rig_bev_sum`); on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from vfa_tpu_torch import observability
from vfa_tpu_torch.kernels import LaunchCount
from vfa_tpu_torch.ops import needs_grad, rig as trig
from vfa_tpu_torch.ops.rig import (
    ScaleRig, collapse_per_layer, flat_dii_index, flat_tiles, flat_tiles_bwd,
    rig_bev_sum, rig_epilogue, scale_features, window_bwd_serial,
    window_dii_index, window_tiles, window_tiles_bwd,
)


def _check_launch(what, ii, tensors, shapes_ok, C, n_out, K, describe,
                  k_multiple=16):
    """Shared argument checks of the kernels' wrappers: one device,
    contiguous, one floating dtype, float32 or bfloat16, for every tensor
    but the int32 starts and the float32 dKr accumulator of a backward,
    consistent shapes, and the widths the kernels are written for: C =
    n_out = 256 (the width of the tensor-core CTA tile that every pass runs
    on) and a band length K that is a multiple of 16 for a window, of 8 for
    a flat band (both stage slices and mask whole 16-byte quads past a band;
    any nl, tile_v and T go). Returns the floating dtype."""
    if ii.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ii.device}")
    for name, t in tensors.items():
        if t.device != ii.device:
            raise ValueError(f"{what}: {name} on {t.device}, ii on {ii.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if tensors["starts"].dtype != torch.int32:
        raise TypeError(f"{what}: starts must be int32, got "
                        f"{tensors['starts'].dtype}")
    if "dKr" in tensors and tensors["dKr"].dtype != torch.float32:
        raise TypeError(f"{what}: the dKr accumulator must be float32, got "
                        f"{tensors['dKr'].dtype}")
    dtypes = {n: t.dtype for n, t in tensors.items()
              if n not in ("starts", "dKr")}
    got = ", ".join(f"{n} {str(d).split('.')[-1]}" for n, d in dtypes.items())
    dtype = ii.dtype
    if set(dtypes.values()) != {dtype} or dtype not in (torch.float32,
                                                        torch.bfloat16):
        raise TypeError(
            f"{what}: every tensor but starts (and dKr) must be float32 or "
            f"bfloat16, all of one dtype (no mixing), got {got}")
    if not shapes_ok:
        raise ValueError(f"{what}: inconsistent shapes {describe}")
    if C != 256 or n_out != 256 or K % k_multiple:
        raise ValueError(f"{what}: the kernel takes C = n_out = 256 and a "
                         f"band length that is a multiple of {k_multiple}, "
                         f"got C {C}, n_out {n_out}, band length {K}")
    return dtype


# depth chunks of the backward's dKr pass (DKR_MAX_SPLITS in csrc/rig_mma.cuh)
DKR_MAX_SPLITS = 16


def _bwd_scratch(ii, T, R, nl, n_out):
    """Scratch of one backward launch: vox (the recomputed A product, then
    dvox written over it; fp32, or for the bf16 kernels the same bytes as
    two bf16 planes, the hi and lo parts of each fp32 value) and the dKr
    pass's workspace (one partial dKr per depth chunk, added into dKr in a
    fixed order by the pass's second stage)."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    vox = torch.empty((N, B, T, R, C), dtype=torch.float32, device=ii.device)
    ws = torch.empty((DKR_MAX_SPLITS, nl, C, n_out), dtype=torch.float32,
                     device=ii.device)
    return vox, ws


def _launch(name, ii, *args):
    """Launch the variant of kernel library `name` for ii's dtype."""
    from vfa_tpu_torch.kernels import launch

    suffix = "bf16" if ii.dtype == torch.bfloat16 else "f32"
    launch(name, f"{name}_{suffix}", ii.device, *args)


# the bf16 variants launch through the fp32 kernels' wrappers, which count
# fp32 launches in their own `.launches` and bf16 launches here
rig_window_fwd_bf16 = LaunchCount()
rig_flat_fwd_bf16 = LaunchCount()
rig_window_bwd_bf16 = LaunchCount()
rig_flat_bwd_bf16 = LaunchCount()


def _check_window_fwd(ii, A_b, starts_b, Kr, out, off_t, tile_v, window):
    N, B, Hp, Wp, C = ii.shape
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    wh, ww = window
    rows = out.shape[2]
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "out": out}
    return _check_launch(
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


def _fwd_bf16(ii, buckets, Kr, out, tile_v, vox=None):
    """The bf16 forward over `buckets` ((A_b, starts_b, off_t, window or
    None) each, already checked; all window or all flat) in one call: one
    launch of each pass for all of them, into one vox scratch (`vox`, a
    bf16 buffer of at least the launch's elements on ii's device, or one
    made here). Counts one launch of the layout's bf16 forward."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    nl = Kr.shape[0]
    nb = len(buckets)
    flat = buckets[0][3] is None
    what = "rig_flat_fwd" if flat else "rig_window_fwd"
    if not flat and any(win[1] % 16 for _, _, _, win in buckets):
        raise ValueError(f"{what}: the bf16 kernel takes window widths that "
                         "are multiples of 16")
    if nb > MAX_BUCKETS:
        raise ValueError(f"{what}: at most {MAX_BUCKETS} buckets a launch, "
                         f"got {nb}")
    Ts = [A_b.shape[1] for A_b, _, _, _ in buckets]
    need = N * B * sum(Ts) * nl * tile_v * C
    if vox is None:
        vox = torch.empty((need,), dtype=ii.dtype, device=ii.device)
    elif (vox.dtype != ii.dtype or vox.device != ii.device or vox.numel() < need
          or not vox.is_contiguous()):
        raise ValueError(f"{what}: the vox scratch must be a contiguous "
                         f"{ii.dtype} buffer of at least {need} elements on "
                         f"{ii.device}, got {vox.dtype} {vox.numel()} on {vox.device}")
    ptrs = lambda xs: (ctypes.c_void_p * nb)(*xs)
    ints = lambda xs: (ctypes.c_int * nb)(*xs)
    per_bucket = [ptrs([A_b.data_ptr() for A_b, _, _, _ in buckets]),
                  ptrs([s_b.data_ptr() for _, s_b, _, _ in buckets]), ints(Ts),
                  ints([A_b.shape[3] for A_b, _, _, _ in buckets])]
    if not flat:
        per_bucket.append(ints([win[1] for _, _, _, win in buckets]))
    image = [ii.shape[2]] if flat else [ii.shape[2], ii.shape[3]]
    _launch(what, ii, ii.data_ptr(), *per_bucket,
            ints([o for _, _, o, _ in buckets]), nb, Kr.data_ptr(),
            vox.data_ptr(), out.data_ptr(), N, B, *image, C, nl, tile_v,
            Kr.shape[-1], out.shape[2])
    (rig_flat_fwd_bf16 if flat else rig_window_fwd_bf16).launches += 1


# buckets of one bf16 forward launch (MAX_BUCKETS in csrc/rig_ws.cuh)
MAX_BUCKETS = 16


def rig_window_fwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                   Kr: torch.Tensor, out: torch.Tensor, *, off_t: int,
                   tile_v: int, window) -> torch.Tensor:
    """Write one bucket's tiles into `out` rows [off_t*tile_v, (off_t+T)*tile_v).

    ii (N, B, Hp, Wp, C) padded features; A_b (N, T, nl*tile_v, wh*ww);
    starts_b (N, T, 2) int32; Kr (nl, C, n_out); out (N, B, rows, n_out).
    ii, A_b, Kr and out are all float32 or all bfloat16 (the bf16 variant:
    vox and out rounded to bf16 as `window_tiles` rounds them; a scale's
    buckets go in one launch through `rig_fwd_scale`).
    `rig_window_fwd.launches` counts fp32 kernel launches,
    `rig_window_fwd_bf16.launches` bf16 ones."""
    N, B, Hp, Wp, C = ii.shape
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    rows = out.shape[2]
    if ii.device.type == "cpu":
        out[:, :, off_t * tile_v:(off_t + T) * tile_v] = window_tiles(
            ii, A_b, starts_b, Kr, window, tile_v)
        return out
    dtype = _check_window_fwd(ii, A_b, starts_b, Kr, out, off_t, tile_v, window)
    if dtype == torch.bfloat16:
        _fwd_bf16(ii, [(A_b, starts_b, off_t, window)], Kr, out, tile_v)
        return out
    wh, ww = window
    # vox scratch between the kernel's two passes (A-product, collapse)
    vox = torch.empty((N, B, T, R, C), dtype=dtype, device=ii.device)
    _launch("rig_window_fwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), Kr.data_ptr(), vox.data_ptr(), out.data_ptr(),
            N, B, Hp, Wp, C, T, nl, tile_v, wh, ww, n_out, off_t, rows)
    rig_window_fwd.launches += 1
    return out


def rig_fwd_scale(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor,
                  out: torch.Tensor, vox: torch.Tensor = None) -> torch.Tensor:
    """Every bucket of one scale, either layout, into `out` (N, B,
    T_total*tile_v, n_out): on bf16 CUDA tensors one launch of each pass
    for the whole scale (one count in `rig_window_fwd_bf16.launches` or
    `rig_flat_fwd_bf16.launches`; `vox` its scratch, or None for one of
    its own), otherwise `rig_window_fwd` / `rig_flat_fwd` bucket by
    bucket."""
    buckets = list(_buckets(rig))
    if ii.device.type == "cuda" and ii.dtype == torch.bfloat16:
        for A_b, s_b, off_t, win in buckets:
            if win is None:
                _check_flat_fwd(ii, A_b, s_b, Kr, out, off_t, rig.tile_v)
            else:
                _check_window_fwd(ii, A_b, s_b, Kr, out, off_t, rig.tile_v, win)
        _fwd_bf16(ii, buckets, Kr, out, rig.tile_v, vox)
        return out
    for A_b, s_b, off_t, win in buckets:
        if win is None:
            rig_flat_fwd(ii, A_b, s_b, Kr, out, off_t=off_t, tile_v=rig.tile_v)
        else:
            rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=off_t,
                           tile_v=rig.tile_v, window=win)
    return out


rig_window_fwd.launches = 0


def rig_window_bwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                   Kr: torch.Tensor, g: torch.Tensor, dII: torch.Tensor,
                   dKr: torch.Tensor, *, off_t: int, tile_v: int, window,
                   KrT: torch.Tensor = None, dii=None):
    """Add one bucket's gradients into the scale's accumulators.

    ii, A_b, starts_b, Kr as `rig_window_fwd`; g (N, B, rows, n_out) is the
    cotangent of the whole tiles buffer (the bucket reads its rows at
    off_t); dII (N, B, Hp, Wp, C) and dKr (nl, C, n_out) are accumulators
    that are added to in place, dII in ii's dtype, dKr float32. ii, A_b,
    Kr, KrT, g and dII are all float32 or all bfloat16 (the bf16 variant,
    with the rounding points of `ops/rig._tiles_bwd`). KrT is Kr with its
    last two axes swapped, contiguous (made here if not given). dii is the
    bucket's dII order on ii's device (`ScaleRig.dii_order[b]`), which the
    bf16 variant adds in; when not given it is made here from starts, one
    copy to the host. Returns (dII, dKr). `rig_window_bwd.launches` counts
    fp32 kernel launches, `rig_window_bwd_bf16.launches` bf16 ones."""
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
    dtype = _check_launch(
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
    _check_bf16_tile_v("rig_window_bwd", dtype, tile_v)
    vox, ws = _bwd_scratch(ii, T, R, nl, n_out)
    if dtype == torch.bfloat16:
        if ww % 16:
            raise ValueError("rig_window_bwd: the bf16 kernel takes window "
                             f"widths that are multiples of 16, got {ww}")
        if dii is None:
            dii = [torch.from_numpy(a).to(ii.device)
                   for a in window_dii_index(starts_b, window, Hp, Wp)]
        pixels, ptr, adds = dii
        serial = window_bwd_serial(B, K, R, A_b.element_size(),
                                   ii.element_size(), C)
        # each window's fp32 A^T dvox (per layer where serial), added into
        # dII in the index's order by the kernel's last pass
        scratch = torch.empty((N * B * T * (nl if serial else 1) * K * C,),
                              dtype=torch.float32, device=ii.device)
        _launch("rig_window_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
                starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(),
                vox.data_ptr(), ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(),
                scratch.data_ptr(), pixels.data_ptr(), ptr.data_ptr(),
                adds.data_ptr(), pixels.shape[0], int(serial), N, B, Hp, Wp, C,
                T, nl, tile_v, wh, ww, n_out, off_t, rows)
        rig_window_bwd_bf16.launches += 1
        return dII, dKr
    _launch("rig_window_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(), vox.data_ptr(),
            ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(), N, B, Hp, Wp, C, T,
            nl, tile_v, wh, ww, n_out, off_t, rows)
    rig_window_bwd.launches += 1
    return dII, dKr


rig_window_bwd.launches = 0


def _check_flat_fwd(ii, A_b, starts_b, Kr, out, off_t, tile_v):
    N, B, pixels, C = ii.shape
    T, R, band = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    rows = out.shape[2]
    tensors = {"ii": ii, "A": A_b, "starts": starts_b, "Kr": Kr, "out": out}
    return _check_launch(
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


def rig_flat_fwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                 Kr: torch.Tensor, out: torch.Tensor, *, off_t: int,
                 tile_v: int) -> torch.Tensor:
    """Write one flat bucket's tiles into `out` rows
    [off_t*tile_v, (off_t+T)*tile_v).

    ii (N, B, P + max_band, C) padded flat features; A_b
    (N, T, nl*tile_v, band); starts_b (N, T) int32; Kr (nl, C, n_out); out
    (N, B, rows, n_out); all float32 or all bfloat16, as `rig_window_fwd`
    (a scale's bf16 buckets go in one launch through `rig_fwd_scale`).
    `rig_flat_fwd.launches` counts fp32 kernel launches,
    `rig_flat_fwd_bf16.launches` bf16 ones."""
    N, B, pixels, C = ii.shape
    T, R, band = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    rows = out.shape[2]
    if ii.device.type == "cpu":
        out[:, :, off_t * tile_v:(off_t + T) * tile_v] = flat_tiles(
            ii, A_b, starts_b, Kr, tile_v)
        return out
    dtype = _check_flat_fwd(ii, A_b, starts_b, Kr, out, off_t, tile_v)
    if dtype == torch.bfloat16:
        _fwd_bf16(ii, [(A_b, starts_b, off_t, None)], Kr, out, tile_v)
        return out
    vox = torch.empty((N, B, T, R, C), dtype=dtype, device=ii.device)
    _launch("rig_flat_fwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), Kr.data_ptr(), vox.data_ptr(), out.data_ptr(),
            N, B, pixels, C, T, nl, tile_v, band, n_out, off_t, rows)
    rig_flat_fwd.launches += 1
    return out


rig_flat_fwd.launches = 0


def rig_flat_bwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                 Kr: torch.Tensor, g: torch.Tensor, dII: torch.Tensor,
                 dKr: torch.Tensor, *, off_t: int, tile_v: int,
                 KrT: torch.Tensor = None, dii=None):
    """Add one flat bucket's gradients into the scale's accumulators: as
    `rig_window_bwd`, with ii and dII (N, B, P + max_band, C) (dII's last
    max_band rows are padding) and dii the bucket's `flat_dii_index`
    (`ScaleRig.dii_order[b]`; made here from starts when not given).
    `rig_flat_bwd.launches` counts fp32 kernel launches,
    `rig_flat_bwd_bf16.launches` bf16 ones."""
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
    dtype = _check_launch(
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
    _check_bf16_tile_v("rig_flat_bwd", dtype, tile_v)
    vox, ws = _bwd_scratch(ii, T, R, nl, n_out)
    if dtype == torch.bfloat16:
        if dii is None:
            dii = [torch.from_numpy(a).to(ii.device)
                   for a in flat_dii_index(starts_b, band, pixels)]
        index, ptr, adds = dii
        # each band's fp32 A^T dvox, added into dII in the index's order by
        # the kernel's last pass
        scratch = torch.empty((N * B * T * band * C,), dtype=torch.float32,
                              device=ii.device)
        _launch("rig_flat_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
                starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(),
                vox.data_ptr(), ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(),
                scratch.data_ptr(), index.data_ptr(), ptr.data_ptr(),
                adds.data_ptr(), index.shape[0], N, B, pixels, C, T, nl,
                tile_v, band, n_out, off_t, rows)
        rig_flat_bwd_bf16.launches += 1
        return dII, dKr
    _launch("rig_flat_bwd", ii, ii.data_ptr(), A_b.data_ptr(),
            starts_b.data_ptr(), KrT.data_ptr(), g.data_ptr(), vox.data_ptr(),
            ws.data_ptr(), dII.data_ptr(), dKr.data_ptr(), N, B, pixels, C, T,
            nl, tile_v, band, n_out, off_t, rows)
    rig_flat_bwd.launches += 1
    return dII, dKr


rig_flat_bwd.launches = 0


def _check_bf16_tile_v(what, dtype, tile_v):
    """The bf16 backward keeps vox channel-major, a tile's tile_v cells
    in 16-byte rows: tile_v must be a multiple of 8 (JAX's bf16 tile_v 160
    and 64 are)."""
    if dtype == torch.bfloat16 and tile_v % 8:
        raise ValueError(f"{what}: the bf16 kernel takes a tile_v that is a "
                         f"multiple of 8, got {tile_v}")


def _buckets(rig: ScaleRig):
    """(A_b, starts_b, off_t, window or None) of every bucket of a scale."""
    off_t = 0
    for bi, (A_b, s_b) in enumerate(zip(rig.A, rig.starts)):
        yield A_b, s_b, off_t, rig.window_hw[bi] if rig.window_hw else None
        off_t += A_b.shape[1]


def rig_scale_bwd(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor,
                  g: torch.Tensor):
    """(dII, dKr) of one scale's tiles, as `_make_scale_op`'s VJP
    (`vfa_tpu/ops/rig_pallas.py:846-867`) returns them: one zero-filled dII
    in ii's dtype threaded through every bucket's launch, dKr summed over
    buckets in fp32 and returned in Kr's dtype."""
    dII = torch.zeros_like(ii)
    dKr = torch.zeros(Kr.shape, dtype=torch.float32, device=ii.device)
    KrT = Kr.transpose(1, 2).contiguous()
    g = g.contiguous()
    for bi, (A_b, s_b, off_t, win) in enumerate(_buckets(rig)):
        dii = rig.dii_order[bi] if rig.dii_order else None
        if win is None:
            rig_flat_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off_t,
                         tile_v=rig.tile_v, KrT=KrT, dii=dii)
        else:
            rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off_t,
                           tile_v=rig.tile_v, window=win, KrT=KrT, dii=dii)
    return dII, dKr.to(Kr.dtype)


def _rows(rig: ScaleRig) -> int:
    return sum(a.shape[1] for a in rig.A) * rig.tile_v


def scale_tiles_cuda(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor,
                     vox: torch.Tensor = None) -> torch.Tensor:
    """`ops.rig.scale_tiles` by `rig_fwd_scale` (vox: its bf16 scratch, or
    None), in the `sampling.kernel` span; no autograd."""
    out = torch.empty((*ii.shape[:2], _rows(rig), Kr.shape[-1]), dtype=ii.dtype,
                      device=ii.device)
    with observability.span("sampling.kernel"):
        return rig_fwd_scale(ii, rig, Kr, out, vox)


class RigScaleTiles(torch.autograd.Function):
    """(ii, Kr) -> the scale's (N, B, T_total*tile_v, n_out) tiles, every
    bucket written in place into one buffer; the backward runs the backward
    kernel bucket by bucket. ii is the scale's padded features in the rig's
    layout (`ops.rig.scale_features`). A and starts are rig structure and
    get no gradient."""

    @staticmethod
    def forward(ctx, ii, Kr, rig: ScaleRig):
        out = scale_tiles_cuda(ii, rig, Kr)
        ctx.save_for_backward(ii, Kr)
        ctx.rig = rig
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ii, Kr = ctx.saved_tensors
        dII, dKr = rig_scale_bwd(ii, ctx.rig, Kr, g)
        return dII, dKr, None


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


def rig_bev(lats, scales, kernels, biases, out_dtype) -> torch.Tensor:
    """`ops.rig.rig_bev` through the kernels: for bf16 lats and out with no
    gradient needed, every scale's tiles, then one `rig_bev_epilogue` (the
    chain's bits); otherwise the chain of `rig_sample_scale_cuda`."""
    lat0 = lats[0]
    if (lat0.dtype != torch.bfloat16 or out_dtype != torch.bfloat16
            or needs_grad(*lats, *kernels, *biases)):
        return trig.rig_bev(lats, scales, kernels, biases, out_dtype,
                            sample=rig_sample_scale_cuda)
    B, N, C = lat0.shape[0], lat0.shape[1], lat0.shape[-1]
    vox = None
    if lat0.device.type == "cuda":
        # One vox scratch for every scale (at Wildtrack batch 32, 37 GiB),
        # made before the tiles: per-scale scratches, each freed while the
        # tiles stay alive, let the caching allocator place the next tiles
        # in the freed block and find no room for the next scratch.
        vox = torch.empty((max(N * B * _rows(sr) * sr.nl * C for sr in scales),),
                          dtype=lat0.dtype, device=lat0.device)
    tiles = [scale_tiles_cuda(scale_features(lat, sr), sr,
                              collapse_per_layer(k, C, sr.nl, lat.dtype), vox)
             for lat, sr, k in zip(lats, scales, kernels)]
    with observability.span("sampling.epilogue"):
        return rig_bev_epilogue(tiles, [sr.inv_perm for sr in scales], biases)


def rig_bev_epilogue(tiles, inv_perms, biases) -> torch.Tensor:
    """Every scale's tiles (N, B, rows_s, 256), as `rig_tiles_cuda` returns
    them, with its inv_perm (N, V2d) int64 and collapse bias (256) -> the
    BEV features (B, V2d, 256) in the tiles' dtype: `ops/rig.rig_bev_sum`.
    On bf16 CUDA tensors one launch of `csrc/rig_bev_epilogue.cu` for all
    scales (counted in `rig_bev_epilogue.launches`); on CPU tensors the
    plain version; nothing else is taken. No autograd: serving only."""
    t0 = tiles[0]
    biases = [b.to(t0.dtype) for b in biases]
    if t0.device.type == "cpu":
        return rig_bev_sum(tiles, inv_perms, biases)
    what = "rig_bev_epilogue"
    if t0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t0.device}")
    if t0.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes bfloat16 tiles, got {t0.dtype}")
    N, B, _, n_out = t0.shape
    V2d = inv_perms[0].shape[1]
    S = len(tiles)
    if not (1 <= S <= 3 and len(inv_perms) == S and len(biases) == S):
        raise ValueError(f"{what}: 1 to 3 scales, each with its tiles, inv_perm "
                         f"and bias, got {len(tiles)}, {len(inv_perms)}, {len(biases)}")
    if n_out != 256 or not 1 <= N <= 32:
        raise ValueError(f"{what}: the kernel takes 256 channels and 1 to 32 "
                         f"cameras, got {n_out} and {N}")
    for t, ip, b in zip(tiles, inv_perms, biases):
        if (t.dtype != torch.bfloat16 or ip.dtype != torch.int64
                or t.shape[:2] != (N, B) or t.shape[3] != 256 or t.shape[2] < 1
                or tuple(ip.shape) != (N, V2d) or tuple(b.shape) != (256,)):
            raise ValueError(f"{what}: inconsistent scale: tiles {t.dtype} "
                             f"{tuple(t.shape)}, inv_perm {ip.dtype} "
                             f"{tuple(ip.shape)}, bias {tuple(b.shape)}")
        for name, x in (("tiles", t), ("inv_perm", ip), ("bias", b)):
            if x.device != t0.device:
                raise ValueError(f"{what}: {name} on {x.device}, tiles on {t0.device}")
            if not x.is_contiguous() or x.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be contiguous and "
                                 "16-byte aligned")
    out = torch.empty((B, V2d, 256), dtype=torch.bfloat16, device=t0.device)
    ptrs = lambda xs: (ctypes.c_void_p * S)(*[x.data_ptr() for x in xs])
    rows = (ctypes.c_longlong * S)(*[t.shape[2] for t in tiles])
    from vfa_tpu_torch.kernels import launch

    launch(what, "rig_bev_epilogue_bf16", t0.device, ptrs(tiles), ptrs(inv_perms),
           ptrs(biases), rows, S, out.data_ptr(), N, B, V2d)
    rig_bev_epilogue.launches += 1
    return out


rig_bev_epilogue.launches = 0
