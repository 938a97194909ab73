"""The voxel route's backward against JAX's, bit for bit, on the CPU.

`sample_voxels` reads the integral image at four corners through
`grid_sample_bilinear`; JAX's transpose of each tap's `jnp.take` is one
scatter-add, the 16 of them joined in one chain in the reverse of their use
(`vfa_tpu_torch/ops/voxel.py`, the notes above CHAIN_LENGTH). The port
replays that order (`CornerTaps`, `tap_order`, `corner_taps_bwd`, on a card
the kernel `csrc/voxel_tap_bwd.cu`, held to `corner_taps_bwd` by
tests/test_torch_kernels_gpu.py), then scans back as XLA does
(`IntegralImage.backward`). Before, torch.gather's backward added the
updates in torch's order: on bf16 2.8 % of the feature gradient's elements
equalled JAX's at the tiny MultiviewC boxes (rel-L2 0.357), 32 % on the
full ones over (32, 90, 160) (rel-L2 0.903; tests/voxel_order_report.py).

JAX is run op by op (`jax.vjp` outside `jit`), as the forward's tests run
it: under `jit` XLA contracts the tap coordinates into fused multiply-adds
and, on fp32, scatters every other tap into the running sum, which moves
JAX's own gradient from its op-by-op one (3.7e-3 rel-L2 on bf16, 4.3e-5
on fp32, on the full MultiviewC boxes; tests/voxel_order_report.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import mc_opts, mx_opts, wt_opts
from vfa_tpu.ops import voxel as jvox

from vfa_tpu_torch.geometry import bilinear_taps
from vfa_tpu_torch.ops import voxel as tvox

from test_torch_voxel_bf16 import _bits, _geometry

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (config, tiny, channels, scenes): Wildtrack as two scenes in one call, the
# leading dim the model gives (JAX's vmap), each scene's scatters its own
CASES = [(mc_opts, True, 4, 0), (mx_opts, True, 4, 0), (wt_opts, True, 4, 2),
         (mc_opts, False, 8, 0)]
IDS = ["MultiviewC", "MultiviewX", "Wildtrack-2-scenes", "MultiviewC-full"]
DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)]


def _inputs(cfg, tiny, C, scenes=0, seed=0):
    """One camera's boxes (the full MultiviewC boxes (5, 156, 156) over a
    narrow (8, 90, 160) map, where a pixel takes up to 164 updates from one
    tap), features and the cotangent of vox, as numpy; with `scenes`
    a leading dim of that many (the boxes flipped in L from one to the
    next)."""
    tc, boxes = _geometry(cfg, tiny)
    fh, fw = tc.resize_size[0] // 8, tc.resize_size[1] // 8
    nl, L, W = boxes.shape[:3]
    lead = (scenes,) if scenes else ()
    if scenes:
        boxes = np.stack([boxes if s % 2 == 0 else boxes[:, ::-1] for s in range(scenes)])
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, C, fh, fw)).astype(np.float32)
    g = rng.normal(size=(*lead, L, W, C * nl)).astype(np.float32)
    return boxes, x, g


def _vjps(x, boxes, g, tdt, jdt):
    """(port, JAX) gradients of `sample_voxels` w.r.t. the features; JAX's
    vmapped over a leading dim of the boxes."""
    fn = jvox.sample_voxels if boxes.ndim == 4 else jax.vmap(jvox.sample_voxels)
    jf = jnp.asarray(x).astype(jdt)
    _, vjp = jax.vjp(lambda f: fn(f, jnp.asarray(boxes)), jf)
    want = _bits(vjp(jnp.asarray(g))[0])
    tf = _bits(jf).requires_grad_()
    (got,) = torch.autograd.grad(tvox.sample_voxels(tf, torch.from_numpy(boxes)), tf,
                                 torch.from_numpy(g))
    return got, want


@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("cfg,tiny,C,scenes", CASES, ids=IDS)
def test_sample_voxels_vjp_matches_jax(cfg, tiny, C, scenes, tdt, jdt):
    """(a) bf16 and (b) fp32: the gradient w.r.t. the features equals
    `jax.vjp` of JAX's op bit for bit, one code path for both dtypes."""
    boxes, x, g = _inputs(cfg, tiny, C, scenes)
    got, want = _vjps(x, boxes, g, tdt, jdt)
    assert got.dtype == tdt and got.shape == want.shape
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0


def _naive(boxes, g, H, W, dtype):
    """The transpose of the corner reads, one update at a time, in XLA's
    order: per tap of lb, rt, rb, lt (each corner's taps last used first) a
    scatter from 0 over the points in order, the update rnd(g * w) times the
    in-image mask, each add rounded to `dtype`; the 16 sums joined in that
    order. boxes (B, nl, L, W, 4), g (4, B, P, C) fp32 (lt, rb, rt, lb)."""
    B, C = boxes.shape[0], g.shape[-1]
    out = torch.zeros((B, H * W, C), dtype=dtype)
    for b in range(B):
        coords = tvox.corner_coords(boxes[b].reshape(-1, 4))
        taps = [bilinear_taps(c, H, W) for c in coords]
        total = None
        for corner in (3, 2, 1, 0):
            for idx, inb, w in taps[corner][::-1]:
                s = torch.zeros((H * W, C), dtype=dtype)
                for p in range(idx.shape[0]):
                    u = (g[corner, b, p] * w[p]).to(dtype) * inb[p].to(dtype)
                    s[idx[p]] = s[idx[p]] + u
                total = s if total is None else total + s
        out[b] = total
    return out.transpose(1, 2).reshape(B, C, H, W)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_corner_taps_bwd_equals_a_loop_over_updates(dtype):
    """(c) The plain ordered transpose (`tap_order` + `corner_taps_bwd`,
    every pixel's k-th update in one tensor add) equals a Python loop over
    the updates in XLA's order, on 2 scenes of boxes that leave the image
    (out-of-image taps), with large cotangents whose rounding shows."""
    H, W, C = 5, 7, 3
    gen = torch.Generator().manual_seed(3)
    lt = torch.rand((2, 2, 3, 4, 2), generator=gen) * 2.2 - 1.2
    boxes = torch.cat([lt, lt + torch.rand((2, 2, 3, 4, 2), generator=gen) * 0.8], -1)
    g = torch.randn((4, 2, 24, C), generator=gen) * torch.exp(
        torch.randn((4, 2, 24, C), generator=gen) * 3)
    order = tvox.tap_order(boxes, (H, W))
    got = tvox.corner_taps_bwd(g.reshape(-1, C), order, (2, C, H, W), dtype)
    want = _naive(boxes, g, H, W, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    # the order matters at these magnitudes: torch's index_add_ differs
    flat = torch.zeros((2 * H * W, C), dtype=torch.float64)
    for corner, coords in enumerate(tvox.corner_coords(boxes.reshape(2, -1, 4))):
        for idx, inb, w in bilinear_taps(coords, H, W):
            rows = (torch.arange(2)[:, None] * H * W + idx).reshape(-1)
            flat.index_add_(0, rows, (g[corner] * (w * inb)[..., None]).reshape(-1, C).double())
    exact = flat.reshape(2, H * W, C).transpose(1, 2).reshape(2, C, H, W)
    assert not torch.equal(got, exact.to(dtype))


@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["bf16", "fp32"])
def test_gathers_transpose_alone_matches_jax(monkeypatch, tdt, jdt):
    """(d) With the integral image replaced by the identity on both sides,
    the corner reads' transpose alone equals JAX's bit for bit: the scatter
    pinned apart from the scan."""
    identity = lambda f: f
    monkeypatch.setattr(jvox, "integral_image", identity)
    monkeypatch.setattr(tvox, "integral_image", identity)
    boxes, x, g = _inputs(mc_opts, True, 4, seed=2)
    got, want = _vjps(x, boxes, g, tdt, jdt)
    assert torch.equal(got, want)
