"""How far the port's voxel-route gradient lies from JAX's, on the CPU.

    python tests/voxel_order_report.py [--step]

For bf16 and fp32 features, the gradient of `sample_voxels` w.r.t. the
features (the share of elements equal to JAX's and the rel-L2 distance),
through the port's ordered transpose (`ops/voxel.py::CornerTaps`) and
through the route it replaced (autograd of four `grid_sample_bilinear`
calls: torch.gather's backward, and `torch.cumsum`'s backward on fp32),
against `jax.vjp` run op by op and against JAX's jitted VJP. Two shapes:
the tiny MultiviewC boxes (5, 9, 9) over (4, 11, 20), and the full
MultiviewC boxes (5, 156, 156) over (32, 90, 160), the scale-8 map of one
camera with 32 channels. `--step` adds the mixed-precision train step with
rig=None of tests/test_torch_voxel_bf16.py (both routes): the distance of
the port's bf16 update from JAX's beside both sides' bf16-vs-fp32
distances. A script beside the tests: it imports JAX and the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfa_tpu.config import mc_opts  # noqa: E402
from vfa_tpu.ops import voxel as jvox  # noqa: E402
from vfa_tpu_torch.geometry import grid_sample_bilinear  # noqa: E402
from vfa_tpu_torch.ops import voxel as tvox  # noqa: E402

from test_torch_voxel_bf16 import _bits, _geometry  # noqa: E402


class _GatherTaps:
    """The corner reads as before the ordered transpose: autograd of
    `grid_sample_bilinear` (torch.gather's backward)."""

    @staticmethod
    def apply(ii, boxes):
        return tuple(grid_sample_bilinear(ii, c) for c in tvox.corner_coords(boxes))


class _CumsumII:
    """The integral image as before: JAX's blocked scan on bf16 (forward and
    backward), `torch.cumsum` and its autograd on fp32."""

    ordered = tvox.IntegralImage

    @staticmethod
    def apply(feature):
        if feature.dtype == torch.bfloat16:
            return _CumsumII.ordered.apply(feature)
        return torch.cumsum(torch.cumsum(feature, dim=-1), dim=-2)


@contextlib.contextmanager
def route(name):
    """'ordered' (the port's) or 'gather' (the route before it)."""
    if name == "ordered":
        yield
        return
    saved = tvox.CornerTaps, tvox.IntegralImage
    tvox.CornerTaps, tvox.IntegralImage = _GatherTaps, _CumsumII
    try:
        yield
    finally:
        tvox.CornerTaps, tvox.IntegralImage = saved


def distance(got, want):
    """(share of elements equal, rel-L2) in float64."""
    d = torch.linalg.vector_norm(got.double() - want.double())
    return (float((got == want).double().mean()),
            float(d / torch.linalg.vector_norm(want.double())))


def op_level(C, tiny):
    tc, boxes = _geometry(mc_opts, tiny)
    fh, fw = tc.resize_size[0] // 8, tc.resize_size[1] // 8
    nl, L, W = boxes.shape[:3]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(C, fh, fw)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(L, W, C * nl)).astype(np.float32))
    jb = jnp.asarray(boxes)
    jitted = jax.jit(lambda f, b, g: jax.vjp(lambda x: jvox.sample_voxels(x, b), f)[1](g)[0])
    grads = {}
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jf = jnp.asarray(x).astype(jdt)
        _, vjp = jax.vjp(lambda f: jvox.sample_voxels(f, jb), jf)
        want, want_jit = _bits(vjp(g)[0]), _bits(jitted(jf, jb, g))
        tag = f"({C}, {fh}, {fw}) under {tuple(boxes.shape[:3])} boxes, {tdt}"
        print(f"{tag}: JAX jitted vs op by op: equal {distance(want_jit, want)[0]:.4f}, "
              f"rel-L2 {distance(want_jit, want)[1]:.3e}")
        for name in ("gather", "ordered"):
            tf = _bits(jf).requires_grad_()
            with route(name):
                (got,) = torch.autograd.grad(
                    tvox.sample_voxels(tf, torch.from_numpy(boxes)), tf,
                    torch.from_numpy(np.asarray(g)))
            grads[name, tdt] = got
            eq, rel = distance(got, want)
            eqj, relj = distance(got, want_jit)
            print(f"  port ({name}) vs JAX op by op: equal {eq:.4f}, rel-L2 {rel:.3e}; "
                  f"vs JAX jitted: equal {eqj:.4f}, rel-L2 {relj:.3e}")
    for name in ("gather", "ordered"):
        print(f"  port ({name}) bf16 vs fp32: rel-L2 "
              f"{distance(grads[name, torch.bfloat16], grads[name, torch.float32])[1]:.3e}")


def step(name):
    from test_torch_bf16_train import ZERO_GRAD, _train_against_jax
    from test_torch_voxel_bf16 import port_weights_for_jax

    init = lambda m: types.SimpleNamespace(
        init=lambda key, *args, train: port_weights_for_jax(m, *args))
    with route(name):
        records, _, evals = _train_against_jax(1, layout=None, jax_fp32=True,
                                               jax_init=init)
    ((_, _, t, j, t32, j32),) = records
    l2 = lambda a: float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in a)))
    keys = [k for k in j if k not in ZERO_GRAD]
    noise = lambda ks: np.hypot(l2([t[k] - t32[k] for k in ks]),
                                l2([j[k] - j32[k] for k in ks]))
    print(f"step ({name}): |JAX bf16 update| {l2([j[k] for k in keys]):.4e}; port bf16 vs "
          f"JAX bf16 {l2([t[k] - j[k] for k in keys]):.4e}; port bf16 vs fp32 "
          f"{l2([t[k] - t32[k] for k in keys]):.4e}; JAX bf16 vs fp32 "
          f"{l2([j[k] - j32[k] for k in keys]):.4e}; port fp32 vs JAX fp32 "
          f"{l2([t32[k] - j32[k] for k in keys]):.4e}; "
          f"ratio to the noise {l2([t[k] - j[k] for k in keys]) / noise(keys):.3f}")
    worst = max((l2([t[k] - j[k]]) / noise([k]), k) for k in keys
                if k.split(".")[0] in ("base", "lat8", "lat16", "lat32", "bn8", "bn16", "bn32"))
    rest = max((l2([t[k] - j[k]]) / l2([j[k]]), k) for k in keys
               if k.split(".")[0] not in ("base", "lat8", "lat16", "lat32", "bn8", "bn16", "bn32"))
    print(f"  worst backbone/lateral parameter: {worst[0]:.3f} of its noise ({worst[1]}); "
          f"worst other parameter: {rest[0]:.3f} of JAX's update ({rest[1]})")
    te, je, t32e, j32e = evals
    for k in je:
        print(f"  eval {k}: port {te[k]:.6f}, JAX {je[k]:.6f}, |diff| "
              f"{abs(te[k] - je[k]):.3e}, both sides' bf16-vs-fp32 hypot "
              f"{np.hypot(te[k] - t32e[k], je[k] - j32e[k]):.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", action="store_true",
                    help="also the mixed-precision train step with rig=None")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    op_level(4, tiny=True)
    op_level(32, tiny=False)
    if args.step:
        for name in ("gather", "ordered"):
            step(name)


if __name__ == "__main__":
    main()
