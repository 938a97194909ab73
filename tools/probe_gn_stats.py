"""Which statistics `torch.native_group_norm` normalises with, per device
and dtype: for each shape, z as the forward returns it against z
recomputed as the fused stem's backward recomputes it (a = rstd*scale,
b = fma(-a, mean, bias), z = fma(a, x, b), then rounded to x's dtype),
once from the statistics the call returns and once from the fp32
statistics of the same values. Prints the mismatching elements of each
(`ops/stem.group_norm_stats` hands the backward the set that matches).

    python tools/probe_gn_stats.py            # on the GPU
    python tools/probe_gn_stats.py --device cpu
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfa_tpu_torch.ops import stem  # noqa: E402


def recompute(x, mu, rstd, scale, bias):
    return stem.recompute_z(x, stem.plane_params(mu, rstd, scale, bias))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shapes = [(2, 64, 12, 16)]
    if args.device != "cpu":
        shapes.append((14, 64, 360, 640))   # the stem at MultiviewC batch 2
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            g = torch.Generator().manual_seed(0)
            x = torch.randn(shape, generator=g).to(args.device, dtype)
            s = (torch.rand(shape[1], generator=g) + 0.5).to(args.device, dtype)
            b = (torch.rand(shape[1], generator=g) - 0.5).to(args.device, dtype)
            M, C, H, W = shape
            z, mu, rstd = torch.native_group_norm(x, s, b, M, C, H * W, 16, 1e-5)
            _, mu32, rstd32 = torch.native_group_norm(
                x.float(), s.float(), b.float(), M, C, H * W, 16, 1e-5)
            n = z.numel()
            own = int((recompute(x, mu, rstd, s, b) != z).sum())
            f32 = int((recompute(x, mu32, rstd32, s, b) != z).sum())
            print(f"{args.device} {str(dtype).split('.')[-1]} {shape}: stats "
                  f"returned in {str(mu.dtype).split('.')[-1]}; z recomputed "
                  f"from them differs at {own} of {n}, from the fp32 "
                  f"statistics at {f32} of {n}")


if __name__ == "__main__":
    main()
