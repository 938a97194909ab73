"""Which statistics and which formula `torch.native_group_norm` normalises
with, per device and dtype: for each shape, z as the forward returns it
against z recomputed as the fused stem's backward recomputes it
(`ops/stem.recompute_z`: a = rstd*scale, b = -a*mean + bias, z = fma(a, x,
b), then rounded to x's dtype), once from the statistics the call returns and once from the fp32
statistics of the same values. Prints the mismatching elements of each
(`ops/stem.group_norm_stats` hands the backward the set that matches).

With `--candidates` it also counts, on fp32, the mismatches of other ways
to round the same expression (a product and an add in place of a fused
multiply-add for b or z, the normalised form (x - mean) * rstd * scale +
bias), the planes they fall in and their largest distance in ulps: the
one with no mismatch is the one `ops/stem.recompute_z` and the fp32 stem
kernels take on the device.

    python tools/probe_gn_stats.py [--candidates]      # on the GPU
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


def candidates(x, mu, rstd, s, b):
    """fp32 z by several roundings of the GroupNorm expression, (M, C, H,
    W) each; mu, rstd (M, G)."""
    M, C = x.shape[:2]
    G = mu.shape[1]
    per = lambda t: t.float().repeat_interleave(C // G, 1)[:, :, None, None]
    m, r = per(mu), per(rstd)
    sc, bi = s.float()[None, :, None, None], b.float()[None, :, None, None]
    a = r * sc
    b_fma = stem._fma(-a, m, bi)
    b_two = (-a * m) + bi
    return {
        "a=r*s, b=fma(-a,m,bias), z=fma(a,x,b)": stem._fma(a, x, b_fma),
        "b=(-a*m)+bias, z=fma(a,x,b)": stem._fma(a, x, b_two),
        "b=fma(-a,m,bias), z=(a*x)+b": a * x + b_fma,
        "b=(-a*m)+bias, z=(a*x)+b": a * x + b_two,
        "z=fma((x-m)*r, s, bias)": stem._fma((x - m) * r, sc, bi),
        "z=((x-m)*r)*s+bias": ((x - m) * r) * sc + bi,
        "z=fma(x-m, a, bias)": stem._fma(x - m, a, bi),
        "z=(x-m)*a+bias": (x - m) * a + bi,
    }


def ulps(u, v):
    iu = u.contiguous().view(torch.int32).long()
    iv = v.contiguous().view(torch.int32).long()
    return (iu - iv).abs()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--candidates", action="store_true")
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
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
            if not args.candidates or dtype != torch.float32:
                continue
            for name, zc in candidates(x, mu, rstd, s, b).items():
                bad = zc != z
                planes = int(bad.flatten(2).any(2).sum())
                far = int(ulps(zc, z).max())
                print(f"  {name}: {int(bad.sum())} of {n} differ, in "
                      f"{planes} of {M * C} planes, at most {far} ulp")
            del x, z


if __name__ == "__main__":
    main()
