"""The voxel-route training step at batch 1 (rig=None, full MultiviewC)
run twice from the same seeded weights and batch, on one card: whether the
losses are equal, and which parameters' gradients differ between the two
runs (the largest difference beside the gradient's max).

    python tools/voxel_step_twice.py <checkout> <float32|bfloat16> [--cudnn_deterministic]

`<checkout>` is a checkout of the repository whose port is run (e.g. the
parent commit unpacked under the git-ignored experiments/).
`--cudnn_deterministic` sets `torch.backends.cudnn.deterministic`, which
keeps cuDNN off the convolution backward algorithms that add with atomics.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("dtype", choices=["float32", "bfloat16"])
    ap.add_argument("--cudnn_deterministic", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    from vfa_tpu_torch import bench
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.train_lib import make_optimizer, make_train_step

    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cfg = get_config("MultiviewC")
    batch = bench.make_inputs(cfg, 1, device, True, getattr(torch, args.dtype))
    runs = []
    for _ in range(2):
        model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(device)
        tcfg = TrainConfig(pretrained=False, compute_dtype=args.dtype)
        step = make_train_step(model, make_optimizer(model, tcfg, bench.STEPS_PER_EPOCH),
                               cfg, tcfg, dim_mean=bench.DIM_MEAN)
        losses = {k: float(v) for k, v in step(batch, None).items()}
        runs.append((losses, {n: p.grad.detach().clone()
                              for n, p in model.named_parameters() if p.grad is not None}))
        del model, step
    (l0, g0), (l1, g1) = runs
    bad = [(n, float((g0[n] - g1[n]).abs().max()), float(g0[n].abs().max()))
           for n in g0 if not torch.equal(g0[n], g1[n])]
    print(f"{args.root} {args.dtype} cudnn.deterministic={args.cudnn_deterministic}: "
          f"losses equal {l0 == l1}; {len(bad)} of {len(g0)} gradients differ "
          f"(name, max |difference|, max |gradient|): {bad[:8]}", flush=True)


if __name__ == "__main__":
    main()
