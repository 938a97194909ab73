"""Evaluation CLI of the port (mirrors the root `evaluate.py`): run the
model over the validation split, write the four detection / gt txt
artifacts (PR format `frame x y`; APAOS format `frame x y z l w h rot
conf`), then compute MODA / MODP / precision / recall and, in 3D mode,
AP / AOS / OS.

    python -m vfa_tpu_torch.evaluate --data MultiviewC --root data/MultiviewC --checkpoint <run>/checkpoints/epoch_0040
    python -m vfa_tpu_torch.evaluate --data MultiviewC --torch_checkpoint reference.pth --dtype bfloat16
    python -m vfa_tpu_torch.evaluate --data MultiviewC --synthetic --tiny --device cpu

Each batch is decoded on the device in one call (`codec.decode_frame`
over the whole batch, top-k ties in index order as JAX's), where the JAX
CLI decodes scene by scene; the rows are the same. The on-disk loader
stages uint8 batches, normalized on the device to the float loader's
pixels. The IoU of the AP / AOS sweep runs on `--device` too, the CLEAR
matching on the host (`native.matcher_backend()` prints which matcher).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from vfa_tpu_torch.rig_cli import add_rig_layout_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   choices=["MultiviewC", "MultiviewX", "Wildtrack"])
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory written by the train CLI "
                        "(<run>/checkpoints/epoch_NNNN)")
    p.add_argument("--torch_checkpoint", type=str, default=None,
                   help="reference .pth checkpoint to evaluate")
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--cls_thresh", type=float, default=0.7)
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--td", type=float, default=None,
                   help="MODA distance threshold; default is the backend's "
                        "own (30 for python/pyeval, 78 for matlab)")
    p.add_argument("--eval_tool", type=str, default="python",
                   choices=["python", "matlab"],
                   help="metric semantics to mirror (both run in-process; "
                        "'matlab' = the official devkit's td=78 behavior)")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_frames", type=int, default=8)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype; bfloat16 serves as the predict CLI "
                        "does (model, images and rig in bf16, fp32 decode)")
    p.add_argument("--no_rig", action="store_true",
                   help="sample through the reference voxel route from the "
                        "calibrations instead of a compiled rig")
    p.add_argument("--rig_buckets", type=int, default=None,
                   help="max window buckets of the rig (default: the "
                        "inference policy of rig_cli, 12)")
    p.add_argument("--rig_impl", default="cuda", choices=["cuda", "plain"],
                   help="cuda: the hand-written rig kernels; plain: their "
                        "plain PyTorch versions")
    add_rig_layout_arg(p)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def scene_rows(frame_id: int, dets, gts, mode: str):
    """The four artifacts' rows of one scene, as the JAX CLI's per-scene
    loop writes them (`evaluate.py:160-175`): (pr_pred, pr_gt, ap_pred,
    ap_gt), dimensions turned from (h, w, l) to (l, w, h)."""
    pr_pred, pr_gt, ap_pred, ap_gt = [], [], [], []
    for o in dets:
        loc = np.asarray(o.location)
        pr_pred.append([frame_id, loc[0], loc[1]])
        if mode == "3D":
            dim = np.asarray(o.dimension)[::-1]
            ap_pred.append([frame_id, *loc, *dim, float(o.rotation), float(o.conf)])
    for o in gts:
        loc = np.asarray(o.location)
        pr_gt.append([frame_id, loc[0], loc[1]])
        if mode == "3D":
            dim = np.asarray(o.dimension)[::-1]
            ap_gt.append([frame_id, *loc[:3], *dim, float(o.rotation)])
    return pr_pred, pr_gt, ap_pred, ap_gt


def main(argv=None, rig=None) -> dict:
    """Run the CLI; returns the artifact paths and the metrics. `rig` is
    an already built CameraRig for this configuration (built here when
    None)."""
    args = parse_args(argv)
    from vfa_tpu_torch.codec import ObjectEncoder
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.eval.evaluate import (
        evaluate_ap_aos, evaluate_rcll_prec_moda_modp,
    )
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
    from vfa_tpu_torch.native import matcher_backend
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig
    from vfa_tpu_torch.train_lib import batch_to_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    cfg = get_config(args.data)
    if args.root:
        cfg = dataclasses.replace(cfg, root=args.root)
    if args.tiny:
        cfg = tiny_config(cfg)
    dtype = getattr(torch, args.dtype)

    # ------------------------------------------------------------ data ----
    if args.synthetic:
        from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader

        loader = SyntheticSceneLoader(cfg, num_frames=args.synthetic_frames,
                                      batch_size=args.batch_size, seed=123)
        dim_mean = loader.dim_mean
        calibs = loader.scenes[0].calibs
    else:
        from vfa_tpu_torch.data.adapters import ADAPTERS
        from vfa_tpu_torch.data.frame_dataset import FrameDataset, SceneLoader
        from vfa_tpu_torch.native.imageio import decoder_backend

        base = ADAPTERS[cfg.name](cfg.root, world_size=cfg.world_size,
                                  cube_LWH=cfg.cube_size)
        ds = FrameDataset(base, cfg, split="val")
        loader = SceneLoader(ds, batch_size=args.batch_size, shuffle=False,
                             images_dtype=np.uint8)
        dim_mean = ds.dim_mean
        calibs = ds.calibs
        print(f"dataset {cfg.name} at {cfg.root}: {len(ds)} val frames; "
              f"decoder {decoder_backend()}")

    # ----------------------------------------------------------- model ----
    model = init_weights(VFANet(cfg, rig_impl=args.rig_impl),
                         torch.Generator().manual_seed(0))
    if args.checkpoint:
        from vfa_tpu_torch.checkpoint import load_meta, restore_checkpoint

        restore_checkpoint(args.checkpoint, model)
        _, _, _, extra = load_meta(args.checkpoint)
        if extra.get("dim_mean"):
            dim_mean = np.asarray(extra["dim_mean"], np.float32)
        print(f"restored {args.checkpoint}")
    elif args.torch_checkpoint:
        from vfa_tpu_torch.convert import load_reference_checkpoint

        load_reference_checkpoint(args.torch_checkpoint, model)
        print(f"converted reference checkpoint {args.torch_checkpoint}")
    else:
        print("WARNING: evaluating a randomly initialized model")
    model = cast_model(model.to(device), dtype).eval()

    if args.no_rig:
        rig = None
    elif rig is None:
        rig = build_cli_rig(cfg, calibs, device, buckets=args.rig_buckets,
                            layout=args.rig_layout, cache_dir=RIG_CACHE_DIR,
                            dtype=dtype)
    encoder = ObjectEncoder(cfg, dim_mean=dim_mean, topk=args.topk)

    out_dir = args.out_dir or os.path.join("experiments", cfg.name, "evaluation")
    os.makedirs(out_dir, exist_ok=True)
    rows = ([], [], [], [])
    with torch.no_grad():
        for batch in loader:
            tb = batch_to_device(batch, device, dtype)
            pred = model(tb["images"], rig, tb["calibs"], tb["grid"])
            pred = {k: v.float() for k, v in pred.items()}
            dets = encoder.batch_decode(pred, args.cls_thresh)
            for b, scene_dets in enumerate(dets):
                for acc, r in zip(rows, scene_rows(int(batch["frame"][b]), scene_dets,
                                                   batch["objects"][b], cfg.mode)):
                    acc.extend(r)

    paths = {}
    # all 4 artifacts are written even when empty (the reference's
    # FormatPRData/FormatAPAOSData always dump, `evaluate.py:84-138`); in 2D
    # mode the ap_aos pair is empty
    for name, r in zip(("pr_dir_pred", "pr_dir_gt", "ap_aos_pred", "ap_aos_gt"), rows):
        paths[name] = os.path.join(out_dir, f"{name}.txt")
        np.savetxt(paths[name], np.asarray(r, dtype=np.float64))
    result = {"paths": paths, "metrics": None, "ap_aos": None}

    if not rows[0]:
        print("no detections above threshold; MODA undefined (0)")
        return result

    recall, precision, moda, modp = evaluate_rcll_prec_moda_modp(
        paths["pr_dir_pred"], paths["pr_dir_gt"], dataset=cfg.name,
        eval=args.eval_tool, td=args.td)
    td = args.td if args.td is not None else (78 if args.eval_tool == "matlab" else 30)
    print(f"matcher {matcher_backend()}")
    print(f"\n{args.eval_tool} eval: MODA {moda:.1f}, MODP {modp:.1f}, "
          f"prec {precision:.1f}, rcll {recall:.1f} (td={td:g})")
    result["metrics"] = (recall, precision, moda, modp)
    if cfg.mode == "3D" and rows[2]:
        r = evaluate_ap_aos(paths["ap_aos_pred"], paths["ap_aos_gt"], device=device)
        for i, t in enumerate((75, 50, 25)):
            print(f"AP_{t}: {r[3*i]:.2f}, AOS_{t}: {r[3*i+1]:.2f}, "
                  f"OS_{t}: {r[3*i+2]:.2f}")
        result["ap_aos"] = r
    return result


if __name__ == "__main__":
    main()
