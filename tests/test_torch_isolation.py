"""The port stands alone: it imports neither JAX/flax nor vfa_tpu, and its
kernel loader knows every CUDA source."""

import ast
import glob
import os
import re
import subprocess
import sys

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vfa_tpu_torch")

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["vfa_tpu"] = None
import numpy as np, torch
import vfa_tpu_torch
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_scene, tiny_config
from vfa_tpu_torch.model.vfanet import VFANet, init_weights
from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes
from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd
from vfa_tpu_torch.codec import ObjectEncoder
from vfa_tpu_torch import convert, kernels, losses, predict, rig_cli, train, train_lib
from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
from vfa_tpu_torch.ops.rig_cuda import rig_window_bwd, rig_flat_fwd, rig_flat_bwd
from vfa_tpu_torch.ops import stem
from vfa_tpu_torch import prof_train
from vfa_tpu_torch import bench, entry
from vfa_tpu_torch import launch, parallel, parallel_bev
from vfa_tpu_torch.visualization import bbox, figure
from vfa_tpu_torch.ops import voxel
from vfa_tpu_torch import calib, checkpoint, evaluate, observability
from vfa_tpu_torch.data import adapters, augment, disk, frame_dataset, heatmaps
from vfa_tpu_torch.eval import apaos, iou, moda
from vfa_tpu_torch.eval import evaluate as eval_dispatch
from vfa_tpu_torch import native
from vfa_tpu_torch.native import imageio

cfg = tiny_config(get_config("MultiviewC"))
scene = make_scene(cfg, seed=0, num_objects=2)
rig = build_rig(scene.calibs, cfg, scene.grid, pyramid_feat_shapes(cfg.resize_size),
                tile_v=16, band_buckets=2, device="cpu")
model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).eval()
with torch.no_grad():
    pred = model(torch.from_numpy(scene.images[None]), rig)
L, W = cfg.grid_shape
assert pred["heatmap"].shape == (1, 1, L, W)
assert torch.isfinite(pred["rotation"]).all()
ObjectEncoder(cfg, dim_mean=[145.0, 120.0, 255.0]).batch_decode(pred, 0.5)
out = train.main(["--data", "Wildtrack", "--synthetic", "--tiny", "-e", "1",
                  "--synthetic_frames", "2", "--pretrained", "0", "--no_augment",
                  "--vis_iter", "0", "--device", "cpu"])
assert all(np.isfinite(d["loss"]) for d in out["losses"])
assert rig_window_fwd.launches == 0 and rig_window_bwd.launches == 0
import os
os.environ["VFA_FUSED_STEM"] = "1"
out = train.main(["--data", "MultiviewC", "--synthetic", "--tiny", "-e", "1",
                  "--synthetic_frames", "2", "--pretrained", "0", "--no_augment",
                  "--vis_iter", "0", "--device", "cpu", "--rig_layout", "flat"])
assert all(np.isfinite(d["loss"]) for d in out["losses"])
assert out["model"].base.fused_stem_on() and not out["rig"].scales[0].window_hw
assert rig_flat_fwd.launches == 0 and rig_flat_bwd.launches == 0
assert stem.stem_bwd_stats.launches == 0 and stem.stem_bwd_dx.launches == 0
from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd_bf16
out = predict.main(["--data", "Wildtrack", "--synthetic", "--tiny", "--device",
                    "cpu", "--scenes", "1", "--batch", "1", "--dtype", "bfloat16"])
assert all(torch.isfinite(h).all() for h in out["heatmaps"])
assert rig_window_fwd_bf16.launches == 0
from vfa_tpu_torch.ops.rig_cuda import rig_flat_bwd_bf16
out = train.main(["--data", "MultiviewC", "--synthetic", "--tiny", "-e", "1",
                  "--synthetic_frames", "1", "--pretrained", "0", "--no_augment",
                  "--vis_iter", "0", "--device", "cpu", "--rig_layout", "flat", "--dtype", "bfloat16"])
assert all(np.isfinite(d["loss"]) for d in out["losses"])
assert rig_flat_bwd_bf16.launches == 0 and stem.stem_bwd_dx_bf16.launches == 0
out = train.main(["--data", "MultiviewC", "--synthetic", "--tiny", "-e", "1",
                  "--synthetic_frames", "1", "--pretrained", "0", "--no_augment",
                  "--vis_iter", "0", "--device", "cpu", "--no_rig", "--dtype", "bfloat16"])
assert all(np.isfinite(d["loss"]) for d in out["losses"])
assert voxel.voxel_tap_bwd.launches == 0 and voxel.voxel_tap_bwd_bf16.launches == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "vfa_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ISOLATED-OK")
"""


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"      # one torch thread, as the fixture gives a test
    # the train CLI writes its runs under experiments/ of the working directory
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout


def test_no_jax_or_vfa_tpu_import_in_package():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "vfa_tpu")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                offenders += [f"{path}:{node.lineno}: {m}" for m in mods
                              if m.split(".")[0] in banned]
    assert not offenders, offenders


# Kernels of the port with no Pallas counterpart: MVDet's projection (the
# JAX package has no MVDet) and the backbone's norms (the JAX package leaves
# them to XLA).
NO_TPU_COUNTERPART = {"mvdet_project", "gn_nhwc"}


def test_every_cuda_source_is_known_to_the_loader():
    """Each csrc/*.cu has its entry in `kernels.SIGNATURES`, a note of the
    TPU kernel it replaces (or, for a source of NO_TPU_COUNTERPART alone,
    that it replaces none) and of what bounds it, and each declared C
    function takes as many arguments as its argtypes say."""
    from vfa_tpu_torch.kernels import CSRC, SIGNATURES

    sources = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu"))}
    assert sources == set(SIGNATURES)
    for name, fns in SIGNATURES.items():
        with open(os.path.join(CSRC, f"{name}.cu"), encoding="utf-8") as fh:
            text = fh.read()
        replaces = ("Replaces no TPU kernel" if name in NO_TPU_COUNTERPART
                    else "Replaces vfa_tpu/ops/")
        assert replaces in text, name
        assert "What bounds it" in text, name
        declared = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(declared) == set(fns), name
        for fn, argtypes in fns.items():
            assert len(declared[fn].split(",")) == len(argtypes), fn
