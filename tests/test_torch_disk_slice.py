"""The on-disk path of the port end to end at the tiny configuration, on
MultiviewC-format datasets written by `data.disk.write_multiviewc`: the
train CLI on disk (uint8 staging, the ColorJitter on the device,
checkpoints, metrics.jsonl, TensorBoard) and `--resume` continuing the run
exactly; `--debug_nans` and `--profile_steps`; the evaluate CLI's four
artifacts against the JAX CLI's per-scene loop on the same predictions
(weights carried from JAX trees by `params_from_jax`); and the bench's
`--from_disk` mode."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfa_tpu.codec import ObjectEncoder as JObjectEncoder
from vfa_tpu.config import TrainConfig as JTrainConfig
from vfa_tpu.config import mc_opts
from vfa_tpu.data.adapters import MultiviewC as JMultiviewC
from vfa_tpu.data.frame_dataset import FrameDataset as JFrameDataset
from vfa_tpu.data.synthetic import make_scene
from vfa_tpu.data.synthetic import tiny_config as j_tiny_config
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import bench, evaluate, train
from vfa_tpu_torch.checkpoint import save_checkpoint
from vfa_tpu_torch.codec import ObjectEncoder
from vfa_tpu_torch.config import TrainConfig, get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.adapters import MultiviewC
from vfa_tpu_torch.data.disk import write_multiviewc
from vfa_tpu_torch.data.frame_dataset import FrameDataset, SceneLoader
from vfa_tpu_torch.data.synthetic import tiny_config
from vfa_tpu_torch.model.vfanet import VFANet
from vfa_tpu_torch.observability import enable_nan_debugging
from vfa_tpu_torch.rig_cli import build_cli_rig
from vfa_tpu_torch.train_lib import batch_to_device

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = tiny_config(get_config("MultiviewC"))
TINY = ["--data", "MultiviewC", "--tiny", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    """The rig cache and torch's hub directory go under a temporary HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))


def _dataset(tmp_path_factory, frames):
    root = str(tmp_path_factory.mktemp("mc") / "MultiviewC")
    write_multiviewc(root, CFG, frames, seed=5, num_objects=2, border=0.35)
    return root


@pytest.fixture(scope="module")
def two_frames(tmp_path_factory):
    """1 train frame and 1 val frame."""
    return _dataset(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def twenty_frames(tmp_path_factory):
    """18 train frames and 2 val frames."""
    return _dataset(tmp_path_factory, 20)


def test_train_on_disk_then_resume_continues_the_run(two_frames, tmp_path, capsys):
    """6 epochs in one run against the same run resumed from its epoch-5
    checkpoint: epoch 6's losses, parameters, momentum and OneCycle step are
    the same (the checkpoint carries the loader's and the jitter's
    generator states). 6 and not 2 epochs: the OneCycle curve depends on
    -e, so a run with -e 1 cannot be continued into a run with -e 2's
    schedule, in the JAX CLI as here."""
    argv = TINY + ["--root", two_frames, "-e", "6", "--seed", "3",
                   "--savedir", str(tmp_path), "--vis_iter", "0"]
    full = train.main(argv + ["--resume", "full"])
    out = capsys.readouterr().out
    assert "pretrained backbone unavailable (no resnet18 ImageNet weights at" in out
    assert "images staged as uint8, ColorJitter on the device" in out
    run = tmp_path / "full"
    assert sorted(os.listdir(run / "checkpoints")) == ["epoch_0005", "epoch_0006"]
    with open(run / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["tag"] for r in recs] == ["train", "val", "opt"] * 6
    assert os.listdir(run / "tensorboard")
    assert full["steps_per_epoch"] == 1 and len(full["losses"]) == 6

    os.makedirs(tmp_path / "part" / "checkpoints")
    shutil.copytree(run / "checkpoints" / "epoch_0005",
                    tmp_path / "part" / "checkpoints" / "epoch_0005")
    part = train.main(argv + ["--resume", "part"])
    assert "at epoch 6 (optimizer step 5)" in capsys.readouterr().out
    assert part["losses"] == full["losses"][5:]
    assert part["val_losses"] == full["val_losses"][5:]
    assert part["lrs"] == full["lrs"][5:]
    for (k, v), (k2, v2) in zip(full["model"].state_dict().items(),
                                part["model"].state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    assert part["optimizer"].count == full["optimizer"].count == 6
    for p, q in zip(full["model"].parameters(), part["model"].parameters()):
        assert torch.equal(full["optimizer"].state[p]["momentum_buffer"],
                           part["optimizer"].state[q]["momentum_buffer"])


def test_debug_nans_raises_naming_the_step(tmp_path):
    argv = TINY + ["--synthetic", "--synthetic_frames", "2", "-e", "1",
                   "--pretrained", "0", "--no_augment", "--savedir", str(tmp_path),
                   "--vis_iter", "0"]
    try:
        # a NaN learning rate: the first update makes every parameter NaN
        with pytest.raises(FloatingPointError, match="non-finite values at step 1: loss"):
            train.main(argv + ["--lr", "nan", "--debug_nans"])
    finally:
        enable_nan_debugging(False)


def test_profile_steps_leaves_a_trace(tmp_path):
    train.main(TINY + ["--synthetic", "--synthetic_frames", "2", "-e", "1",
                       "--pretrained", "0", "--no_augment", "--profile_steps", "1",
                       "--vis_iter", "0",
                       "--savedir", str(tmp_path), "--resume", "prof"])
    (trace,) = os.listdir(tmp_path / "prof" / "profile")
    assert os.path.getsize(tmp_path / "prof" / "profile" / trace) > 1000


def _jax_trees():
    tc = j_tiny_config(mc_opts)
    s = make_scene(tc, seed=0, num_objects=2)
    shapes = jax.eval_shape(create_model(tc, JTrainConfig(pretrained=False)).init,
                            jax.random.PRNGKey(0), jnp.asarray(s.images[None]),
                            jnp.asarray(s.calibs[None]), jnp.asarray(s.grid))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.2, x.shape).astype(x.dtype), shapes["params"])
    stats = jax.tree_util.tree_map(      # running variances are positive
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(x.dtype), shapes["batch_stats"])
    return params, stats


def _jax_rows(preds, frames, objects, dim_mean, thresh, topk):
    """The JAX CLI's per-scene loop (`evaluate.py:155-175`) on given
    predictions: rows of the four artifacts."""
    enc = JObjectEncoder(j_tiny_config(mc_opts), dim_mean=dim_mean, topk=topk)
    rows = ([], [], [], [])
    for b, frame_id in enumerate(frames):
        one = {k: jnp.asarray(v[b:b + 1].numpy()) for k, v in preds.items()}
        for o in enc.batch_decode(one, thresh):
            loc = np.asarray(o.location)
            rows[0].append([frame_id, loc[0], loc[1]])
            dim = np.asarray(o.dimension)[::-1]
            rows[2].append([frame_id, *loc, *dim, float(o.rotation), float(o.conf)])
        for o in objects[b]:
            loc = np.asarray(o.location)
            rows[1].append([frame_id, loc[0], loc[1]])
            dim = np.asarray(o.dimension)[::-1]
            rows[3].append([frame_id, *loc[:3], *dim, float(o.rotation)])
    return rows


def _port_rows(preds, frames, objects, dim_mean, thresh, topk, per_scene):
    """The port's rows of the same predictions, decoded as one batch (the
    evaluate CLI) or scene by scene."""
    enc = ObjectEncoder(CFG, dim_mean=dim_mean, topk=topk)
    if per_scene:
        dets = [enc.batch_decode({k: v[b:b + 1] for k, v in preds.items()}, thresh)[0]
                for b in range(len(frames))]
    else:
        dets = enc.batch_decode(preds, thresh)
    rows = ([], [], [], [])
    for f, d, objs in zip(frames, dets, objects):
        for acc, r in zip(rows, evaluate.scene_rows(f, d, objs, "3D")):
            acc.extend(r)
    return [np.asarray(r, np.float64) for r in rows]


def _same_rows(got, want, name):
    """The same detections in the same order (frame, rotation and the gt
    columns exact); locations, sizes and confidences to 1e-6 relative: XLA's
    and torch's fp32 sigmoid and exp differ in the last bit."""
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    if not len(want):
        return
    np.testing.assert_array_equal(got[:, 0], want[:, 0], err_msg=name)
    if got.shape[1] == 9:
        np.testing.assert_array_equal(got[:, 7], want[:, 7], err_msg=name)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)


def test_evaluate_cli_rows_equal_jax_per_scene_loop(twenty_frames, tmp_path, capsys):
    """The evaluate CLI's batched decode writes exactly the rows of the
    port's scene-by-scene decode, and the rows of JAX's per-scene loop on
    the same predictions; then, on a heatmap of saturated ties, the top-k
    cut falls inside the ties the same way in all three."""
    model = VFANet(CFG)
    model.load_state_dict(params_from_jax(*_jax_trees()), strict=True)
    jds = JFrameDataset(JMultiviewC(twenty_frames, world_size=CFG.world_size,
                                    cube_LWH=CFG.cube_size,
                                    cache_dir=str(tmp_path / "jcache")),
                        j_tiny_config(mc_opts), split="val")
    ckpt = save_checkpoint(str(tmp_path / "ck"), model, None, CFG,
                           TrainConfig(pretrained=False), 1,
                           extra={"dim_mean": jds.dim_mean.tolist()})
    ds = FrameDataset(MultiviewC(twenty_frames, world_size=CFG.world_size,
                                 cube_LWH=CFG.cube_size),
                      dataclasses.replace(CFG, root=twenty_frames), split="val")
    rig = build_cli_rig(CFG, ds.calibs, "cpu")
    res = evaluate.main(TINY + ["--root", twenty_frames, "--checkpoint", ckpt,
                                "-b", "2", "--cls_thresh", "0.01", "--topk", "7",
                                "--out_dir", str(tmp_path / "out")], rig=rig)
    out = capsys.readouterr().out
    assert "MODA" in out and "AP_50" in out and "matcher " in out
    # the CLI's predictions: the same model on the same (one) batch
    batch = next(iter(SceneLoader(ds, batch_size=2, images_dtype=np.uint8)))
    with torch.no_grad():
        preds = model.eval()(batch_to_device(batch, "cpu")["images"], rig)
    frames = list(jds.frame_range)
    objects = [jds.labels[i] for i in range(len(jds))]
    scene = _port_rows(preds, frames, objects, jds.dim_mean, 0.01, 7, per_scene=True)
    want = _jax_rows(preds, frames, objects, jds.dim_mean, 0.01, 7)
    assert len(want[0]) > 4, "too few detections to compare"
    for name, s, w in zip(("pr_dir_pred", "pr_dir_gt", "ap_aos_pred", "ap_aos_gt"),
                          scene, want):
        got = np.loadtxt(res["paths"][name], ndmin=2)
        np.testing.assert_array_equal(got, s, err_msg=name)
        _same_rows(got, w, name)

    # ties: 8 isolated cells at logit 30 (sigmoid 1.0 in fp32), top-k 5
    tied = {k: v.clone() for k, v in preds.items()}
    tied["heatmap"][:] = -5.0
    for r, c in [(0, 0), (0, 4), (0, 8), (4, 0), (4, 4), (4, 8), (8, 0), (8, 8)]:
        tied["heatmap"][:, 0, r, c] = 30.0
    batched = _port_rows(tied, [0, 1], [[], []], jds.dim_mean, 0.5, 5, per_scene=False)
    scene = _port_rows(tied, [0, 1], [[], []], jds.dim_mean, 0.5, 5, per_scene=True)
    want = _jax_rows(tied, [0, 1], [[], []], jds.dim_mean, 0.5, 5)
    assert len(batched[0]) == 10
    for b, s, w in zip(batched, scene, want):
        np.testing.assert_array_equal(b, s)
        _same_rows(b, w, "ties")


@pytest.mark.parametrize("extra,metric", [
    ([], "multiviewc_2cam_fromdisk_scenes_per_sec_per_chip"),
    (["--train"], "multiviewc_2cam_train_fromdisk_scenes_per_sec_per_chip"),
], ids=["serving", "train"])
def test_bench_from_disk_prints_one_json_line(tmp_path, capsys, extra, metric):
    res = bench.main(["--tiny", "--device", "cpu", "--batch", "1", "--iters", "2",
                      "--warmup", "0", "--from_disk", "--disk_frames", "2",
                      "--disk_dir", str(tmp_path / "frames"), "--image_backend",
                      "pil"] + extra)
    out = capsys.readouterr()
    (line,) = out.out.strip().splitlines()
    assert json.loads(line) == res and res["metric"] == metric and res["value"] > 0
    assert "# from disk: 2 frames x 2 cameras" in out.err and "decoder PIL" in out.err
    assert ("ColorJitter on the card" in out.err) == bool(extra)
