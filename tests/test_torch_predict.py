"""The port's serving CLI end to end on the CPU, tiny config."""

import numpy as np
import torch

from vfa_tpu_torch import predict
from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd, rig_window_fwd_bf16

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_predict_cli_tiny_cpu(capsys):
    launches = rig_window_fwd.launches
    out = predict.main(["--data", "MultiviewC", "--synthetic", "--tiny",
                        "--device", "cpu", "--scenes", "3", "--batch", "2",
                        "--cls_thresh", "0.5"])
    text = capsys.readouterr().out
    assert "compiled rig: 12 buckets" in text
    assert "scene 2:" in text and "p50" in text
    assert rig_window_fwd.launches == launches        # CPU tensors: plain version
    assert len(out["ms"]) == 2 and len(out["detections"]) == 3
    assert [h.shape[0] for h in out["heatmaps"]] == [2, 1]
    assert all(torch.isfinite(h).all() for h in out["heatmaps"])


def test_predict_plain_and_kernel_route_agree_on_cpu():
    """--rig_impl plain and cuda give the same answer on the CPU, where the
    kernel's wrapper takes the plain version (same arithmetic: equal)."""
    argv = ["--data", "Wildtrack", "--synthetic", "--tiny", "--device", "cpu",
            "--scenes", "1", "--batch", "1"]
    a = predict.main(argv)
    b = predict.main(argv + ["--rig_impl", "plain"])
    np.testing.assert_array_equal(a["heatmaps"][0].numpy(), b["heatmaps"][0].numpy())


def test_predict_bf16_tiny_cpu(capsys, tmp_path, monkeypatch):
    """--dtype bfloat16 serves through a bf16 rig and a bf16 model (the
    plain rig versions on the CPU), fp32 heatmaps out."""
    monkeypatch.setenv("HOME", str(tmp_path))
    counts = (rig_window_fwd.launches, rig_window_fwd_bf16.launches)
    out = predict.main(["--data", "Wildtrack", "--synthetic", "--tiny",
                        "--device", "cpu", "--scenes", "2", "--batch", "2",
                        "--dtype", "bfloat16", "--cls_thresh", "0.5"])
    assert "tile_v 64, bf16, window layout" in capsys.readouterr().out
    assert counts == (rig_window_fwd.launches, rig_window_fwd_bf16.launches)
    assert len(out["detections"]) == 2
    assert all(h.dtype == torch.float32 and torch.isfinite(h).all()
               for h in out["heatmaps"])


def test_predict_no_rig_tiny_cpu(capsys):
    """--no_rig serves through the voxel route, no rig built."""
    out = predict.main(["--data", "MultiviewX", "--synthetic", "--tiny",
                        "--device", "cpu", "--scenes", "2", "--batch", "2",
                        "--no_rig"])
    assert "compiled rig" not in capsys.readouterr().out
    assert len(out["detections"]) == 2
    assert all(torch.isfinite(h).all() for h in out["heatmaps"])


def test_predict_requires_synthetic(tmp_path, capsys, monkeypatch):
    """Predict on disk: one validation scene of a MultiviewC-format set
    (`data.disk.write_multiviewc`), the weights of a checkpoint carried over
    from random JAX trees by `params_from_jax`; its heatmap matches JAX's
    forward of the same scene (JAX's loader, the voxel route) at
    tests/test_parity.py's rtol 5e-3 / atol 5e-4, and the figure is written.
    The voxel route in bf16 still raises, naming its item."""
    import jax
    import jax.numpy as jnp

    from vfa_tpu.config import TrainConfig as JTrainConfig
    from vfa_tpu.config import mc_opts
    from vfa_tpu.data.adapters import MultiviewC as JMultiviewC
    from vfa_tpu.data.frame_dataset import FrameDataset as JFrameDataset
    from vfa_tpu.data.synthetic import tiny_config as j_tiny_config
    from vfa_tpu.train_lib import create_model

    from vfa_tpu_torch.checkpoint import save_checkpoint
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.convert import params_from_jax
    from vfa_tpu_torch.data.disk import write_multiviewc
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.model.vfanet import VFANet

    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = tiny_config(get_config("MultiviewC"))
    root = str(tmp_path / "MultiviewC")
    write_multiviewc(root, cfg, 10, border=0.35)
    jcfg = j_tiny_config(mc_opts)
    jds = JFrameDataset(JMultiviewC(root, world_size=jcfg.world_size,
                                    cube_LWH=jcfg.cube_size,
                                    cache_dir=str(tmp_path / "jcache")),
                        jcfg, split="val")
    item = jds[0]
    jmodel = create_model(jcfg, JTrainConfig(pretrained=False))
    args = (jnp.asarray(item["images"][None]), jnp.asarray(item["calibs"][None]),
            jnp.asarray(item["grid"]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.2, x.shape).astype(x.dtype), shapes["params"])
    stats = jax.tree_util.tree_map(      # running variances are positive
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(x.dtype), shapes["batch_stats"])
    want = jax.jit(jmodel.apply)({"params": params, "batch_stats": stats}, *args)["heatmap"]
    model = VFANet(cfg)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    ckpt = save_checkpoint(str(tmp_path / "ck"), model, None, cfg,
                           TrainConfig(pretrained=False), 1)
    out_png = tmp_path / "prediction.png"
    out = predict.main(["--data", "MultiviewC", "--root", root, "--tiny",
                        "--checkpoint", ckpt, "--index", "0", "--out", str(out_png),
                        "--cls_thresh", "0.5", "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"restored {ckpt}" in text and f"wrote {out_png}" in text
    assert "compiled rig: 12 buckets" in text
    assert out["figure"] == str(out_png) and out_png.read_bytes()[:4] == b"\x89PNG"
    np.testing.assert_allclose(out["heatmaps"][0].numpy(), np.asarray(want),
                               rtol=5e-3, atol=5e-4)
    # --rig_buckets picks the rig's bucket count
    predict.main(["--data", "MultiviewC", "--root", root, "--tiny", "--index", "0",
                  "--out", str(out_png), "--rig_buckets", "2", "--device", "cpu"])
    assert "compiled rig: 2 buckets" in capsys.readouterr().out
    # --no_rig --dtype bfloat16 (the voxel route in bf16) raised naming
    # ROADMAP Queue 1 item 17 until it was ported; it serves now
    out = predict.main(["--data", "MultiviewC", "--synthetic", "--tiny", "--device",
                        "cpu", "--no_rig", "--dtype", "bfloat16"])
    assert "compiled rig" not in capsys.readouterr().out
    assert all(np.isfinite(h.numpy()).all() for h in out["heatmaps"])


def test_predict_without_matplotlib_says_so(tmp_path, capsys, monkeypatch):
    """Where matplotlib does not import, predict on disk prints that the
    figure was not written and still prints the detections."""
    import sys

    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.disk import write_multiviewc
    from vfa_tpu_torch.data.synthetic import tiny_config

    monkeypatch.setenv("HOME", str(tmp_path))
    root = str(tmp_path / "MultiviewC")
    write_multiviewc(root, tiny_config(get_config("MultiviewC")), 10, border=0.35)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = predict.main(["--data", "MultiviewC", "--root", root, "--tiny",
                        "--out", str(tmp_path / "p.png"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "figure not written: matplotlib is not installed" in text
    assert "detections above conf" in text and out["figure"] is None
    assert not (tmp_path / "p.png").exists()
