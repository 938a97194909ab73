"""The port's serving CLI end to end on the CPU, tiny config."""

import numpy as np
import pytest
import torch

from vfa_tpu_torch import predict
from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd, rig_window_fwd_bf16


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


def test_predict_requires_synthetic():
    with pytest.raises(NotImplementedError, match="--synthetic"):
        predict.main(["--data", "MultiviewC", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        predict.main(["--data", "MultiviewC", "--synthetic", "--device", "cpu",
                      "--no_rig", "--dtype", "bfloat16"])
