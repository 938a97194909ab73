"""The flat rig layout end to end on the CPU: one tiny flat forward of the
port's VFANet against the JAX model on a flat rig (rig_impl='pallas',
interpret mode), and the serving CLI with `--rig_layout flat`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import TrainConfig, mc_opts
from vfa_tpu.data.synthetic import make_scene, tiny_config
from vfa_tpu.ops.rig import build_rig as jax_build_rig, pyramid_feat_shapes
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import predict
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.model.vfanet import VFANet
from vfa_tpu_torch.ops.rig import build_rig
from vfa_tpu_torch.ops.rig_cuda import rig_flat_fwd, rig_window_fwd


@pytest.mark.medium
def test_flat_predict_matches_jax_forward(monkeypatch):
    """Same weights (JAX init, moved off their init values, carried over by
    `params_from_jax`, strict), fused stem on in both packages: the
    parameter tree of JAX's fused stem loads unchanged. Tolerance rtol 5e-3
    / atol 5e-4 as tests/test_torch_model.py (GroupNorm variance formulas,
    conv sum orders)."""
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    rng = np.random.default_rng(17)
    tc = tiny_config(mc_opts)
    scenes = [make_scene(tc, seed=s, num_objects=3) for s in range(2)]
    images = np.stack([s.images for s in scenes])
    calibs = np.stack([s.calibs for s in scenes])
    grid = scenes[0].grid
    shapes = pyramid_feat_shapes(tc.resize_size)

    jmodel = create_model(tc, TrainConfig(pretrained=False), rig_impl="pallas")
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(calibs), jnp.asarray(grid))
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    jr = jax_build_rig(scenes[0].calibs, tc, grid, shapes, tile_v=16,
                       dtype=jnp.float32, band_buckets=3, layout="flat")
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(images), jnp.asarray(calibs),
                        jnp.asarray(grid), train=False, rig=jr)

    ttc = t_tiny_config(get_config("MultiviewC"))
    model = VFANet(ttc)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    model.eval()
    assert model.base.fused_stem_on()
    tr = build_rig(scenes[0].calibs, ttc, grid, shapes, tile_v=16,
                   dtype=torch.float32, band_buckets=3, layout="flat", device="cpu")
    launches = rig_flat_fwd.launches
    with torch.no_grad():
        got = model(torch.from_numpy(images), tr)
    assert rig_flat_fwd.launches == launches      # CPU tensors: plain version
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-3, atol=5e-4, err_msg=key)


def test_predict_cli_flat_layout_tiny_cpu(capsys):
    """`--rig_layout flat` builds the flat rig (tile_v 160) and gives the
    window layout's heatmaps and detections (same seeded weights; the two
    layouts regroup the same weights: fp32 sums in another order)."""
    argv = ["--data", "MultiviewC", "--synthetic", "--tiny", "--device", "cpu",
            "--scenes", "2", "--batch", "2", "--cls_thresh", "0.5"]
    counts = (rig_flat_fwd.launches, rig_window_fwd.launches)
    flat = predict.main(argv + ["--rig_layout", "flat"])
    text = capsys.readouterr().out
    assert "compiled rig: 12 buckets, tile_v 160, fp32, flat layout" in text
    window = predict.main(argv)
    assert "window layout" in capsys.readouterr().out
    assert (rig_flat_fwd.launches, rig_window_fwd.launches) == counts
    np.testing.assert_allclose(flat["heatmaps"][0].numpy(),
                               window["heatmaps"][0].numpy(), rtol=1e-4, atol=1e-5)
    assert [len(d) for d in flat["detections"]] == [len(d) for d in window["detections"]]
    plain = predict.main(argv + ["--rig_layout", "flat", "--rig_impl", "plain"])
    np.testing.assert_array_equal(plain["heatmaps"][0].numpy(),
                                  flat["heatmaps"][0].numpy())
