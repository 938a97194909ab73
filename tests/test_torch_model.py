"""The port's ResNet-GN and VFANet against the flax models, with the same
weights carried JAX init -> numpy -> `params_from_jax` ->
`load_state_dict(strict=True)`.

Tolerance rtol 5e-3 / atol 5e-4, as tests/test_parity.py:125: flax
GroupNorm computes the variance as E[x^2] - E[x]^2 (see
vfa_tpu/ops/stem.py:58-68) while torch takes two passes, and the convs sum
in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import TrainConfig, mc_opts, wt_opts
from vfa_tpu.data.synthetic import make_scene, tiny_config
from vfa_tpu.model.resnet import ResNetGN as FlaxResNetGN
from vfa_tpu.ops.rig import build_rig as jax_build_rig, pyramid_feat_shapes
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.model.resnet import ResNetGN
from vfa_tpu_torch.model.vfanet import VFANet
from vfa_tpu_torch.ops.rig import build_rig

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 5e-3, 5e-4


def _perturb(tree, rng, scale=0.05):
    """Numpy copy of a param tree with every leaf moved off its init value,
    so that a swapped scale/bias or a transposed kernel cannot pass."""
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.normal(size=x.shape))
        .astype(np.float32), tree)


def _random_stats(stats, rng):
    out = {}
    for name, s in stats.items():
        out[name] = {
            "mean": (0.1 * rng.normal(size=s["mean"].shape)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=s["var"].shape).astype(np.float32),
        }
    return out


def test_resnet_pyramid_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, size=(1, 32, 64, 3)).astype(np.float32)
    fm = FlaxResNetGN((2, 2, 2, 2))
    params = _perturb(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = fm.apply({"params": params}, jnp.asarray(x))

    model = ResNetGN((2, 2, 2, 2))
    model.load_state_dict(params_from_jax(params, {}), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg", [mc_opts, wt_opts], ids=lambda c: c.name)
def test_vfanet_rig_forward_matches_jax(cfg):
    """Full forward through the rig: JAX with rig_impl='pallas' (interpret
    on the CPU) vs the port's VFANet (the window kernel's plain version on
    the CPU), tiny MultiviewC (3D) and tiny Wildtrack (2D)."""
    rng = np.random.default_rng(11)
    tc = tiny_config(cfg)
    scenes = [make_scene(tc, seed=s, num_objects=3) for s in range(2)]
    images = np.stack([s.images for s in scenes])
    calibs = np.stack([s.calibs for s in scenes])
    grid = scenes[0].grid
    shapes = pyramid_feat_shapes(tc.resize_size)

    jmodel = create_model(tc, TrainConfig(pretrained=False), rig_impl="pallas")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                     jnp.asarray(calibs), jnp.asarray(grid))
    params = _perturb(variables["params"], rng)
    stats = _random_stats(variables["batch_stats"], rng)
    jr = jax_build_rig(scenes[0].calibs, tc, grid, shapes, tile_v=16,
                       dtype=jnp.float32, band_buckets=3, layout="window")
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(images), jnp.asarray(calibs),
                        jnp.asarray(grid), train=False, rig=jr)

    ttc = t_tiny_config(get_config(cfg.name))
    model = VFANet(ttc)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    model.eval()
    tr = build_rig(scenes[0].calibs, ttc, grid, shapes, tile_v=16,
                   dtype=torch.float32, band_buckets=3, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(images), tr)

    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"mismatch in {key}")


def test_vfanet_without_rig_raises():
    """Without a rig the model samples through the voxel route, which needs
    the calibrations and the grid."""
    model = VFANet(t_tiny_config(get_config("MultiviewC")))
    with pytest.raises(ValueError, match="needs calibs"):
        model(torch.zeros((1, 2, 90, 160, 3)), None)
