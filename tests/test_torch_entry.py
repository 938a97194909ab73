"""The port's entry point against `__graft_entry__`: `entry()` runs
the zeroed flagship model through the voxel route, with the JAX entry's
output shapes and values at the same tiny config."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from vfa_tpu_torch import entry as tentry

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.medium
def test_entry_matches_graft_entry_tiny():
    fn, (params, images, calibs, grid) = tentry.entry(device="cpu", tiny=True)
    assert params and all(float(v.abs().max()) == 0 for v in params.values())
    got = fn(params, images, calibs, grid)

    _, _, model, scene = jentry._flagship(tiny=True)
    args = (jnp.asarray(scene.images), jnp.asarray(scene.calibs),
            jnp.asarray(scene.grid))
    variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args)))
    want = model.apply(variables, *args)
    np.testing.assert_array_equal(images.numpy(), scene.images)
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_array_equal(got[key].detach().numpy(), np.asarray(w))


def test_dryrun_multichip_is_not_ported(capsys):
    """dryrun_multichip(4) runs `__graft_entry__.dryrun_multichip`'s four
    parts in 4 gloo ranks on the CPU (the data-parallel rig step, the
    (data 2, cam 2) voxel-route step, BEV-sharded sampling with its
    gradients, the full-model BEV-sharded step at batch 1) and prints its
    line with finite losses."""
    res = tentry.dryrun_multichip(4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): rig-window mesh=data4 loss=")
    assert "dynamic mesh=data2xcam2" in line and "bev-sharded mesh=bev4" in line
    assert line.endswith(" OK") and res["bev_grads_finite"]
