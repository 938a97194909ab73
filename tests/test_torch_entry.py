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


def test_dryrun_multichip_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 15"):
        tentry.dryrun_multichip(8)
