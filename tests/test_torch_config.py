"""The port's configs equal the JAX package's, field for field."""

import dataclasses

import pytest

from vfa_tpu import config as jcfg
from vfa_tpu.data.synthetic import tiny_config as jax_tiny

from vfa_tpu_torch import config as tcfg
from vfa_tpu_torch.data.synthetic import tiny_config

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["MultiviewC", "MultiviewX", "Wildtrack"])
@pytest.mark.parametrize("tiny", [False, True])
def test_config_fields_equal(name, tiny):
    j = jcfg.get_config(name)
    t = tcfg.get_config(name)
    if tiny:
        j, t = jax_tiny(j), tiny_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.grid_shape == j.grid_shape
    assert t.num_layers == j.num_layers
    assert t.reduced_grid_size == j.reduced_grid_size


def test_singletons_and_unknown_name():
    assert tcfg.mc_opts.name == "MultiviewC" and tcfg.mx_opts.name == "MultiviewX"
    assert tcfg.wt_opts.name == "Wildtrack"
    with pytest.raises(ValueError, match="Dataset error"):
        tcfg.get_config("KITTI")
