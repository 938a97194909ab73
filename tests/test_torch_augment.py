"""The port's ColorJitter against the JAX package's: the host numpy ops
and `sample_jitter_params` exactly (the same draws from the same
generator), and the torch `device_color_jitter` within atol 2e-6 of JAX's
`device_color_jitter` (the tolerance tests/test_augment.py holds JAX's
device op to its host op), on every one of the six op orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfa_tpu.data import augment as jaug

from vfa_tpu_torch.data import augment

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def images():
    r = np.random.default_rng(7)
    imgs = (r.integers(0, 256, size=(12, 20, 24, 3)) / 255.0).astype(np.float32)
    imgs[0, :4] = 0.5        # grey pixels: the hue's cr == 0 branch
    imgs[1, :4] = 0.0        # black: maxc == 0
    return imgs


def test_host_jitter_matches_jax(images):
    for f in (0.0, 0.8, 1.2):
        np.testing.assert_array_equal(augment.adjust_brightness(images[2], f),
                                      jaug.adjust_brightness(images[2], f))
        np.testing.assert_array_equal(augment.adjust_contrast(images[3], f),
                                      jaug.adjust_contrast(images[3], f))
    for f in (-0.2, 0.05, 0.5):
        np.testing.assert_array_equal(augment.adjust_hue(images[0], f),
                                      jaug.adjust_hue(images[0], f))
    with pytest.raises(ValueError):
        augment.adjust_hue(images[0], 0.7)
    got = augment.ColorJitterAugment()(images[:7], np.random.default_rng(4))
    want = jaug.ColorJitterAugment()(images[:7], np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)


def test_sample_jitter_params_match_jax():
    f, o = augment.sample_jitter_params(np.random.default_rng(9), 56)
    jf, jo = jaug.sample_jitter_params(np.random.default_rng(9), 56)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(o, jo)
    assert augment._PERMS3 == jaug._PERMS3


def test_device_color_jitter_matches_jax(images):
    n = len(images)
    f, _ = augment.sample_jitter_params(np.random.default_rng(1), n)
    order = np.arange(n, dtype=np.int32) % 6
    want = np.asarray(jaug.device_color_jitter(jnp.asarray(images), jnp.asarray(f),
                                               jnp.asarray(order)))
    for o in (order, torch.from_numpy(order)):
        got = augment.device_color_jitter(torch.from_numpy(images), f, o).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # one order for every image takes the all-images branch of each op
    same = np.full(n, 4, np.int32)
    got = augment.device_color_jitter(torch.from_numpy(images),
                                      torch.from_numpy(f), same).numpy()
    want = np.asarray(jaug.device_color_jitter(jnp.asarray(images), jnp.asarray(f),
                                               jnp.asarray(same)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # the input is left as it was
    np.testing.assert_array_equal(torch.from_numpy(images).numpy(), images)


def test_device_color_jitter_needs_the_order_on_the_host():
    x = torch.rand(2, 4, 4, 3)
    order = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="host"):
        augment.device_color_jitter(x, np.ones((2, 3), np.float32), order)
