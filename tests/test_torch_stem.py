"""The port's fused stem tail (`ops/stem.py`) on the CPU against the JAX
package: the forward is the unfused chain exactly, and the backward (the
plain versions of the two kernels plus the reductions between them, which
`gn_relu_pool` takes for CPU tensors) equals `_pallas_bwd(interpret=True)`
and JAX autodiff, including the max-pool's first-maximum tie routing. The
port is NCHW, the JAX package NHWC: the tests transpose."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.ops import stem as jstem

from vfa_tpu_torch.model.resnet import ResNetGN
from vfa_tpu_torch.ops import stem as tstem

# (M, H, W, C) as the JAX package takes them
EVEN_SHAPES = [(2, 12, 16, 64), (1, 20, 48, 64), (3, 24, 32, 64),
               (1, 48, 256, 64)]          # the last: several row blocks
ODD_SHAPES = [(2, 11, 15, 64), (1, 7, 10, 32)]


def _make(shape, seed=0, plateau=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if plateau:
        x = np.round(x * 2) / 2      # exact ties inside pool windows
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    oh, ow = (shape[1] + 1) // 2, (shape[2] + 1) // 2
    g = rng.normal(size=(shape[0], oh, ow, shape[3])).astype(np.float32)
    return x, scale, bias, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_autodiff(x, scale, bias, g):
    _, vjp = jax.vjp(
        lambda x_, s_, b_: jstem._pool(jstem._gn_relu(x_, s_, b_, 16, 1e-5)[0]),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _port_bwd(x, scale, bias, g):
    tx = _nchw(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tstem.gn_relu_pool(tx, ts, tb).backward(_nchw(g))
    return _nhwc(tx.grad), ts.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("shape", EVEN_SHAPES[:3] + ODD_SHAPES, ids=str)
def test_forward_is_the_unfused_chain_and_matches_jax(shape):
    x, scale, bias, _ = _make(shape, plateau=False)
    tx, ts, tb = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    got = tstem.gn_relu_pool(tx, ts, tb)
    want = torch.nn.functional.max_pool2d(torch.relu(
        torch.nn.functional.group_norm(tx, 16, ts, tb, 1e-5)), 3, 2, 1)
    assert torch.equal(got, want)
    # fp32 rounding: the two frameworks take the statistics in other orders
    ref = np.asarray(jstem.gn_relu_pool(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias)))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", EVEN_SHAPES, ids=str)
def test_backward_matches_pallas_kernels_and_autodiff(shape):
    """dx, dscale, dbias against `_pallas_bwd(interpret=True)` (the shapes
    of tests/test_stem.py:75 plus a tall one) and JAX autodiff. Tolerance
    rtol 2e-5 / atol 2e-5 on dx as tests/test_stem.py:98; the parameter
    gradients are sums over M*H*W terms taken in another order."""
    x, scale, bias, g = _make(shape)
    _, mu, rstd = jstem._gn_relu(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 16, 1e-5)
    pal = [np.asarray(t) for t in jstem._pallas_bwd(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), mu, rstd,
        jnp.asarray(g), 16, 1e-5, interpret=True)]
    auto = _jax_autodiff(x, scale, bias, g)
    got = _port_bwd(x, scale, bias, g)
    for want in (pal, auto):
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
def test_backward_odd_sizes_match_autodiff(shape):
    """Odd H, W (the pool takes ceil): no Pallas kernel covers them, so JAX
    autodiff and the port's own autograd of the chain are the references."""
    x, scale, bias, g = _make(shape)
    got = _port_bwd(x, scale, bias, g)
    plain = tstem.gn_relu_pool_bwd_plain(
        _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), _nchw(g))
    want = (_nhwc(plain[0]), plain[1].numpy(), plain[2].numpy())
    if shape[-1] == 64:
        want_j = _jax_autodiff(x, scale, bias, g)
    else:
        want_j = want
    for w in (want, want_j):
        np.testing.assert_allclose(got[0], w[0], rtol=2e-5, atol=2e-5)
        for a, b in zip(got[1:], w[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_tie_positions_exact():
    """Heavily tied input (integers: many ReLU zeros and equal maxima):
    the zero pattern of dx must be identical to JAX autodiff's and to the
    Pallas kernels' (tests/test_stem.py:111-133). dx is zero exactly where
    dz is and the group's moment terms vanish, so with scale 1, bias 0 the
    pattern pins the routing."""
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(size=(2, 16, 16, 64))).astype(np.float32)
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    g = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    want = _jax_autodiff(x, scale, bias, g)[0]
    got = _port_bwd(x, scale, bias, g)[0]
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the routed cotangent itself, before the moment terms: same support
    tx, ts, tb = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    _, mu, rstd = tstem.group_norm_stats(tx, ts, tb, 16, 1e-5)
    acc = tstem.stem_bwd_stats(tx, _nchw(g), tstem.plane_params(mu, rstd, ts, tb))
    assert acc.shape == (2, 4, 64)
    np.testing.assert_allclose(acc[:, 3].sum(0).numpy(),
                               _jax_autodiff(x, scale, bias, g)[2],
                               rtol=1e-4, atol=1e-4)


def test_group_norm_stats_match_jax():
    x, scale, bias, _ = _make((2, 12, 16, 64), plateau=False)
    mu, _, rstd = jstem._gn_stats(jnp.asarray(x), 16, 1e-5)
    tx, ts, tb = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    z, tmu, trstd = tstem.group_norm_stats(tx, ts, tb, 16, 1e-5)
    assert torch.equal(z, torch.nn.functional.group_norm(tx, 16, ts, tb, 1e-5))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trstd.numpy(), np.asarray(rstd), rtol=1e-5)


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    x, scale, bias, g = _make((1, 8, 8, 64))
    tx, tg = _nchw(x), _nchw(g)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    _, mu, rstd = tstem.group_norm_stats(tx, ts, tb, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, ts, tb)
    counts = (tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches)
    assert torch.equal(tstem.stem_bwd_stats(tx, tg, params),
                       tstem.stem_bwd_stats_plain(tx, tg, params))
    assert torch.equal(tstem.stem_bwd_dx(tx, tg, params),
                       tstem.stem_bwd_dx_plain(tx, tg, params))
    assert (tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches) == counts
    for fn in (tstem.stem_bwd_stats, tstem.stem_bwd_dx):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(tx.to("meta"), tg, params)
    with pytest.raises(ValueError, match="groups"):
        tstem.gn_relu_pool(torch.zeros((1, 10, 4, 4)), torch.ones(10), torch.zeros(10))


def test_resnet_fused_stem_same_state_dict_forward_and_grads(monkeypatch):
    """`ResNetGN(fused_stem=True)` has the unfused backbone's state dict
    (so `params_from_jax` output loads strict), the identical forward, and
    matching gradients; VFA_FUSED_STEM overrides the attribute."""
    monkeypatch.delenv("VFA_FUSED_STEM", raising=False)
    torch.manual_seed(0)
    plain, fused = ResNetGN((1, 1, 1, 1)), ResNetGN((1, 1, 1, 1), fused_stem=True)
    assert list(fused.state_dict()) == list(plain.state_dict())
    fused.load_state_dict(plain.state_dict(), strict=True)
    assert fused.fused_stem_on() and not plain.fused_stem_on()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 3, 32, 48)).astype(np.float32))
    grads = []
    for net in (plain, fused):
        feats = net(x)
        sum((f ** 2).sum() for f in feats).backward()
        grads.append((feats, {k: p.grad.clone() for k, p in net.named_parameters()}))
    for a, b in zip(grads[0][0], grads[1][0]):
        assert torch.equal(a, b)
    for k, ga in grads[0][1].items():
        np.testing.assert_allclose(grads[1][1][k].numpy(), ga.numpy(),
                                   rtol=1e-4, atol=1e-4 * float(ga.abs().max()))
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    assert plain.fused_stem_on()
    monkeypatch.setenv("VFA_FUSED_STEM", "0")
    assert not fused.fused_stem_on()
