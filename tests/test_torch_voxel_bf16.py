"""The reference voxel route (rig=None) in bf16 against the JAX package, on
the CPU.

JAX's bf16 integral image is `jnp.cumsum` twice, which XLA runs as a
blocked scan with every add rounded to bf16; `torch.cumsum` accumulates in
fp32 and rounds only its outputs, and agrees on about 59 % of the elements.
The box mean lt + rb - rt - lb cancels large integral-image values, so the
route is held bit for bit where it can be: the port's
`ops/voxel.py::blocked_cumsum`, the integral image and its backward (JAX's
transpose) and `sample_voxels` equal JAX's bits. The whole model then
differs only where the two frameworks' convolutions and norms round
differently, and is held at the bf16 bounds of test_torch_bf16.py (serving)
and test_torch_bf16_train.py (a mixed-precision step): the gradient that
reaches the bf16 integral image is scattered by four `torch.gather`
backwards, which add in torch's order, not XLA's.

F7 (ROADMAP Queue 3) is the reference's own distance between its bf16 and
fp32 routes, which the port reproduces: `test_f7_bf16_route_is_far_from_fp32`
pins it."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu import geometry as jgeo
from vfa_tpu.config import TrainConfig, mc_opts, mx_opts, wt_opts
from vfa_tpu.convert import convert_state_dict
from vfa_tpu.data.synthetic import make_calibrations, make_scene, tiny_config
from vfa_tpu.ops import voxel as jvox
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
from vfa_tpu_torch.ops import voxel as tvox

from test_torch_bf16 import BUDGET_L2, BUDGET_MAX, _bf16, _perturb, _random_stats, _within
from test_torch_bf16_train import (
    LOSS_REL, NOISE_RATIO, PARAM_L2, STATS_TOL, ZERO_GRAD, _train_against_jax,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def port_weights_for_jax(jmodel, *init_args):
    """The port's seeded init (`init_weights`, seed 0, of the tiny
    MultiviewC model) as variables of the flax model `jmodel`: flax's tree
    from `jax.eval_shape` of its init, filled by the reference-checkpoint
    mapping `vfa_tpu.convert.convert_state_dict`. The same weights on both
    sides without running flax's init (23 s eager, 7 s jitted on the CPU)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *init_args)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = init_weights(VFANet(t_tiny_config(get_config("MultiviewC"))),
                         torch.Generator().manual_seed(0)).state_dict()
    params, stats = convert_state_dict(state, zeros["params"], zeros["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _bits(j) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (bf16 or fp32)."""
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return t.to(torch.bfloat16) if j.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("n", [9, 20, 90, 160, 640, 1280])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_blocked_cumsum_matches_jax(n, reverse):
    """One axis, forward and reverse (JAX's transpose of cumsum), at
    lengths inside one block, padded, and over two levels (640, 1280)."""
    x = np.random.default_rng(n).normal(size=(4, n)).astype(np.float32)
    j, t = _bf16(x)
    want = _bits(jax.lax.cumsum(j, axis=1, reverse=reverse))
    got = tvox.blocked_cumsum(t, -1, reverse=reverse)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    if n > tvox.SCAN_BLOCK:        # torch's rounding is another
        assert not torch.equal(torch.cumsum(t, -1) if not reverse else
                               torch.cumsum(t.flip(-1), -1).flip(-1), want)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 45, 640), (8, 90, 160)], ids=str)
def test_integral_image_and_backward_match_jax(shape, monkeypatch):
    """The bf16 integral image and its backward equal `jvox.integral_image`
    and its `jax.vjp` bit for bit, and never go through torch.cumsum."""
    rng = np.random.default_rng(sum(shape))
    jx, tx = _bf16(np.abs(rng.normal(size=shape)).astype(np.float32))
    jg, tg = _bf16(rng.normal(size=shape).astype(np.float32))
    want, vjp = jax.vjp(jvox.integral_image, jx)
    (want_dx,) = vjp(jg)

    def refuse(*a, **k):
        raise AssertionError("a bf16 integral image went through torch.cumsum")

    monkeypatch.setattr(torch, "cumsum", refuse)
    tx.requires_grad_()
    got = tvox.integral_image(tx)
    (dx,) = torch.autograd.grad(got, tx, tg)
    assert got.dtype == dx.dtype == torch.bfloat16
    assert torch.equal(got, _bits(want)) and torch.equal(dx, _bits(want_dx))


def _geometry(cfg, tiny: bool):
    """The config and one camera's boxes (the port's `voxel_boxes`, held
    to JAX's by tests/test_torch_voxel.py), as numpy."""
    tc = tiny_config(cfg) if tiny else cfg
    grid = jgeo.make_grid(tc.world_size, tc.cube_size[:2], tc.name)
    calib = make_calibrations(tc, 1)[0]
    boxes = tvox.voxel_boxes(torch.from_numpy(calib), torch.from_numpy(grid),
                             dataset=tc.name, grid_height=tc.grid_h,
                             cube_size=tc.cube_size, image_size=tc.image_size)
    return tc, boxes.numpy()


@pytest.mark.parametrize("cfg,tiny", [(mc_opts, True), (mx_opts, True), (wt_opts, True),
                                      (mc_opts, False)],
                         ids=["MultiviewC", "MultiviewX", "Wildtrack", "MultiviewC-full"])
def test_sample_voxels_bf16_matches_jax(cfg, tiny):
    """bf16 `sample_voxels` (fp32 out: the bf16 taps meet fp32 weights)
    equals JAX's op by op, bit for bit, on the tiny configs and on the full
    MultiviewC boxes (5, 156, 156) over a (8, 90, 160) feature map."""
    tc, boxes = _geometry(cfg, tiny)
    C, fh, fw = 8, tc.resize_size[0] // 8, tc.resize_size[1] // 8
    jf, tf = _bf16(np.random.default_rng(2).normal(size=(C, fh, fw)).astype(np.float32))
    want = np.asarray(jvox.sample_voxels(jf, jnp.asarray(boxes)))
    got = tvox.sample_voxels(tf, torch.from_numpy(boxes))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0


def test_f7_bf16_route_is_far_from_fp32():
    """F7: on the same features, JAX's bf16 `sample_voxels` is far from its
    fp32 one (measured 6.1 % of max |vox| at tiny MultiviewC), and the port
    carries the same distance, since it reproduces the bf16 route bit for
    bit; the fp32 routes agree at tests/test_voxel.py's 1e-4."""
    tc, boxes = _geometry(mc_opts, True)
    C, fh, fw = 16, tc.resize_size[0] // 8, tc.resize_size[1] // 8
    x = np.abs(np.random.default_rng(5).normal(size=(C, fh, fw))).astype(np.float32)
    jf, tf = _bf16(x)
    j16 = np.asarray(jvox.sample_voxels(jf, jnp.asarray(boxes)))
    j32 = np.asarray(jvox.sample_voxels(jf.astype(jnp.float32), jnp.asarray(boxes)))
    t32 = tvox.sample_voxels(tf.float(), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(t32, j32, rtol=1e-4, atol=1e-4)
    f7 = np.abs(j16 - j32).max() / np.abs(j32).max()
    port = np.abs(tvox.sample_voxels(tf, torch.from_numpy(boxes)).numpy() - t32).max()
    assert f7 > 1e-2 and port / np.abs(t32).max() == pytest.approx(f7, rel=1e-3)


def _jax_laterals(mdl, images):
    """JAX's three lateral maps of `images` (B, N, H, W, 3), NHWC, as its
    `bev_features` computes them (`vfa_tpu/model/vfanet.py:145-158`)."""
    x = images.reshape(-1, *images.shape[2:])
    mean = jnp.asarray((0.485, 0.456, 0.406), dtype=x.dtype)
    std = jnp.asarray((0.229, 0.224, 0.225), dtype=x.dtype)
    f8, f16, f32 = mdl.backbone((x - mean) / std)
    return [jax.nn.relu(bn(lat(f))) for f, lat, bn in
            ((f8, mdl.lat8, mdl.bn8), (f16, mdl.lat16, mdl.bn16), (f32, mdl.lat32, mdl.bn32))]


@pytest.mark.medium
def test_bf16_voxel_route_serving_forward_matches_jax():
    """The tiny serving forward with rig=None in bf16: JAX with every fp32
    variable cast to bf16 as `bench.py:260-263` does, against the port's
    VFANet after `cast_model`, bf16 images.

    The route itself on JAX's own bf16 laterals: the port's BEV features
    (the collapse in fp32, the bf16 weights widened, the fp32 camera and
    scale sums, one cast) against JAX's jitted `bev_features`, within one
    bf16 ulp of the final cast and 1e-4 of the max: XLA fuses the fp32
    arithmetic of the taps (JAX's jitted `sample_voxels` is 6e-5 of its
    max from its own op-by-op one, which the port equals bit for bit); on
    the same laterals, op by op, the route is 5e-7 of the max from JAX's
    (measured).
    The whole forward at test_torch_bf16.py's bf16 budget (0.03 / 0.03;
    measured heatmap 2.7e-2 max, 1.7e-2 rel-L2; loc_offset 2.5e-2 rel-L2),
    not at its tighter MODEL_MAX / MODEL_L2 of the rig route: the two
    frameworks' backbones already give other bf16 bits in 41-44 % of the
    laterals (measured; rel-L2 1.0-1.3e-2), and the bf16 integral image's
    cancellation (F7) amplifies those flips more than the rig route does."""
    rng = np.random.default_rng(11)
    tc = tiny_config(mc_opts)
    scenes = [make_scene(tc, seed=s, num_objects=3) for s in range(2)]
    images = np.stack([s.images for s in scenes])
    calibs = np.stack([s.calibs for s in scenes])
    grid = scenes[0].grid
    jmodel = create_model(tc, TrainConfig(pretrained=False))
    variables = port_weights_for_jax(jmodel, jnp.asarray(images), jnp.asarray(calibs),
                                     jnp.asarray(grid))
    params = _perturb(variables["params"], rng)
    stats = _random_stats(variables["batch_stats"], rng)
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                                   {"params": params, "batch_stats": stats})
    jimages, timages = _bf16(images)
    jargs = (jnp.asarray(calibs), jnp.asarray(grid))
    want, jbev, jlats = jax.jit(lambda v, i: (
        jmodel.apply(v, i, *jargs),
        jmodel.apply(v, i, *jargs, method=jmodel.bev_features),
        jmodel.apply(v, i, method=_jax_laterals)))(jvars, jimages)

    model = VFANet(t_tiny_config(get_config("MultiviewC")))
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    model = cast_model(model, torch.bfloat16).eval()
    tcalibs, tgrid = torch.from_numpy(calibs), torch.from_numpy(grid)
    with torch.no_grad():
        got = model(timages, None, tcalibs, tgrid)
        lats = [_bits(lat).permute(0, 3, 1, 2).contiguous() for lat in jlats]
        bev = model.voxel_bev(lats, tcalibs, tgrid)
    w = _bits(jbev).float()
    assert bev.dtype == torch.float32 and bev.shape == w.shape
    bound = 2.0 ** -7 * w.abs() + 1e-4 * float(w.abs().max())
    assert ((bev.to(torch.bfloat16).float() - w).abs() <= bound).all()
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key].astype(jnp.float32))
        g = got[key].float().numpy()
        assert got[key].dtype == torch.bfloat16 and g.shape == w.shape, key
        _within(g, w, BUDGET_MAX, BUDGET_L2)


@pytest.mark.medium
def test_bf16_voxel_route_train_step_matches_jax():
    """One mixed-precision train step with rig=None (fp32 masters cast at
    use through `torch.func.functional_call`, each camera recomputed in the
    backward on the call's bf16 casts), then a bf16 eval step, against
    JAX's, at test_torch_bf16_train.py's bounds: losses and eval losses
    LOSS_REL, running statistics STATS_TOL, each parameter after the
    integral image (collapse, fuse block, heads) within PARAM_L2 of JAX's
    update (measured at most 0.20, fuse.1.bias).

    Upstream of the integral image the update is F7's (ROADMAP Queue 3):
    the backward's bf16 suffix sums of the corners' gradient cancel, and
    their rounding is a large share of the backbone's gradient on both
    sides. JAX's own bf16 update is 1.68e-2 from its fp32 update (rel-L2
    of all parameters, of a 5.3e-2 update), the port's 1.04e-2 from its
    own (the gradient reaches the bf16 integral image through four
    `torch.gather` backwards, which add in torch's order, not XLA's), and
    the two bf16 updates 1.96e-2 apart: independent rounding noise. So
    the yardstick of NOISE_RATIO is both sides' bf16 rounding, the hypot
    of the two distances, for all parameters as one vector (measured 0.99
    of it) and for each backbone and lateral parameter (measured at most
    1.19, base.layer1.1.bn2.weight; against JAX's own update they reach
    1.10 of its size, past PARAM_L2). The eval after the step runs that
    backbone: its losses within LOSS_REL of JAX's plus NOISE_RATIO of both
    sides' bf16-vs-fp32 eval distance (measured at most 0.58 of the bound,
    loss_hwl: the port's 1.5 % above its fp32 model's, JAX's 1.5 % below)."""
    init = lambda m: types.SimpleNamespace(
        init=lambda key, *args, train: port_weights_for_jax(m, *args))
    records, stats, evals = _train_against_jax(1, layout=None, jax_fp32=True,
                                               jax_init=init)
    for k, (got, want) in stats.items():
        assert np.abs(got - want).max() <= STATS_TOL * np.abs(want).max(), k
    ((tld, jld, upd_t, upd_j, upd_32, upd_j32),) = records
    assert set(tld) == set(jld)
    for k in jld:
        assert tld[k] == pytest.approx(jld[k], rel=LOSS_REL, abs=1e-6), k
    l2 = lambda a: float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in a)))

    def noise(keys):
        return np.hypot(l2([upd_t[k] - upd_32[k] for k in keys]),
                        l2([upd_j[k] - upd_j32[k] for k in keys]))

    keys = [k for k in upd_j if k not in ZERO_GRAD]
    assert l2([upd_t[k] - upd_j[k] for k in keys]) <= NOISE_RATIO * noise(keys)
    for k in keys:
        if k.split(".")[0] in ("base", "lat8", "lat16", "lat32", "bn8", "bn16", "bn32"):
            assert l2([upd_t[k] - upd_j[k]]) <= NOISE_RATIO * noise([k]), k
        else:
            assert l2([upd_t[k] - upd_j[k]]) <= PARAM_L2 * l2([upd_j[k]]), k
    # the eval after the step runs the updated backbone: LOSS_REL of the
    # forward's drift plus NOISE_RATIO of both sides' bf16-vs-fp32 eval
    # distance (the F7 noise the update carried)
    t, j, t32, j32 = evals
    for k in j:
        assert abs(t[k] - j[k]) <= LOSS_REL * abs(j[k]) + NOISE_RATIO * np.hypot(
            t[k] - t32[k], j[k] - j32[k]), k
