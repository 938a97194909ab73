"""BEV-grid spatial sharding of the port (`parallel_bev.py`): the stacked
slab rig byte-equal to JAX's `build_bev_sharded_rig`, and, in 4 gloo ranks
on the CPU (spawned once for the module), slab-sharded sampling with its
gradients against the full rig, and the full-model BEV-sharded train step
against JAX's one-process step from the same weights."""

import contextlib
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_parallel_cases as cases
from vfa_tpu_torch import parallel_bev
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.launch import run_ranks
from vfa_tpu_torch.ops.rig import build_rig, window_dii_index
from vfa_tpu_torch.ops.rig_cuda import rig_sample_scale_cuda

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = __import__("os").path.dirname(__file__)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' results of `cases.bev_rank`, its steps from JAX's
    initial weights (`params_from_jax`), and JAX's one-process steps of
    those steps, taken while the ranks run."""
    variables = cases.jax_init()
    init = params_from_jax(*variables)
    path = str(tmp_path_factory.mktemp("bev") / "init.pt")
    torch.save(init, path)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, "test_torch_parallel_cases:bev_rank", 4,
                            args=(path,), pythonpath=[HERE], threads=1)
        want = {k: cases.jax_step(variables, *v) for k, v in cases.bev_steps().items()}
        return {"ranks": [r["result"] for r in ranks.result()], "jax": want,
                "init": init}


@contextlib.contextmanager
def one_thread():
    """The ranks' intra-op thread count, for the port's one-process
    reference: at the tiny config the backbone's GroupNorms on 3x5 maps
    amplify the summation order of the CPU conv kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_bev_sharded_rig_byte_equal_to_jax():
    """A, starts, inv_perm and the window dims of every scale equal JAX's
    (tests/test_parallel_bev.py:26-37's settings: tiny, fp32, tile_v 16,
    band_buckets 2, 4 shards); a slab's dII order is the unified buckets'."""
    import jax.numpy as jnp

    from vfa_tpu.parallel_bev import build_bev_sharded_rig as jax_build
    from vfa_tpu.config import mc_opts
    from vfa_tpu.data.synthetic import tiny_config as jax_tiny

    tc, calibs, grid, shapes, *_ = cases.bev_setup()
    got = parallel_bev.build_bev_sharded_rig(calibs, tc, grid, shapes, num_shards=4,
                                             dtype=torch.float32, **cases.RIG)
    want = jax_build(calibs, jax_tiny(mc_opts), grid, shapes, num_shards=4,
                     tile_v=16, dtype=jnp.float32, band_buckets=2)
    assert (got.grid_shape, got.slab_rows, got.num_shards) == (
        tuple(want.grid_shape), want.slab_rows, want.num_shards)
    for g, w in zip(got.scales, want.scales):
        assert g.window_hw == tuple(tuple(int(x) for x in hw) for hw in w.window_hw)
        assert len(g.A) == len(w.A)
        for a, b in zip(g.A, w.A):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        for a, b in zip(g.starts, w.starts):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        np.testing.assert_array_equal(g.inv_perm.numpy(), np.asarray(w.inv_perm))
    rank2 = types.SimpleNamespace(index=lambda axis: 2, group=lambda axis: None)
    slab = got.slab(rank2, "cpu")                     # slab 2 of 4
    sr = slab.scales[0]
    assert (slab.rows.index, slab.rows.count, sr.A[0].shape) == (2, 4, got.scales[0].A[0].shape[1:])
    Hp, Wp = -(-sr.feat_hw[0] // 8) * 8, -(-sr.feat_hw[1] // 16) * 16
    for s_b, win, order in zip(sr.starts, sr.window_hw, sr.dii_order):
        for a, b in zip(order, window_dii_index(s_b, win, Hp, Wp)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_sharded_sampling_and_grads_equal_full_rig(runs):
    """Slab-sharded sampling over 4 ranks, gathered, and the gradients of
    sum(out * w) in the features (dII summed over the slabs) and the
    collapses equal the full window rig's at rtol / atol 1e-5
    (tests/test_parallel_bev.py:71)."""
    tc, calibs, grid, shapes, lats, kernels, biases = cases.bev_setup()
    full = build_rig(calibs, tc, grid, shapes, device="cpu", **cases.RIG)
    L, W = grid.shape[:2]

    def unsharded(lats, kernels, biases):
        out = 0
        for sr, lat, k, b in zip(full.scales, lats, kernels, biases):
            out = out + rig_sample_scale_cuda(lat, sr, k, b, out_dtype=torch.float32,
                                              camera_sum=True)
        return out.reshape(2, L, W, 256)

    w = np.random.default_rng(1).normal(size=(2, L, W, 256)).astype(np.float32)
    want = cases.bev_sample(full, lats, kernels, biases, w, unsharded)
    for r in runs["ranks"]:
        out, glat, gker = r["sample"]
        np.testing.assert_allclose(out.numpy(), want[0].numpy(), rtol=1e-5, atol=1e-5)
        for a, b in zip(glat + gker, want[1] + want[2]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor,B", [(8, 2), (16, 1)], ids=["grid19-B2", "grid9-B1"])
def test_bev_sharded_train_step_matches_unsharded(runs, factor, B):
    """The full model's train step (forward, halos, cross-slab BatchNorm
    and GroupNorm statistics, loss on the gathered predictions, backward,
    SGD) on 4 slabs equals JAX's unsharded one-process step from the same
    weights, on every rank: loss rel 1e-5, parameters rtol 1e-4 / atol
    1e-5 (tests/test_parallel_bev.py:147-154), and the update
    (`cases.check_step`). The eval-mode (serving) heatmap before it equals
    the port's unsharded forward's at the same bounds."""
    cfg, batch, rig = cases.step_setup(factor, B)
    with one_thread():
        want_heat = cases.train_step(cfg, batch, rig, lr=0.02, state=runs["init"])[2]
    for r in runs["ranks"]:
        loss, got, heat = r[f"step{factor}"]
        cases.check_step((loss, got), runs["jax"][f"step{factor}"], runs["init"],
                         loss_rel=1e-5, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(heat.numpy(), want_heat.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_row_slab_halo_and_gather_one_process():
    """Without a group a RowSlab is the whole plane: the halo is the conv's
    zero padding, the mask and the gather leave x as it is."""
    x = torch.randn(2, 3, 5, 4)
    rows = parallel_bev.RowSlab(None, 0, 1, 5, 5)
    torch.testing.assert_close(rows.halo(x, 2), torch.nn.functional.pad(x, (0, 0, 2, 2)))
    assert rows.gather(x) is x and rows.mask(x) is x
    part = parallel_bev.RowSlab(None, 1, 2, 3, 5)   # rows 3..5 of 5: one padding row
    assert part.valid == 2
    assert float(part.mask(torch.ones(1, 1, 3, 1))[0, 0, 2, 0]) == 0.0
