"""The port's data-parallel and camera-split training (`parallel.py`) in
2 gloo ranks on the CPU (spawned once for the module, `launch.run_ranks`)
against JAX's one-process step from the same weights, and
`camera_psum_bev` against JAX's on the 8-device CPU mesh."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_parallel_cases as cases
from vfa_tpu_torch import parallel
from vfa_tpu_torch.convert import params_from_jax
from vfa_tpu_torch.launch import run_ranks

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = __import__("os").path.dirname(__file__)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every scenario of `cases.dp_rank`, from JAX's
    initial weights (`params_from_jax`), and JAX's one-process steps of
    those scenarios on the global batches, taken while the ranks run."""
    variables = cases.jax_init()
    init = params_from_jax(*variables)
    path = str(tmp_path_factory.mktemp("dp") / "init.pt")
    torch.save(init, path)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, "test_torch_parallel_cases:dp_rank", 2,
                            args=(path,), pythonpath=[HERE], threads=2)
        want = {k: cases.jax_step(variables, *v) for k, v in cases.dp_steps().items()}
        return {"ranks": [r["result"] for r in ranks.result()], "jax": want,
                "init": init}


@pytest.mark.parametrize("case", ["data2", "cam2", "cam2rig"])
def test_sharded_step_matches_one_process(runs, case):
    """A (data 2) step through the window rig, and (data 1 x cam 2) steps
    through the voxel route and through the rig cut to each rank's cameras
    (`parallel.camera_rig`), each rank on its part of the batch
    (`shard_train_step`), equal JAX's one-process step on the global batch
    from the same weights: loss rel 2e-4, params rtol 2e-3 / atol 2e-5
    (`tests/test_parallel.py:66-72`), and the update (`cases.check_step`);
    both ranks hold the same parameters after it."""
    for r in runs["ranks"]:
        loss, got, _ = r[case]
        cases.check_step((loss, got), runs["jax"][case], runs["init"],
                         loss_rel=2e-4, rtol=2e-3, atol=2e-5)
    a, b = (r[case][1] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_camera_psum_bev_matches_jax(runs):
    """camera_psum_bev over cam 2 equals the one-process camera sum of the
    port's voxel route at rtol 1e-5 / atol 1e-6 (the all-reduce adds two
    fp32 partials), and JAX's camera_psum_bev on its (data 2, cam 4) mesh
    of 8 CPU devices (under jit) at the voxel op's port-vs-JAX tolerance,
    rtol / atol 1e-4 (tests/test_torch_voxel.py: the integral image's
    lt + rb - rt - lb cancels in another order)."""
    import jax
    import jax.numpy as jnp

    from vfa_tpu.geometry import make_grid
    from vfa_tpu.ops.voxel import voxel_boxes
    from vfa_tpu.parallel import camera_psum_bev, make_mesh

    from vfa_tpu_torch.ops.voxel import sample_voxels

    tc, lats, calibs, kernel, bias = cases.psum_inputs()
    boxes_t = cases.psum_boxes(tc, calibs)
    one = sum(torch.relu(sample_voxels(torch.from_numpy(lat), bx) @ torch.from_numpy(kernel)
                         + torch.from_numpy(bias))
              for lat, bx in zip(lats, boxes_t))
    grid = jnp.asarray(make_grid(tc.world_size, tc.cube_size[:2], tc.name))
    boxes = jax.vmap(lambda c: voxel_boxes(
        c, grid, dataset=tc.name, grid_height=tc.grid_h,
        cube_size=tc.cube_size, image_size=tc.image_size))(jnp.asarray(calibs))
    np.testing.assert_array_equal(np.asarray(boxes), boxes_t.numpy())
    mesh = make_mesh(data=2, cam=4)
    want = jax.jit(lambda *a: camera_psum_bev(mesh, *a))(
        jnp.asarray(lats), boxes, jnp.asarray(kernel), jnp.asarray(bias))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["psum"].numpy(), one.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["psum"].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_one_rank_mesh_and_batch_sharding():
    """Without a process group a mesh is one rank (no collective); the
    strided frame shards partition a dataset; shard_batch keeps a rank's
    scenes and cameras."""
    mesh = parallel.make_mesh()
    assert (mesh.size("data"), mesh.size("cam"), mesh.group("data")) == (1, 1, None)
    for n in (1, 7, 16):
        for pc in (1, 2, 3):
            got = np.sort(np.concatenate([parallel.process_local_indices(n, p, pc)
                                          for p in range(pc)]))
            np.testing.assert_array_equal(got, np.arange(n))
    mesh.shape, mesh.coords = (2, 2), (1, 0)        # rank 2 of a 2x2 mesh
    batch = {"images": np.arange(4 * 4).reshape(4, 4), "calibs": np.zeros((4, 4, 3)),
             "heatmap": np.arange(4), "grid": np.ones(3), "objects": [0, 1, 2, 3]}
    part = parallel.shard_batch(batch, mesh)
    np.testing.assert_array_equal(part["images"], [[8, 9], [12, 13]])
    assert part["objects"] == [2, 3] and part["calibs"].shape == (2, 2, 3)
    np.testing.assert_array_equal(part["grid"], batch["grid"])
    assert parallel.backend_for("cpu", 2)[0] == "gloo"
