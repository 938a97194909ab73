"""The port's training path on the CPU against the JAX package: the
OneCycle schedules and the SGD update, train steps on tiny MultiviewC (3D)
and tiny Wildtrack (2D) with the weights carried across by
`params_from_jax`, and the train CLI."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu import train_lib as jtl
from vfa_tpu.config import TrainConfig as JTrainConfig
from vfa_tpu.config import mc_opts, wt_opts
from vfa_tpu.data.synthetic import tiny_config
from vfa_tpu.ops.rig import build_rig as jax_build_rig
from vfa_tpu.ops.rig import pyramid_feat_shapes

from vfa_tpu_torch import train as train_cli
from vfa_tpu_torch import train_lib as ttl
from vfa_tpu_torch.config import TrainConfig, get_config
from vfa_tpu_torch.convert import named_jax_leaves, params_from_jax
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
from vfa_tpu_torch.model.vfanet import VFANet
from vfa_tpu_torch.ops.rig import build_rig
from vfa_tpu_torch.ops.rig_cuda import (
    rig_flat_bwd, rig_flat_fwd, rig_window_bwd, rig_window_fwd,
)
from vfa_tpu_torch.ops.stem import stem_bwd_dx, stem_bwd_stats

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    """The train CLI writes its runs (checkpoints, metrics) under
    `experiments/` of the working directory: a temporary one here."""
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
def test_build_config_matches_jax(tiny, monkeypatch):
    """The train CLI's DatasetConfig and TrainConfig equal the root
    `train.py`'s for the same argv: every geometry override, --mode,
    --loss_weight, --cls_thresh, --topk, --vis_iter and the recipe flags
    (then --tiny shrinks the overridden config, in both)."""
    import dataclasses
    import sys

    import train as jtrain

    argv = ["--data", "MultiviewC", "--mode", "3D", "--world_size", "300", "400",
            "--image_size", "360", "640", "--resize_size", "180", "320",
            "--grid_h", "150", "--cube_size", "20", "20", "30",
            "--loss_weight", "1", "2", "3", "4", "--cls_thresh", "0.6",
            "--topk", "30", "--vis_iter", "7", "-b", "3", "--lr", "0.01",
            "-e", "5", "--seed", "3", "--root", "/data/mc"] + (["--tiny"] if tiny else [])
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jcfg, jtcfg = jtrain.build_config(jtrain.parse_args())
    cfg, tcfg = train_cli.build_config(train_cli.parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    assert cfg.loss_weight == (1.0, 2.0, 3.0, 4.0) and tcfg.vis_iter == 7


def test_train_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


@pytest.mark.parametrize("per_epoch", [True, False], ids=["per_epoch", "per_iter"])
@pytest.mark.parametrize("cycle_momentum", [True, False],
                         ids=["cycle_momentum", "no_cycle_momentum"])
def test_schedules_match_jax_over_a_cycle(per_epoch, cycle_momentum):
    """LR and momentum of every optimizer step of a whole cycle (JAX
    evaluates the cosines in fp32: rtol 1e-5)."""
    kw = dict(epochs=7, lr=0.03, momentum=0.4, pretrained=False,
              scheduler_step_per_epoch=per_epoch, cycle_momentum=cycle_momentum)
    spe = 5
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jlr, jmom = jtl.onecycle_schedule(jcfg, spe), jtl.momentum_schedule(jcfg, spe)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ttl.ScheduledSGD([p], tcfg, spe)
    for count in range(spe * kw["epochs"]):
        t = count // spe + 1 if per_epoch else count
        p.grad = torch.ones(3)
        opt.step()
        assert opt.count == count + 1
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jlr(t)), rtol=1e-5)
        np.testing.assert_allclose(opt.param_groups[0]["momentum"], float(jmom(t)),
                                   rtol=1e-5)
        np.testing.assert_allclose(ttl.current_lr(tcfg, spe, count),
                                   jtl.current_lr(jcfg, spe, count), rtol=1e-5)


def test_sgd_update_matches_jax_optimizer():
    """g = grad + wd*p; buf = m(t)*buf + g; p -= lr(t)*buf over 6 steps."""
    rng = np.random.default_rng(0)
    kw = dict(epochs=3, lr=0.05, weight_decay=1e-2, pretrained=False,
              scheduler_step_per_epoch=False)
    p0 = rng.normal(size=(4, 5)).astype(np.float32)
    grads = rng.normal(size=(6, 4, 5)).astype(np.float32)
    tx = jtl.make_optimizer(JTrainConfig(**kw), 2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttl.ScheduledSGD([p], TrainConfig(**kw), 2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = jp + upd
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-7)


def _launches():
    return tuple(fn.launches for fn in (
        rig_window_fwd, rig_window_bwd, rig_flat_fwd, rig_flat_bwd,
        stem_bwd_stats, stem_bwd_dx))


def jitted_init(model):
    """`model` for `vfa_tpu.train_lib.init_state`, which calls only its
    `init`: jitted here, the same values as flax's eager init (checked on
    the tiny MultiviewC model) in a third of the time on the CPU."""
    return types.SimpleNamespace(init=jax.jit(model.init, static_argnames="train"))


def _train_against_jax(cfg, steps, layout="window"):
    """`steps` train steps then one eval step, both packages, same weights
    and batches. JAX samples with rig_impl='pallas' (the Pallas kernels and
    their hand-written VJP, interpreted on the CPU); layout=None samples
    through the voxel route on both sides. Both packages read
    VFA_FUSED_STEM when they build the stem."""
    jc = tiny_config(cfg)
    tc = t_tiny_config(get_config(cfg.name))
    # the recipe's lr 0.02 over 40 epochs, stepped per iteration so that lr
    # and momentum move between the steps (lr 8.0e-4, then 8.9e-4)
    kw = dict(epochs=40, batch_size=2, pretrained=False,
              scheduler_step_per_epoch=False)
    jtcfg, ttcfg = JTrainConfig(**kw), TrainConfig(**kw)
    loader = SyntheticSceneLoader(tc, num_frames=2 * steps, batch_size=2,
                                  max_objects=8, seed=3, num_objects=3)
    batches = [{k: v for k, v in b.items() if k not in ("objects", "index", "frame")}
               for b in loader]
    shapes = pyramid_feat_shapes(jc.resize_size)
    calibs, grid = loader.scenes[0].calibs, loader.scenes[0].grid

    jmodel = jtl.create_model(jc, jtcfg, rig_impl="pallas")
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    state, tx = jtl.init_state(jitted_init(jmodel), jc, jtcfg, jax.random.PRNGKey(0),
                               steps, jb0)
    jrig = layout and jax_build_rig(calibs, jc, grid, shapes, tile_v=16,
                                    dtype=jnp.float32, band_buckets=3,
                                    layout=layout)
    jstep = jtl.make_train_step(jmodel, tx, jc, jtcfg, dim_mean=loader.dim_mean)
    jeval = jtl.make_eval_step(jmodel, jc, dim_mean=loader.dim_mean)

    model = VFANet(tc)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, state.params),
        jax.tree_util.tree_map(np.array, state.batch_stats)), strict=True)
    trig = layout and build_rig(calibs, tc, grid, shapes, tile_v=16,
                                dtype=torch.float32, band_buckets=3,
                                layout=layout, device="cpu")
    opt = ttl.make_optimizer(model, ttcfg, steps)
    tstep = ttl.make_train_step(model, opt, tc, ttcfg, dim_mean=loader.dim_mean)
    teval = ttl.make_eval_step(model, tc, dim_mean=loader.dim_mean)

    def jax_named(state):
        return named_jax_leaves(
            jax.tree_util.tree_map(np.array, state.params),
            jax.tree_util.tree_map(np.array, state.batch_stats))

    launches = _launches()
    for b in batches:
        before_j = jax_named(state)
        before_t = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
        state, jld = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, jrig)
        tld = tstep(ttl.batch_to_device(b, "cpu"), trig)
        # each step's update, relative to the parameter's largest update: a
        # wrong gradient is off by its own size; 0.25 leaves room for a ReLU
        # or max-pool that a 1e-6 difference tips the other way on the 3x5
        # maps of the tiny backbone (seen: 5 % of one kernel's update)
        after_j = jax_named(state)
        for k, v in model.named_parameters():
            dj = after_j[k] - before_j[k]
            dt = v.detach().numpy() - before_t[k]
            assert np.abs(dt - dj).max() <= 0.25 * np.abs(dj).max() + 1e-8, k
        assert set(tld) == set(jld)
        for k in jld:
            assert float(tld[k]) == pytest.approx(float(jld[k]), rel=1e-4, abs=1e-6), k
    assert _launches() == launches
    assert opt.count == steps and model.training

    want = jax_named(state)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k in want:
        if "running_" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1e-5, err_msg=k)
    assert all(int(v) == steps for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked"))

    jld, _ = jeval(state, {k: jnp.asarray(v) for k, v in batches[0].items()}, jrig)
    tld, pred = teval(ttl.batch_to_device(batches[0], "cpu"), trig)
    assert not model.training
    for k in jld:
        assert float(tld[k]) == pytest.approx(float(jld[k]), rel=1e-3, abs=1e-6), k
    return pred


@pytest.mark.medium
def test_two_train_steps_match_jax_multiviewc_3d():
    pred = _train_against_jax(mc_opts, steps=2)
    assert set(pred) == {"heatmap", "loc_offset", "dim_offset", "rotation"}


@pytest.mark.medium
def test_two_train_steps_match_jax_flat_rig_fused_stem(monkeypatch):
    """The slice as a whole: flat rig layout and the fused stem on both
    sides (JAX: the Pallas flat kernels and the stem's custom VJP; the port:
    `RigScaleTiles` on the flat rig and `gn_relu_pool`, plain versions on
    the CPU). Loss rel 1e-4, parameters rtol 5e-3 / atol 1e-5."""
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    from vfa_tpu_torch.ops import stem

    calls = []
    monkeypatch.setattr(stem, "gn_relu_pool_bwd",
                        lambda *a, _f=stem.gn_relu_pool_bwd: calls.append(1) or _f(*a))
    pred = _train_against_jax(mc_opts, steps=2, layout="flat")
    assert len(calls) == 2          # the fused stem's backward ran each step
    assert set(pred) == {"heatmap", "loc_offset", "dim_offset", "rotation"}


def test_train_cli_no_rig_tiny_cpu(capsys):
    """--no_rig trains without building a rig."""
    out = train_cli.main(TINY + ["--synthetic_frames", "2", "--no_rig"])
    assert "compiled rig" not in capsys.readouterr().out
    assert out["rig"] is None and len(out["losses"]) == 2
    assert all(np.isfinite(d["loss"]) for d in out["losses"] + out["val_losses"])


@pytest.mark.medium
def test_one_train_step_matches_jax_wildtrack_2d():
    pred = _train_against_jax(wt_opts, steps=1)
    assert set(pred) == {"heatmap", "loc_offset"}


def test_batchnorm_running_variance_is_biased_like_flax():
    """On a tiny grid (few cells) the biased and unbiased batch variances
    differ most: the port's BatchNorm must leave flax's running stats."""
    import flax.linen as nn

    from vfa_tpu_torch.model.vfanet import BatchNorm2dBiased

    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 2, 2, 6)).astype(np.float32) * 3 + 1   # NHWC, 4 cells
    bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    want_y, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                           mutable=["batch_stats"])
    tbn = BatchNorm2dBiased(6, eps=1e-5, momentum=0.1).train()
    got_y = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-7)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 6).var(0, ddof=1)
    assert np.abs(tbn.running_var.numpy() - unbiased).max() > 1e-2
    assert int(tbn.num_batches_tracked) == 1
    tbn.eval()
    y_eval = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not torch.allclose(y_eval.permute(0, 2, 3, 1), got_y)


TINY = ["--data", "MultiviewC", "--synthetic", "--tiny", "-e", "1",
        "--pretrained", "0", "--no_augment", "--device", "cpu", "--vis_iter", "0"]


def test_train_cli_flat_rig_fused_stem_tiny_cpu(capsys, monkeypatch):
    """`--rig_layout flat` with VFA_FUSED_STEM=1 trains on the CPU and gives
    the window layout's losses with the unfused stem (same seed; the layouts
    regroup the same weights, the fused stem is the same function)."""
    argv = TINY + ["--synthetic_frames", "4", "-b", "2"]
    monkeypatch.setenv("VFA_FUSED_STEM", "0")
    want = train_cli.main(argv)
    capsys.readouterr()
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    launches = _launches()
    got = train_cli.main(argv + ["--rig_layout", "flat"])
    text = capsys.readouterr().out
    assert "flat layout" in text and "tile_v 160" in text and "fused stem on" in text
    assert _launches() == launches
    assert not got["rig"].scales[0].window_hw and want["rig"].scales[0].window_hw
    for a, b in zip(got["losses"] + got["val_losses"],
                    want["losses"] + want["val_losses"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)


def test_train_cli_tiny_cpu(capsys):
    launches = (rig_window_fwd.launches, rig_window_bwd.launches)
    out = train_cli.main(TINY + ["--synthetic_frames", "4", "-b", "2"])
    text = capsys.readouterr().out
    assert "compiled rig: 8 buckets" in text
    assert "[TRAIN] epoch 1/1 it 2/2" in text and "[VAL] epoch 1:" in text
    assert "ms per step" in text
    assert (rig_window_fwd.launches, rig_window_bwd.launches) == launches
    assert len(out["losses"]) == 2 and len(out["ms"]) == 2
    assert len(out["val_losses"]) == 1
    for d in out["losses"] + out["val_losses"]:
        assert set(d) == {"loss", "loss_heatmap", "loss_pos", "loss_hwl", "loss_ang"}
        assert all(np.isfinite(v) for v in d.values())
    # a caller's prebuilt rig is used as it is; plain and kernel route agree
    # on the CPU, where the wrappers take the plain versions
    again = train_cli.main(TINY + ["--synthetic_frames", "4", "-b", "2",
                                   "--rig_impl", "plain"], rig=out["rig"])
    assert again["rig"] is out["rig"]
    assert "compiled rig" not in capsys.readouterr().out
    for a, b in zip(out["losses"], again["losses"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


def _train_cli_figures(tmp_path, capsys):
    """--vis_iter writes the train heatmap and prediction figures every N
    iterations and the val heatmap once an epoch to TensorBoard."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out = train_cli.main(TINY + ["--vis_iter", "1", "--synthetic_frames", "4",
                                 "--savedir", str(tmp_path / "runs")])
    assert "figures not written" not in capsys.readouterr().out
    acc = EventAccumulator(f"{out['savedir']}/tensorboard", size_guidance={"images": 0})
    acc.Reload()
    steps = {tag: [e.step for e in acc.Images(tag)] for tag in acc.Tags()["images"]}
    assert steps == {"train/heatmap": [0, 1, 2, 3], "train/prediction": [0, 1, 2, 3],
                     "val/heatmap": [1]}


def _train_cli_multihost(tmp_path):
    """--multihost in 2 processes (gloo on the CPU), -b 1 each, equals one
    process at -b 2 on the same frames: the epoch's train and val losses
    (metrics.jsonl) at rel 2e-4, the checkpointed parameters at rtol 2e-3 /
    atol 2e-5 (tests/test_parallel.py:66-72)."""
    import json
    import os
    import subprocess
    import sys

    from vfa_tpu_torch.checkpoint import load_state
    from vfa_tpu_torch.parallel import free_port

    argv = ["--data", "MultiviewC", "--synthetic", "--tiny", "-e", "1",
            "--pretrained", "0", "--no_augment", "--device", "cpu",
            "--synthetic_frames", "4", "--vis_iter", "0", "--lr", "0.001"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vfa_tpu_torch.train", *argv, "-b", "1",
         "--savedir", str(tmp_path / "multi"), "--multihost", "--coordinator",
         f"localhost:{port}", "--num_processes", "2", "--process_id", str(r)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "backend gloo (CPU tensors)" in logs[0] and "mesh data2xcam1" in logs[0]
    one = train_cli.main(argv + ["-b", "2", "--savedir", str(tmp_path / "one")])
    run = os.path.join(tmp_path / "multi", os.listdir(tmp_path / "multi")[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = {r["tag"]: r for r in map(json.loads, f)}
    assert rows["train"]["loss"] == pytest.approx(
        np.mean([d["loss"] for d in one["losses"]]), rel=2e-4)
    assert rows["val"]["loss"] == pytest.approx(one["val_losses"][0]["loss"], rel=2e-4)
    got = load_state(os.path.join(run, "checkpoints", "epoch_0001"))["model"]
    for k, v in one["model"].state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-3,
                                       atol=2e-5, err_msg=k)


@pytest.mark.parametrize("case", ["bf16", "figures", "multihost"])
def test_train_cli_refuses_what_is_not_ported(case, tmp_path, capsys):
    """The paths that raised naming their ROADMAP item until they were
    ported run: --no_rig --dtype bfloat16 (the voxel route in bf16, item
    17: mixed-precision steps and the bf16 validation, finite losses), the
    figures (item 14) and --multihost (item 15)."""
    if case == "bf16":
        out = train_cli.main(TINY + ["--dtype", "bfloat16", "--no_rig", "--device", "cpu"])
        text = capsys.readouterr().out
        assert "mixed precision: bfloat16 compute, float32 master params" in text
        assert "[TRAIN]" in text and "[VAL]" in text and "compiled rig" not in text
        assert out["losses"] and all(np.isfinite(d["loss"]) for d in out["losses"])
    elif case == "figures":
        _train_cli_figures(tmp_path, capsys)
    else:
        _train_cli_multihost(tmp_path)


def test_train_step_refuses_bf16_and_cuda_needs_a_card():
    """A bf16 step takes the reference voxel route (rig=None), which
    raised naming its ROADMAP item (17) until it was ported: finite losses,
    fp32 masters updated; an unknown compute dtype is refused when the step
    is made."""
    tc = t_tiny_config(get_config("MultiviewC"))
    model = VFANet(tc)
    tcfg = TrainConfig(compute_dtype="bfloat16")        # the dataclass takes it
    loader = SyntheticSceneLoader(tc, num_frames=1, batch_size=1, seed=0)
    step = ttl.make_train_step(model, ttl.make_optimizer(model, tcfg, 1), tc, tcfg,
                               dim_mean=loader.dim_mean)
    before = model.vfa8.collapse.weight.detach().clone()
    losses = step(ttl.batch_to_device(next(iter(loader)), "cpu", torch.bfloat16), None)
    assert all(torch.isfinite(v) for v in losses.values())
    assert model.vfa8.collapse.weight.dtype == torch.float32
    assert not torch.equal(model.vfa8.collapse.weight, before)
    with pytest.raises(ValueError, match="compute_dtype"):
        ttl.make_train_step(model, ttl.make_optimizer(model, tcfg, 1), tc,
                            TrainConfig(compute_dtype="float16"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main([a for a in TINY if a not in ("--device", "cpu")])
