"""The port's bench (`python -m vfa_tpu_torch.bench`) on the CPU, tiny
config: one JSON line with the root bench's keys and metric names, the
auto-batch fallback over the root bench's (batch, chunks) attempts on
out-of-memory only, the flags that were refused until their paths were
ported (the bf16 voxel route, the memory options, --bev_shards) running,
and the FLOP count (the plain rig counted once)."""

import json
import os
import re

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vfa_tpu_torch import bench
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops.rig import (
    build_rig, pyramid_feat_shapes, rig_matmul_flops, rig_sample_scale,
)
from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--tiny", "--device", "cpu", "--batch", "1", "--iters", "1", "--warmup", "0"]
KEYS = {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "dtype"}


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    """The rig cache goes under a temporary HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))


def _run(capsys, argv, rig=None):
    res = bench.main(argv, rig=rig)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, out.out
    assert json.loads(lines[0]) == res
    return res, out.err


@pytest.mark.parametrize("extra,metric", [
    ([], "multiviewc_2cam_scenes_per_sec_per_chip"),
    (["--data", "MultiviewX"], "multiviewx_2cam_scenes_per_sec_per_chip"),
    (["--data", "Wildtrack"], "wildtrack_2cam_scenes_per_sec_per_chip"),
    (["--train"], "multiviewc_2cam_train_scenes_per_sec_per_chip"),
    (["--data", "Wildtrack", "--train"], "wildtrack_2cam_train_scenes_per_sec_per_chip"),
    (["--no-rig"], "multiviewc_2cam_scenes_per_sec_per_chip"),
    (["--layout", "flat"], "multiviewc_2cam_scenes_per_sec_per_chip"),
], ids=["mc", "mx", "wt", "mc_train", "wt_train", "no_rig", "flat"])
def test_bench_prints_one_json_line_with_bench_keys(capsys, extra, metric):
    launches = rig_window_fwd.launches
    res, err = _run(capsys, TINY + extra)
    assert set(res) == KEYS               # no card: no mfu key
    assert res["metric"] == metric and res["unit"] == "scenes/sec"
    assert res["vs_baseline"] is None and res["dtype"] == "float32"
    # tflops_per_sec is rounded to 2 decimals, as in bench.py: a slow CPU
    # can print 0.0; the FLOPs of a call are on stderr
    assert res["value"] > 0 and res["tflops_per_sec"] >= 0
    assert float(re.search(r"# ([0-9.]+) GFLOP/call", err).group(1)) > 0
    assert "torch.backends.cudnn.allow_tf32=True" in err
    assert "torch.backends.cuda.matmul.allow_tf32=False" in err
    assert "# batch 1: ok" in err and "# host syncs in one warm call: 0" in err
    if "--no-rig" in extra:
        assert "compiled rig" not in err
    else:
        want = "8 buckets" if "--train" in extra else "12 buckets"
        assert f"compiled rig: {want}" in err
        assert f"{'flat' if 'flat' in extra else 'window'} layout" in err
    assert rig_window_fwd.launches == launches       # CPU: the plain versions


def test_bench_takes_a_built_rig_and_the_rig_cache(capsys):
    _, err = _run(capsys, TINY + ["--iters", "1"])
    assert ", built in " in err
    _, err = _run(capsys, TINY + ["--iters", "1"])
    assert ", cache hit in " in err
    cfg = tiny_config(get_config("MultiviewC"))
    rig = build_rig(make_calibrations(cfg), cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                    band_buckets=2, device="cpu")
    _, err = _run(capsys, TINY + ["--iters", "1"], rig=rig)
    assert "compiled rig" not in err and "given by the caller" in err


def _fail_above(limit, error):
    real = bench.make_runner
    tried = []

    def make_runner(cfg, args, bs, chunks, rig, device):
        tried.append((bs, chunks))
        if bs > limit:
            raise error
        return real(cfg, args, bs, chunks, rig, device)

    return make_runner, tried


def test_auto_batch_falls_back_on_out_of_memory(capsys, monkeypatch):
    fake, tried = _fail_above(2, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    monkeypatch.setattr(bench, "make_runner", fake)
    _run(capsys, ["--tiny", "--device", "cpu", "--batch", "0", "--iters", "1",
                  "--warmup", "0"])
    assert tried == [(32, 1), (16, 1), (8, 1), (4, 1), (2, 1)]
    fake, tried = _fail_above(2, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    monkeypatch.setattr(bench, "make_runner", fake)
    res, err = _run(capsys, ["--tiny", "--device", "cpu", "--batch", "0",
                             "--iters", "1", "--warmup", "0", "--train"])
    # the root bench's training attempts: a batch unchunked, then in 2 chunks
    assert tried == [(8, 1), (8, 2), (4, 1), (4, 2), (2, 1)]
    assert "# batch 8: out of memory" in err and "# batch 2: ok; chunks 1" in err
    assert re.search(r"# batch 4: out of memory .*; chunks 2; ", err)
    assert "batch=2 " in err and res["value"] > 0


def test_auto_batch_raises_other_errors(monkeypatch):
    fake, tried = _fail_above(2, RuntimeError("kernel build failed"))
    monkeypatch.setattr(bench, "make_runner", fake)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        bench.main(["--tiny", "--device", "cpu", "--batch", "0", "--iters", "1"])
    assert tried == [(32, 1)]


def test_out_of_memory_at_the_last_attempt_is_raised(monkeypatch):
    fake, _ = _fail_above(0, torch.cuda.OutOfMemoryError("CUDA out of memory."))
    monkeypatch.setattr(bench, "make_runner", fake)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.main(TINY)


@pytest.mark.parametrize("flag,item", [
    (["--dtype", "bfloat16", "--train", "--no-rig"], "item 17"),
    (["--dtype", "bfloat16", "--no-rig"], "item 17"),
    (["--remat"], "item 18"),
    (["--stem_remat"], "item 18"),
    (["--chunks", "2"], "item 18"),
    (["--bev_shards", "2"], "item 15"),
], ids=lambda v: v if isinstance(v, str) else v[0])
def test_unported_flags_raise_naming_their_item(flag, item, capsys, monkeypatch):
    """The flags that raised naming their ROADMAP Queue 1 item until it was
    ported now run. Items 17 and 18: the bf16 voxel route serving and
    training, and the memory options training (remat, stem_remat, 2
    backbone chunks over the 2 images of a tiny scene), each one JSON line
    and the options it ran with on stderr. --bev_shards (item 15): 2 gloo
    ranks on the CPU, each on its BEV row slab, train steps (the sharded
    forward, halos and norms, and backward), one JSON line with the `_bev2`
    metric."""
    if flag[0] == "--bev_shards":
        res = bench.main(TINY + flag + ["--train"])
        out, err = capsys.readouterr()
        assert json.loads(out.strip().splitlines()[-1]) == res
        assert res["metric"] == "multiviewc_2cam_train_bev2_scenes_per_sec_per_chip"
        assert res["value"] > 0
        assert "# rank 1:" in err and "backend gloo" in err
        assert "BEV-sharded rig: 2 slabs of 5 rows" in err
        return
    from vfa_tpu_torch.model import vfanet

    models = []
    monkeypatch.setattr(vfanet.VFANet, "__init__", lambda self, *a, _f=vfanet.VFANet.__init__,
                        **k: models.append(self) or _f(self, *a, **k))
    train = item == "item 18" or "--train" in flag
    res, err = _run(capsys, TINY + flag + (["--train"] if item == "item 18" else []))
    assert res["value"] > 0 and res["metric"].endswith(
        ("_train" if train else "") + "_scenes_per_sec_per_chip")
    assert res["dtype"] == ("bfloat16" if item == "item 17" else "float32")
    model = models[-1]
    if item == "item 17":
        assert "# sampling: the reference voxel route (no rig)" in err
        assert "compiled rig" not in err
    else:
        opts = (model.base.remat, model.base.stem_remat, model.backbone_chunks)
        assert opts == {"--remat": (True, False, 1), "--stem_remat": (False, True, 1),
                        "--chunks": (False, False, 2)}[flag[0]]
        assert (f"# memory options: remat {opts[0]}, stem_remat {opts[1]}, "
                f"chunks {2 if opts[2] == 2 else 'per attempt'}") in err
        assert f"# batch 1: ok; chunks {opts[2]}" in err


def test_grid2x_training_forces_backbone_remat(capsys, monkeypatch):
    """--grid2x --train turns backbone remat on, as the root bench does
    (`bench.py:141-144`), and says so; the grid is the halved cube's."""
    from vfa_tpu_torch.model import vfanet

    models = []
    monkeypatch.setattr(vfanet.VFANet, "__init__", lambda self, *a, _f=vfanet.VFANet.__init__,
                        **k: models.append(self) or _f(self, *a, **k))
    res, err = _run(capsys, TINY + ["--grid2x", "--train", "--no-rig"])
    assert "# grid2x train: backbone remat forced on" in err
    assert "_train_grid2x_" in res["metric"] and models[-1].base.remat
    assert "# memory options: remat True, stem_remat False" in err


def test_no_refusal_names_a_queue_1_item():
    """Every module of ROADMAP Queue 1 is ported: no source of the port
    raises NotImplementedError naming a Queue 1 item (the ones left are the
    adapters' abstract methods)."""
    root = os.path.dirname(bench.__file__)
    named = [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
             if f.endswith(".py") and "Queue 1 item" in open(os.path.join(d, f)).read()]
    assert named == []


@pytest.mark.parametrize("layout", ["window", "flat"])
def test_bench_bf16_serving(capsys, layout):
    """--dtype bfloat16 serves: one JSON line with dtype bfloat16, a bf16
    rig (JAX's bf16 tile_v: 160 for MultiviewC), no host sync in a warm
    call, and on the CPU no kernel launch of either dtype."""
    from vfa_tpu_torch.ops.rig_cuda import rig_flat_fwd_bf16, rig_window_fwd_bf16

    counts = (rig_window_fwd_bf16.launches, rig_flat_fwd_bf16.launches)
    res, err = _run(capsys, TINY + ["--dtype", "bfloat16", "--layout", layout])
    assert set(res) == KEYS and res["dtype"] == "bfloat16"
    assert res["metric"] == "multiviewc_2cam_scenes_per_sec_per_chip"
    assert res["value"] > 0
    assert f"compiled rig: 12 buckets, tile_v 160, bf16, {layout} layout" in err
    assert "# host syncs in one warm call: 0" in err
    assert "dtype=bfloat16" in err
    assert counts == (rig_window_fwd_bf16.launches, rig_flat_fwd_bf16.launches)


def test_flop_count_sees_the_plain_rig_once():
    """On the CPU the wrappers run the plain versions, whose matmuls the
    counter sees: the rig forward's count equals B x rig_matmul_flops, so
    the bench adds the builder's count only for the CUDA kernels."""
    cfg = tiny_config(get_config("Wildtrack"))
    rig = build_rig(make_calibrations(cfg), cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                    band_buckets=3, device="cpu")
    B, N = 2, cfg.num_cam
    g = torch.Generator().manual_seed(0)
    counted = 0
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        lat = torch.rand((B, N, fh, fw, 256), generator=g)
        k = torch.rand((256 * sr.nl, 256), generator=g)
        with FlopCounterMode(display=False) as counter:
            rig_sample_scale(lat, sr, k, torch.zeros(256), camera_sum=True)
        counted += counter.get_total_flops()
    assert counted == B * rig_matmul_flops(rig)


@pytest.mark.parametrize("train", [False, True])
def test_bench_adds_the_rig_flops_only_for_the_cuda_kernels(train):
    cfg = tiny_config(get_config("MultiviewC"))
    rig = build_rig(make_calibrations(cfg), cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                    band_buckets=2, device="cpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    kernels = 3 * rig_matmul_flops(rig, train=train)
    assert kernels > 0
    assert bench.call_flops(1000, rig, 3, train, cuda, "cuda") == 1000 + kernels
    assert bench.call_flops(1000, rig, 3, train, cpu, "cuda") == 1000
    assert bench.call_flops(1000, rig, 3, train, cuda, "plain") == 1000
    assert bench.call_flops(1000, None, 3, train, cuda, "cuda") == 1000
