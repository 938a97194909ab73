"""MVDet in the benchmark: its work counts at the cell's own size pinned to
arithmetic by hand, the cell `mvdet_wt_serve_b32` run whole on the CPU at
a tiny size with `--trace 0` and `--trace 1` (correct), and its two
per-layer metrics against numbers by hand on a made-up context."""

import copy
import os

import pytest
import torch

import run
from work import mvdet as work

CFG = run.cell_spec("mvdet_wt_serve_b32")["config"]
PEAK = {"flops": 989.4e12, "bytes_per_s": 3.35e12}


def test_work_counts_at_the_published_widths():
    """A scene: 7 trunks at 720x1280 (338,411,520,000 FLOPs each), the
    image head on 7 maps of 270x480 (2 * 129,600 * (512 * 64 + 64 * 2)
    each), the map head on 120x360 (3x3: 3,586 -> 512 -> 512 -> 1); the
    projection reads 7 * 512 * 90 * 160 and writes 3,586 * 120 * 360 bf16
    values."""
    assert work.trunk_flops(CFG) == 7 * 338_411_520_000
    img = 7 * 2 * 270 * 480 * (512 * 64 + 64 * 2)
    cells = 120 * 360
    heads = img + 2 * cells * 9 * (3586 * 512 + 512 * 512 + 512)
    assert work.head_flops(CFG) == heads
    assert work.forward_flops(CFG) == 4_060_506_931_200 == work.trunk_flops(CFG) + heads
    assert work.projection_bytes(CFG) == 413_049_600 == 2 * (7 * 512 * 90 * 160 + 3586 * cells)
    assert work.trunk_shape((720, 1280)) == (90, 160)
    assert work.map_shape(CFG) == (270, 480)


def read(metric: str, ctx: dict):
    return run.load_module(os.path.join(run.HERE, "metrics", f"{metric}.py"), "m").read(ctx)


def context(**kw) -> dict:
    ctx = {"mode": "serve", "cfg": CFG, "work": work, "peak": PEAK, "span_scenes": 64,
           "spans": {"backbone": {"calls": 2, "device_ms": 640.0, "self_device_ms": 640.0},
                     "projection": {"calls": 2, "device_ms": 300.0, "self_device_ms": 200.0}}}
    ctx.update(kw)
    return ctx


def test_rooflines_by_hand():
    """64 scenes: the trunk's 64 * 2,368,880,640,000 FLOPs at 989.4 TFLOP/s
    over 640 ms; the projection's 64 * 413,049,600 bytes at 3.35 TB/s over
    its 200 ms of self time (300 less the image head's spans inside it)."""
    trunk = 64 * 2_368_880_640_000 / 989.4e12 / 0.640 * 100
    proj = 64 * 413_049_600 / 3.35e12 / 0.200 * 100
    assert read("trunk_roofline.serve", context()) == pytest.approx(trunk, rel=1e-12)
    assert read("projection_roofline.serve", context()) == pytest.approx(proj, rel=1e-12)
    assert 23.9 < trunk < 24.0 and 3.9 < proj < 4.0


@pytest.mark.parametrize("metric", ["trunk_roofline.serve", "projection_roofline.serve"])
@pytest.mark.parametrize("ctx", [
    context(spans={}),
    context(spans={"backbone": {"device_ms": None, "self_device_ms": None},
                   "projection": {"device_ms": None, "self_device_ms": None}}),
    context(mode="train"),
    context(peak=None),
    context(work=object()),
], ids=["no spans", "no device time", "training", "no peak", "no counts"])
def test_rooflines_read_nothing_where_they_find_nothing(metric, ctx):
    assert read(metric, ctx) is None


def test_the_cell_runs_whole_at_a_tiny_size(tiny_spec):
    """Serving on the CPU, untraced and traced: correct, the end-to-end
    metrics untraced; traced, the spans carry no device time on the CPU,
    so the span metrics read nothing and the idle share remains."""
    spec = tiny_spec("mvdet_wt_serve_b32")
    got = {}
    for trace in (0, 1):
        got[trace] = run.run(["--workload", "mvdet_wt_serve_b32", "--seed", "3141592653589",
                              "--seconds", "0.2", "--trace", str(trace)],
                             device=torch.device("cpu"), spec=spec)
    for res in got.values():
        assert res["correct"] is True, res["checked"]
        assert [r[0] for r in res["checked"]] == ["pred_vs_bf16", "decode_mismatch"]
        assert res["checked"][1][1] == 0
    assert set(got[0]["metrics"]) == {"serve_scenes_per_s", "setup_s"}
    assert set(got[1]["metrics"]) == {"idle_share.serve"}


@pytest.mark.parametrize("key,value", [
    ("base", "resnet34"), ("resnet_layers", [3, 4, 6, 3]), ("dilation", [False, False, True]),
    ("norm", "GroupNorm"), ("img_reduce", 8), ("grid_reduce", 2), ("extra", 1)])
def test_the_adapter_refuses_a_model_the_port_does_not_build(key, value):
    """Every key of the configuration's `model` group is the port's own:
    the reference and the work counts read the group, the port its
    constants, so an edit to either side alone is refused at set-up and
    at the server."""
    import program

    adapter = program.adapter(CFG)
    adapter.check_model(CFG)
    cfg = copy.deepcopy(CFG)
    cfg["model"][key] = value
    with pytest.raises(ValueError, match="is not the port's"):
        adapter.prepare(cfg, None, torch.device("cpu"), False, "")
    with pytest.raises(ValueError, match="is not the port's"):
        adapter.server(cfg, {}, None, torch.device("cpu"), None, None)
