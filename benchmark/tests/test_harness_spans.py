"""What a traced run reads from the port's spans: each span metric against
numbers by hand on a made-up context, the idle gaps by span, the layer
clock where an adapter names no points, the program's span functions
where the port lacks them, and whole traced runs of tiny cells on the CPU
that hand the metrics the port's spans."""

import os
import sys
import types

import pytest
import torch

import devtrace
import program
import run

CPU = torch.device("cpu")


def spans(**device_ms) -> dict:
    return {k.replace("__", "."): {"calls": 1, "host_ms": 2 * v, "device_ms": v,
                                   "self_host_ms": v, "self_device_ms": v}
            for k, v in device_ms.items()}


def read(metric: str, ctx: dict):
    return run.load_module(os.path.join(run.HERE, "metrics", f"{metric}.py"), "m").read(ctx)


def context(mode: str, **kw) -> dict:
    ctx = {"mode": mode, "spans": {}, "span_scenes": 8, "setup_spans": {},
           "span_idle": {"idle_gaps_ms": 0.0, "idle_in_spans_ms": 0.0}}
    ctx.update(kw)
    return ctx


SERVE = spans(laterals=2.4, sampling=20.0, sampling__kernel=15.2, heads=4.0, decode=0.8)
TRAIN = spans(targets=0.3, loss=0.5, cast=1.1, optimizer=0.5)


@pytest.mark.parametrize("metric,ctx,want", [
    ("laterals_ms.serve", context("serve", spans=SERVE), 0.3),
    ("sampling_glue_ms.serve", context("serve", spans=SERVE), 0.6),
    ("heads_ms.serve", context("serve", spans=SERVE), 0.5),
    ("decode_ms.serve", context("serve", spans=SERVE), 0.1),
    ("loss_ms.train", context("train", spans=TRAIN), 0.1),
    ("optimizer_ms.train", context("train", spans=TRAIN), 0.2),
    ("idle_program_share.request", context(
        "request", spans=SERVE, span_idle={"idle_gaps_ms": 4.0, "idle_in_spans_ms": 3.0}), 75.0),
    ("rig_load_s", context("train", setup_spans={"rig.load": {"calls": 1, "host_ms": 4250.0}}),
     4.25),
])
def test_span_metric_by_hand(metric, ctx, want):
    assert read(metric, ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric,ctx", [
    ("laterals_ms.serve", context("request", spans=SERVE)),
    ("laterals_ms.serve", context("serve")),
    ("sampling_glue_ms.serve", context("serve", spans=spans(sampling=20.0))),
    ("heads_ms.serve", context("serve", spans={"heads": {"calls": 1, "device_ms": None}})),
    ("decode_ms.serve", context("train", spans=SERVE)),
    ("loss_ms.train", context("train", spans=spans(loss=0.5))),
    ("optimizer_ms.train", context("train", spans=spans(optimizer=0.5))),
    ("idle_program_share.request", context("request", span_idle={
        "idle_gaps_ms": 4.0, "idle_in_spans_ms": 0.0})),
    ("idle_program_share.request", context("request", spans=SERVE)),
    ("rig_load_s", context("serve", setup_spans={"rig.build": {"calls": 1, "host_ms": 1e4}})),
])
def test_span_metric_reads_nothing_where_its_spans_are_missing(metric, ctx):
    assert read(metric, ctx) is None


def test_idle_gaps_by_the_innermost_span():
    """Device busy 0-10, 12-20, 21-30, 40-50 us; spans forward 0-35 with
    decode 18-25 inside it: the 2 us gap is forward's, the 1 us gap
    decode's, the 10 us gap (middle 35, forward's end) forward's too, and
    a gap after every span the caller's."""
    dev = [(0, 10), (12, 20), (21, 30), (40, 50), (5, 8), (60, 61)]
    ranges = [(0, 35, "forward"), (18, 25, "decode")]
    got = devtrace.reduce_spans(dev, ranges, 1.0)
    assert got["busy_s"] == pytest.approx(38e-6)
    assert got["idle_by_span_ms"] == pytest.approx(
        {"forward": 12e-3, "decode": 1e-3, "the caller": 10e-3})
    assert got["idle_gaps_ms"] == pytest.approx(23e-3)
    assert got["idle_in_spans_ms"] == pytest.approx(13e-3)


@pytest.mark.parametrize("seed", range(4))
def test_idle_gaps_by_span_match_the_plain_loop(seed):
    """Random device intervals and overlapping ranges, ties included: the
    gaps by span equal a loop over every range for every gap."""
    import random
    from collections import defaultdict

    rng = random.Random(seed)
    dev = [(a, a + rng.randint(1, 30)) for a in sorted(rng.sample(range(100000), 300))]
    ranges = [(a, a + rng.choice((5000, 8000, rng.randint(0, 20000))), f"s{k % 7}")
              for k, a in enumerate(rng.randint(0, 100000) for _ in range(60))]
    want = defaultdict(float)
    for a, b in devtrace._merge(dev)[1]:
        mid = (a + b) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        want[min(inner, key=lambda r: r[1] - r[0])[2] if inner else "the caller"] += (b - a) * 1e-3
    got = devtrace.reduce_spans(dev, ranges, 1.0)["idle_by_span_ms"]
    assert got == pytest.approx(dict(want), rel=1e-12, abs=1e-12)


def test_busy_time_is_the_same_union_in_both_reductions():
    dev = [(0, 10, "a"), (12, 20, "b"), (15, 30, "c"), (40, 50, "d")]
    assert devtrace.reduce_trace(dev, [], 1.0)["busy_s"] == pytest.approx(38e-6)
    assert devtrace.reduce_spans([d[:2] for d in dev], [], 1.0)["busy_s"] == pytest.approx(38e-6)


def test_layer_clock_without_points_installs_nothing():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1))
    clock = devtrace.LayerClock(None, True, False)
    clock.install()
    net(torch.zeros(1, 3, 4, 4)).sum().backward()
    clock.remove()
    assert clock.handles == [] and clock.calls == [] and clock.totals_ms() == {}
    with pytest.raises(ValueError):
        devtrace.LayerClock({"laterals": [net]}, False, False)


def test_layer_clock_with_a_backbone_only():
    """An adapter may name the backbone alone: its forward and backward are
    clocked, the sampling's spans are left out."""

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = torch.nn.Conv2d(3, 4, 1)

        def forward(self, x):
            y = self.conv1(x)
            return y, 2 * y

    trunk = Trunk()
    clock = devtrace.LayerClock({"backbone": trunk, "backbone_first": trunk.conv1}, True, False)
    clock.install()
    sum(o.sum() for o in trunk(torch.ones(1, 3, 4, 4))).backward()
    clock.remove()
    assert set(clock.totals_ms()) == {"base_fwd", "base_bwd"}


def test_program_spans_are_empty_where_the_port_lacks_them(monkeypatch):
    import vfa_tpu_torch

    monkeypatch.setattr(vfa_tpu_torch, "observability", types.ModuleType("bare"), raising=False)
    monkeypatch.setitem(sys.modules, "vfa_tpu_torch.observability", types.ModuleType("bare"))
    program.tracing(True)
    program.clear_spans()
    assert program.span_totals() == {} and program.setup_totals() == {}


@pytest.mark.parametrize("cell,names", [
    ("mvc_serve_b32", {"forward", "backbone", "laterals", "sampling", "heads", "decode"}),
    ("mvc_request_b1", {"stage", "forward", "backbone", "laterals", "sampling", "heads",
                        "decode"}),
    ("wt_train_b8", {"train_step", "cast", "forward", "targets", "loss", "backward",
                     "optimizer"}),
])
def test_traced_run_hands_the_metrics_the_ports_spans(tiny_spec, monkeypatch, cell, names):
    """A tiny cell's `--trace 1` run on the CPU: the layer clock reads the
    adapter's points as before, the second sub-window's spans carry the
    port's names (host times only: no CUDA events), as many scenes as the
    first, set-up's rig span is there, tracing is off again after, and the
    run is correct."""
    from vfa_tpu_torch import observability

    seen = {}
    real = run.per_layer
    monkeypatch.setattr(run, "per_layer", lambda spec, ctx: seen.update(ctx) or real(spec, ctx))
    res = run.run(["--workload", cell, "--seed", "1618033988749", "--seconds", "0.2",
                   "--trace", "1"], device=CPU, spec=tiny_spec(cell))
    assert res["correct"] is True, res["checked"]
    assert observability.span("x") is observability.span("y")   # off: the shared no-op
    clock = {"serve": {"base_fwd", "sampling_fwd"}, "request": {"base_fwd", "sampling_fwd"},
             "train": {"base_fwd", "sampling_fwd", "base_bwd", "sampling_bwd"}}
    assert set(seen["layers_ms"]) == clock[seen["mode"]]
    assert names <= set(seen["spans"])
    assert all(s["calls"] > 0 and s["device_ms"] is None for s in seen["spans"].values())
    assert seen["span_scenes"] == seen["scenes"] > 0
    assert set(seen["setup_spans"]) & {"rig.load", "rig.build"}
    assert seen["span_idle"]["window_s"] > 0
    # on the CPU the span metrics find no device time; the rig's load or
    # build is read either way
    assert not set(res["metrics"]) & {"laterals_ms.serve", "heads_ms.serve", "loss_ms.train"}
