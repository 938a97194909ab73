"""The port's own spans and counters (`vfa_tpu_torch/observability.py`) on
the CPU at a tiny size: spans nest with their parent and call id and give
self times; with tracing off nothing is recorded and the model's graph,
outputs and gradients are as without spans; every span of the port
appears in a serve forward + decode and in a mixed-precision training
step, backward spans included; the `vfa.` ranges reach a torch.profiler
trace; a checkpoint's recompute records no span a second time; the rig
cache's set-up spans; device times from CUDA events (faked here); and the
train CLI's profiled step."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from vfa_tpu_torch import observability, train
from vfa_tpu_torch.codec import decode_frame
from vfa_tpu_torch.config import TrainConfig, get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes
from vfa_tpu_torch.train_lib import (
    batch_to_device, make_optimizer, make_train_step, stage_images,
)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SERVE_SPANS = {"stage", "forward", "backbone", "laterals", "sampling", "sampling.kernel",
               "sampling.epilogue", "heads", "decode"}
TRAIN_SPANS = {"train_step", "cast", "forward", "backbone", "laterals", "sampling",
               "sampling.kernel", "heads", "targets", "loss", "optimizer", "backward",
               "sampling.bwd", "backbone.bwd"}


@pytest.fixture(autouse=True)
def tracing_reset():
    """Each test starts and ends with tracing off and no span records."""
    observability.tracing(False)
    observability.clear_spans()
    yield
    observability.tracing(False)
    observability.clear_spans()


@pytest.fixture(scope="module")
def tiny():
    """The tiny MultiviewC config, seeded weights, a batch of 2 scenes and
    the window rig in both dtypes (the kernels' plain versions)."""
    tc = tiny_config(get_config("MultiviewC"))
    loader = SyntheticSceneLoader(tc, num_frames=2, batch_size=2, max_objects=8,
                                  seed=3, num_objects=3)
    batch = batch_to_device(next(iter(loader)), "cpu")
    rigs = {dtype: build_rig(make_calibrations(tc), tc,
                             make_grid(tc.world_size, tc.cube_size[:2], tc.name),
                             pyramid_feat_shapes(tc.resize_size), tile_v=16,
                             band_buckets=3, device="cpu", dtype=dtype)
            for dtype in (torch.float32, torch.bfloat16)}
    state = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).state_dict()
    return tc, batch, rigs, state, loader.dim_mean


def _model(tiny, dtype=torch.float32):
    tc, _, _, state, _ = tiny
    model = VFANet(tc)
    model.load_state_dict(state, strict=True)
    return model if dtype == torch.float32 else cast_model(model, dtype)


@torch.no_grad()
def _serve(tiny, dtype=torch.float32):
    """A bf16 (or fp32) serving call as the benchmark makes it: uint8
    images staged, the forward in eval mode, the decode."""
    tc, batch, rigs, _, dim_mean = tiny
    model = _model(tiny, dtype).eval()
    u8 = (batch["images"].numpy() * 255).astype(np.uint8)
    pred = model(stage_images(u8, "cpu", dtype), rigs[dtype])
    det = decode_frame({k: v.float() for k, v in pred.items()}, tc, cls_thresh=0.5,
                       topk=10, dim_mean=dim_mean)
    return pred, det


def _train(tiny, compute_dtype="bfloat16"):
    """One training step (mixed precision by default): its losses, the
    gradients and the parameters after the update."""
    tc, batch, rigs, _, dim_mean = tiny
    model = _model(tiny)
    tcfg = TrainConfig(pretrained=False, compute_dtype=compute_dtype)
    step = make_train_step(model, make_optimizer(model, tcfg, 1), tc, tcfg,
                           dim_mean=dim_mean)
    batch = copy.copy(batch)
    batch["images"] = batch["images"].to(getattr(torch, compute_dtype))
    losses = step(batch, rigs[getattr(torch, compute_dtype)])
    return (losses, {n: p.grad for n, p in model.named_parameters()},
            {n: p.detach() for n, p in model.named_parameters()})


def _graph(out) -> list:
    """The autograd graph behind `out`'s tensors: each node's name and the
    names of its inputs' nodes, in a fixed walk order."""
    seen, order = set(), []
    todo = [t.grad_fn for t in out.values()]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nxt = [f for f, _ in fn.next_functions]
        order.append((fn.name(), tuple(f.name() if f else None for f in nxt)))
        todo.extend(nxt)
    return order


def test_spans_nest_with_parent_call_id_and_self_time():
    observability.tracing(True)
    with observability.span("a"):
        with observability.span("b"):
            with observability.span("c"):
                sum(range(20000))
        sum(range(20000))
        with observability.span("b"):
            sum(range(20000))
    with observability.span("d"):
        pass
    recs = observability._SPANS.records
    assert [r.name for r in recs] == ["a", "b", "c", "b", "d"]
    assert [r.parent for r in recs] == [None, 0, 1, 0, None]
    assert [r.call for r in recs] == [1, 1, 1, 1, 2]
    assert all(r.ev0 is None and r.ev1 is None for r in recs)
    tot = observability.span_totals()
    ms = lambda r: (r.t1 - r.t0) * 1e3
    a, b1, c, b2, d = recs
    assert tot["b"]["calls"] == 2
    assert tot["a"]["host_ms"] == pytest.approx(ms(a))
    assert tot["a"]["self_host_ms"] == pytest.approx(ms(a) - ms(b1) - ms(b2))
    assert tot["b"]["self_host_ms"] == pytest.approx(ms(b1) - ms(c) + ms(b2))
    assert tot["c"]["self_host_ms"] == pytest.approx(ms(c))
    assert tot["a"]["device_ms"] is None and tot["a"]["self_device_ms"] is None


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0), ([(1, 2), (3, 5)], 3.0), ([(1, 4), (2, 3)], 3.0), ([(0, 2), (1, 3)], 3.0),
    ([(-5, 1), (9, 20)], 2.0)])
def test_covered_is_the_union_clipped_to_the_span(intervals, want):
    assert observability.covered(0.0, 10.0, intervals) == want


def test_tracing_off_records_nothing_and_leaves_the_graph(tiny, monkeypatch):
    """No record, no profiler range, no CUDA event, no hook and not one
    autograd node more than a model without spans; with tracing on the
    graph is the same (tensor hooks add no node) and the hooks are there."""
    _, batch, rigs, _, _ = tiny
    model = _model(tiny).train()
    run = lambda: model(batch["images"], rigs[torch.float32])

    def no_event(*a, **k):
        raise AssertionError("a CUDA event with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = _graph(run())
    assert not [e.name for e in prof.events() if e.name.startswith("vfa.")]
    assert observability._SPANS.records == []
    assert not model.base.conv1.weight._backward_hooks
    with monkeypatch.context() as m:
        m.setattr(observability, "span", lambda name, device=True: observability._OFF)
        m.setattr(observability, "backward_span", lambda *a: None)
        m.setattr(observability, "_TRACING", False)
        bare = _graph(run())
    assert off == bare
    observability.tracing(True)
    on = _graph(run())
    assert on == bare
    assert model.base.conv1.weight._backward_hooks


def test_outputs_losses_and_gradients_do_not_move_with_tracing(tiny):
    for dtype in (torch.float32, torch.bfloat16):
        pred, det = _serve(tiny, dtype)
        observability.tracing(True)
        pred_on, det_on = _serve(tiny, dtype)
        observability.tracing(False)
        for k in pred:
            assert torch.equal(pred[k], pred_on[k]), (dtype, k)
        for k in det:
            assert torch.equal(det[k], det_on[k]), (dtype, k)
    for compute in ("float32", "bfloat16"):
        losses, grads, params = _train(tiny, compute)
        observability.tracing(True)
        losses_on, grads_on, params_on = _train(tiny, compute)
        observability.tracing(False)
        for got, want in ((losses_on, losses), (grads_on, grads), (params_on, params)):
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (compute, k)


def test_every_span_in_a_serve_call_and_a_train_step(tiny):
    observability.tracing(True)
    _serve(tiny, torch.bfloat16)
    serve = observability.span_totals()
    recs = observability._SPANS.records
    assert set(serve) == SERVE_SPANS
    assert serve["sampling.kernel"]["calls"] == 3
    parent = lambda r: recs[r.parent].name if r.parent is not None else None
    assert {r.name: parent(r) for r in recs} == {
        "stage": None, "forward": None, "backbone": "forward", "laterals": "forward",
        "sampling": "forward", "sampling.kernel": "sampling",
        "sampling.epilogue": "sampling", "heads": "forward", "decode": None}
    assert len({r.call for r in recs}) == 3            # stage, forward, decode
    observability.clear_spans()
    _train(tiny)
    steps = observability.span_totals()
    recs = observability._SPANS.records
    assert set(steps) == TRAIN_SPANS
    assert steps["optimizer"]["calls"] == 2
    assert {r.call for r in recs} == {1}
    assert {r.name: parent(r) for r in recs if r.name.endswith(".bwd")} == {
        "sampling.bwd": "backward", "backbone.bwd": "backward"}
    for name in TRAIN_SPANS - {"train_step"}:
        assert steps[name]["calls"] >= 1 and steps[name]["host_ms"] > 0
    bwd = {r.name: r for r in recs}
    assert bwd["sampling.bwd"].t1 <= bwd["backbone.bwd"].t0
    assert steps["train_step"]["self_host_ms"] < steps["train_step"]["host_ms"]


def test_spans_reach_the_profiler(tiny):
    from torch.profiler import ProfilerActivity, profile

    observability.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(tiny, torch.bfloat16)
    names = {e.name for e in prof.events()}
    assert {f"vfa.{s}" for s in SERVE_SPANS} <= names


@pytest.mark.parametrize("options", [
    {"backbone_chunks": 2}, {"backbone_remat": True}, {"stem_remat": True},
    {"backbone_chunks": 2, "backbone_remat": True, "stem_remat": True}],
    ids=["chunks2", "remat", "stem_remat", "all"])
def test_a_recompute_records_no_span_again(tiny, options):
    """Under the memory options the backward recomputes the backbone
    (`model.resnet.remat`): the recompute records no span, the backbone's
    backward is one span whatever the chunks, and the step's gradients are
    those with tracing off. `backbone` and `laterals` run once a chunk."""
    tc, batch, rigs, state, dim_mean = tiny

    def step():
        model = VFANet(tc, **options)
        model.load_state_dict(state, strict=True)
        tcfg = TrainConfig(pretrained=False, compute_dtype="bfloat16")
        run = make_train_step(model, make_optimizer(model, tcfg, 1), tc, tcfg,
                              dim_mean=dim_mean)
        b = copy.copy(batch)
        b["images"] = b["images"].to(torch.bfloat16)
        run(b, rigs[torch.bfloat16])
        return {n: p.grad for n, p in model.named_parameters()}

    off = step()
    observability.tracing(True)
    on = step()
    observability.tracing(False)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    chunks = options.get("backbone_chunks", 1)
    calls = {k: v["calls"] for k, v in observability.span_totals().items()}
    assert calls == {**{name: 1 for name in TRAIN_SPANS}, "optimizer": 2,
                     "sampling.kernel": 3, "backbone": chunks, "laterals": chunks}
    recs = observability._SPANS.records
    parent = lambda r: recs[r.parent].name if r.parent is not None else None
    assert {parent(r) for r in recs if r.name in ("backbone", "laterals")} == {"forward"}
    assert {r.name: parent(r) for r in recs if r.name.endswith(".bwd")} == {
        "sampling.bwd": "backward", "backbone.bwd": "backward"}
    assert not observability._PENDING


def test_a_cached_rig_load_records_its_set_up_spans(tiny, tmp_path):
    tc = tiny[0]
    args = (make_calibrations(tc), tc, make_grid(tc.world_size, tc.cube_size[:2], tc.name),
            pyramid_feat_shapes(tc.resize_size))
    kw = dict(tile_v=16, band_buckets=3, device="cpu", cache_dir=str(tmp_path))
    calls = lambda: {k: v["calls"] for k, v in observability.setup_totals().items()}
    spans = calls()
    built = build_rig(*args, **kw)
    after_build = calls()
    assert after_build.get("rig.build", 0) == spans.get("rig.build", 0) + 1
    assert after_build.get("rig.load", 0) == spans.get("rig.load", 0)
    loaded = build_rig(*args, **kw)
    after_load = calls()
    assert after_load["rig.load"] == after_build.get("rig.load", 0) + 1
    assert after_load["rig.build"] == after_build["rig.build"]
    for child in ("rig.load.read", "rig.load.dii_index"):
        assert after_load[child] == after_build.get(child, 0) + 3      # one a scale
    assert observability._SPANS.records == []          # set-up spans are apart
    totals = observability.setup_totals()["rig.load"]
    assert 0 < totals["self_host_ms"] < totals["host_ms"]
    for a, b in zip(built.scales, loaded.scales):
        assert all(torch.equal(x, y) for x, y in zip(a.A, b.A))


class _FakeEvent:
    """A CUDA event on a fake device clock that runs 2 ms a record."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        self.t = None
        _FakeEvent.made += 1

    def record(self):
        _FakeEvent.clock += 2.0
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_times_come_from_cuda_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    observability.tracing(True)
    with observability.span("outer"):          # records at 2 ... 12
        with observability.span("inner"):      # 4 ... 6
            pass
        with observability.span("host", device=False):
            pass
        with observability.span("inner"):      # 8 ... 10
            pass
    tot = observability.span_totals()
    assert tot["outer"]["device_ms"] == 10.0 and tot["outer"]["self_device_ms"] == 6.0
    assert tot["inner"]["device_ms"] == 4.0 and tot["inner"]["calls"] == 2
    assert tot["host"]["device_ms"] is None and tot["host"]["host_ms"] >= 0


def test_train_cli_profiled_step_carries_the_spans(tmp_path, capsys):
    train.main(["--data", "MultiviewC", "--tiny", "--device", "cpu", "--synthetic",
                "--synthetic_frames", "2", "-e", "1", "--pretrained", "0", "--no_augment",
                "--profile_steps", "1", "--vis_iter", "0", "--savedir", str(tmp_path),
                "--resume", "prof"])
    assert not observability._TRACING
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("spans of step 1 (ms): ")]
    spans = json.loads(line.split(": ", 1)[1])
    assert TRAIN_SPANS - {"cast"} <= set(spans)
    assert spans["train_step"]["calls"] == 1
    (trace,) = os.listdir(tmp_path / "prof" / "profile")
    with open(tmp_path / "prof" / "profile" / trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"vfa.train_step", "vfa.sampling.bwd", "vfa.backbone.bwd"} <= names


def test_clear_recycles_events_and_drops_spans_open_across_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(observability, "_EVENTS", [])
    observability.tracing(True)
    for _ in range(3):
        with observability.span("a"):
            pass
    made = _FakeEvent.made
    observability.clear_spans()
    with observability.span("open across the clear"):
        observability.clear_spans()
        for _ in range(2):
            with observability.span("b"):
                pass
    assert _FakeEvent.made == made              # recorded again, none made
    assert [r.name for r in observability._SPANS.records] == ["b", "b"]
    assert [r.parent for r in observability._SPANS.records] == [None, None]
    assert observability.span_totals()["b"]["device_ms"] == 4.0
