"""Where one cell of the port's benchmark (`benchmark/`) spends its time, by
the port's own spans (`vfa_tpu_torch/observability.py`).

Sets the cell up as `benchmark/run.py` does (its configuration, traffic,
weights and inputs from the seed, the rig from `benchmark/.cache/rig`),
then traces two sub-windows of the cell's `trace_calls` calls, both under
torch.profiler:

1. the port's tracing off, the benchmark's layer clock on
   (`benchmark/devtrace.py`: what `run.py --trace 1` reads);
2. the port's spans on, no layer clock, after one untraced call with them
   on (so that the spans record CUDA events made before).

Then `--pairs` pairs of untraced blocks of the same calls, tracing off and
on in turn, each block timed on the host clock between device waits.
Prints one JSON line: the card and its power limit; the layer clock's
spans; every span's calls and host and device ms over the second
sub-window (a scene: `per_scene`); the device's busy time in it, without
the ranges the profiler mirrors from the host (`gpu_user_annotation`);
its idle gaps by the innermost `vfa.` range the host was in at each gap's
middle; the eight per-layer numbers the spans give (laterals_ms.serve,
sampling_glue_ms.serve, heads_ms.serve, decode_ms.serve, loss_ms.train,
optimizer_ms.train, idle_program_share.request, rig_load_s); the spans
against the layer clock; the spans' coverage of the device's busy time
(serving) or of the step (training); and tracing's cost a call, traced
(second sub-window against the first) and untraced (the pairs' medians).

    python tools/span_window.py --workload mvc_serve_b32 --seed 5200000001

Needs a CUDA card (exit 2 without one), as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import run  # noqa: E402  (benchmark/run.py: sets the benchmark's caches)
import torch  # noqa: E402

from vfa_tpu_torch import observability  # noqa: E402

# the spans that tile a serving call, and the per-layer numbers of each mode
SERVE_LAYERS = ("backbone", "laterals", "sampling", "heads", "decode")


def make_mode(spec: dict, seed: int, device):
    """The cell's mode, set up as `run.run` sets it up."""
    traffic = spec["traffic"]
    mode = run.load_module(os.path.join(run.HERE, "modes", f"{traffic['mode']}.py"),
                           f"mode_{traffic['mode']}").Mode(
        spec["config"], traffic, spec["settings"], seed, device,
        os.path.join(run.CACHE, "rig"))
    mode.setup()
    return mode


def profiled(fn, cuda: bool):
    """fn() under torch.profiler, bracketed by device waits: (the events,
    the host seconds of the bracket)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        seconds = time.perf_counter() - t0
    return prof.events(), seconds


def reduce_spans(events, window_s: float) -> dict:
    """busy_s (the union of the device's intervals, without the host ranges
    the profiler mirrors onto the device timeline), window_s, and the idle
    gaps between device intervals: their total, the part whose middle falls
    inside a `vfa.` range of the host, and the gaps' time by the innermost
    such range ('the caller' outside every range)."""
    from torch.autograd import DeviceType

    dev, ranges = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("vfa."):
                dev.append((a, b))
        elif e.name.startswith("vfa.") and b > a:
            ranges.append((a, b, e.name[4:]))
    busy, gaps, cur = 0.0, [], None
    for a, b in sorted(dev):
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    by_span = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "the caller"
        by_span[name] += (b - a) * 1e-3
    idle_ms = sum(by_span.values())
    return {"busy_s": busy * 1e-6, "window_s": window_s, "idle_gaps_ms": idle_ms,
            "idle_in_spans_ms": idle_ms - by_span.get("the caller", 0.0),
            "idle_by_span_ms": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def device_ms(spans: dict, *names) -> float | None:
    """The summed device ms of `names`, None where one is missing."""
    vals = [spans.get(n, {}).get("device_ms") for n in names]
    return None if any(v is None for v in vals) else sum(vals)


def layer_numbers(mode: str, spans: dict, scenes: int, idle: dict, setup: dict) -> dict:
    """The per-layer numbers the spans give in this mode (module docstring);
    a number whose spans are missing is left out."""
    per = lambda v: None if v is None else v / scenes
    if mode == "serve":
        glue = device_ms(spans, "sampling")
        kernel = device_ms(spans, "sampling.kernel")
        out = {"laterals_ms.serve": per(device_ms(spans, "laterals")),
               "sampling_glue_ms.serve": per(None if glue is None or kernel is None
                                             else glue - kernel),
               "heads_ms.serve": per(device_ms(spans, "heads")),
               "decode_ms.serve": per(device_ms(spans, "decode"))}
    elif mode == "train":
        out = {"loss_ms.train": per(device_ms(spans, "targets", "loss")),
               "optimizer_ms.train": per(device_ms(spans, "cast", "optimizer"))}
    else:
        out = {"idle_program_share.request": (100.0 * idle["idle_in_spans_ms"]
                                              / idle["idle_gaps_ms"])
               if idle["idle_gaps_ms"] > 0 else None}
    load = setup.get("rig.load")
    out["rig_load_s"] = load["host_ms"] * 1e-3 if load else None
    return {k: v for k, v in out.items() if v is not None}


def agreement(mode: str, spans: dict, clock: dict, h2d: list) -> dict:
    """Each span's device ms over the layer clock's for the same extent
    (ratios; the stage against the request's staging events, `h2d`)."""
    out = {}
    pairs = {"serve": {"backbone": (("backbone",), ("base_fwd",)),
                       "sampling": (("sampling",), ("sampling_fwd",))},
             "train": {"backbone+backbone.bwd": (("backbone", "backbone.bwd"),
                                                 ("base_fwd", "base_bwd")),
                       "sampling.bwd": (("sampling.bwd",), ("sampling_bwd",))},
             "request": {}}[mode]
    for name, (ours, theirs) in pairs.items():
        got = device_ms(spans, *ours)
        if got is not None and all(t in clock for t in theirs):
            out[name] = got / sum(clock[t] for t in theirs)
    if mode == "request" and h2d and device_ms(spans, "stage") is not None:
        out["stage"] = device_ms(spans, "stage") / spans["stage"]["calls"] / (sum(h2d) / len(h2d))
    return out


def coverage(mode: str, spans: dict, busy_s: float) -> float | None:
    """Serving: the layers' device ms over the busy ms; training: the
    step's children's device ms over the step's."""
    if mode == "train":
        step = spans.get("train_step", {})
        if step.get("device_ms") is None:
            return None
        return 1.0 - step["self_device_ms"] / step["device_ms"]
    if mode == "serve":
        got = device_ms(spans, *SERVE_LAYERS)
        return None if got is None or busy_s <= 0 else got / (busy_s * 1e3)
    return None


def timed_blocks(mode, calls: int, pairs: int, cuda: bool) -> dict:
    """Seconds a call of `pairs` blocks of `calls` calls with tracing off
    and on in turn (off first, then on first, alternating), untraced."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    times = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            observability.tracing(on)
            sync()
            t0 = time.perf_counter()
            mode.traced(calls)
            sync()
            times[on].append((time.perf_counter() - t0) / calls)
            observability.tracing(False)
            observability.clear_spans()
    off, on = statistics.median(times[False]), statistics.median(times[True])
    return {"off_s_a_call": times[False], "on_s_a_call": times[True],
            "median_cost": on / off - 1.0}


def card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": out}


def window(spec: dict, seed: int, device, pairs: int) -> dict:
    """The JSON line of one cell (module docstring)."""
    import devtrace

    cuda = device.type == "cuda"
    traffic, settings = spec["traffic"], spec["settings"]
    calls = settings["trace_calls"]
    t0 = time.perf_counter()
    mode = make_mode(spec, seed, device)
    setup_s = time.perf_counter() - t0
    setup = observability.setup_totals()
    # the first sub-window, as run.py traces it
    clock = devtrace.LayerClock(mode.model(), mode.train, cuda)
    clock.install()
    traced = {}
    fn = lambda: traced.update(scenes=mode.traced(calls))
    if cuda:
        first = devtrace.profile(fn)
    else:
        first = reduce_spans(*profiled(fn, cuda))
    clock.remove()
    layers = clock.totals_ms()
    h2d = mode.h2d_ms() if hasattr(mode, "h2d_ms") else []
    # the second: the port's spans on, after one call whose CUDA events the
    # spans then record again (an event's first record creates it)
    observability.tracing(True)
    mode.traced(1)
    observability.clear_spans()
    try:
        events, seconds = profiled(lambda: traced.update(scenes2=mode.traced(calls)), cuda)
        spans = observability.span_totals()
    finally:
        observability.tracing(False)
    second = reduce_spans(events, seconds)
    h2d_second = mode.h2d_ms() if hasattr(mode, "h2d_ms") else []
    scenes = traced["scenes2"]
    blocks = timed_blocks(mode, calls, pairs, cuda)
    m = traffic["mode"]
    out = {
        "workload": spec["cell"]["name"], "seed": seed, "device": card() if cuda else "cpu",
        "setup_s": setup_s, "setup_spans": setup,
        "clock_ms": layers, "h2d_ms": h2d, "h2d_ms_second": h2d_second, "scenes": scenes,
        "calls": calls,
        "first": {"busy_s": first["busy_s"], "window_s": first["window_s"]},
        "second": second,
        "spans": spans,
        "per_scene_device_ms": {k: v["device_ms"] / scenes for k, v in spans.items()
                                if v["device_ms"] is not None},
        "metrics": layer_numbers(m, spans, scenes, second, setup),
        "agreement": agreement(m, spans, layers, h2d),
        "stage_vs_same_window_h2d": agreement(m, spans, {}, h2d_second).get("stage"),
        "coverage": coverage(m, spans, second["busy_s"]),
        "on_cost_traced": second["window_s"] / first["window_s"] - 1.0,
        "on_cost_untraced": blocks,
    }
    mode.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=4,
                   help="pairs of untraced blocks, tracing off and on")
    args = p.parse_args(argv)
    spec = run.cell_spec(args.workload)
    device = run.find_device(spec["cell"]["chips"])
    if device is None:
        return 2
    print(json.dumps(window(spec, args.seed, device, args.pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
