#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json (at the root of the
checkout), which names its configuration (`configs/<config>.json`) and its
traffic (`traffic/<traffic>.json`, whose "mode" names the loop in
`modes/<mode>.py`); `workloads/<cell>.json` holds the cell's check settings
and limits; each per-layer metric is read by `metrics/<metric>.py`. The
configuration's "arch" names its architecture's adapter to the port
(`programs/<arch>.py`), plain reference (`reference/<arch>.py`) and work
counts (`work/<arch>.py`). A new architecture, configuration, traffic, cell
or metric is a new file and a new entry.

Set-up (weights and inputs from the seed, the port's rig from the cache
under `benchmark/.cache/`, the kernels built at first use, every shape the
traffic uses warmed) counts from the start of this script to the first
timed call. Then the window: `--seconds` of traffic, ending in a wait for
the device. `--trace 1` then traces two short steady sub-windows
(torch.profiler and CUDA events at the model's module boundaries; then
the port's own spans) and prints the per-layer metrics instead of the
end-to-end ones. Last, with the program freed, the check against the plain
reference (`check.py`); its numbers and limits end standard error and the
result line.

Exits 2 without a result where no CUDA card (or too few) is found, and 3
where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vfa_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: str = ROOT) -> dict:
    """Everything that defines a cell, found by name: its BENCHMARK.json
    entry, configuration, traffic, settings and the metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root, configs[cell["config"]]["file"])
    here = lambda m: name in m.get("workloads", [name])
    return {"cell": cell, "config": cfg,
            "traffic": load_json(HERE, "traffic", f"{cell['traffic']}.json"),
            "settings": load_json(HERE, "workloads", f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if here(m)],
            "per_layer": [m for m in bench["per_layer"] if here(m)],
            "run_seconds": bench["run_seconds"]}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def find_device(chips: int):
    """The first card, or None (said on stderr) where fewer than `chips`."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {n}", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def peak_of(kind: str, dtype: str):
    """The card's dense peak rate in `dtype` and its memory bandwidth
    (`peaks.json`), or None for a card not in the table."""
    row = load_json(HERE, "peaks.json").get(kind)
    if row is None or dtype not in row["flops"]:
        return None
    return {"flops": row["flops"][dtype], "bytes_per_s": row["bytes_per_s"]}


def per_layer(spec: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in spec["per_layer"]:
        value = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                            f"metric_{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def run(argv=None, device=None, spec=None) -> dict:
    """One run; returns the result dict, or None where there is no card.
    `device` and `spec` replace the look for a card and the cell's files
    (the harness's own tests run it on the CPU at a small size)."""
    args = parse_args(argv)
    spec = spec or cell_spec(args.workload)
    if device is None:
        device = find_device(spec["cell"]["chips"])
        if device is None:
            return None
    cuda = device.type == "cuda"
    cfg, traffic, settings = spec["config"], spec["traffic"], spec["settings"]
    mode = load_module(os.path.join(HERE, "modes", f"{traffic['mode']}.py"),
                       f"mode_{traffic['mode']}").Mode(
        cfg, traffic, settings, args.seed, device, os.path.join(CACHE, "rig"))
    mode.setup()
    setup_s = time.perf_counter() - T0
    log(f"setup_s {setup_s}")
    before = mode.calls
    scenes, seconds = mode.window(args.seconds)
    log(f"window: {mode.calls - before} calls, {scenes} scenes in {seconds} s")
    e2e = mode.metrics(scenes, seconds)
    result = {"metrics": {}, "device": {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}}
    if args.trace:
        ctx = traced_context(mode, spec, cuda)
        ctx.update(rate=scenes / seconds, peak=peak_of(result["device"]["kind"], cfg["dtype"]))
        result["metrics"] = per_layer(spec, ctx)
        result["device"].update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result["breakdown"] = ctx["breakdown"]
    else:
        result["metrics"] = {m["name"]: {"value": setup_s if m["name"] == "setup_s"
                                         else e2e[m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"]}
    mode.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ok, rows = check_verdict(mode, settings["limits"])
    log(f"check: {time.perf_counter() - t} s; run {time.perf_counter() - T0} s")
    return {"correct": ok, "attempted": scenes, "failed": 0, **result,
            "checked": [[k, finite(v), lim] for k, v, lim in rows]}


def traced_context(mode, spec: dict, cuda: bool) -> dict:
    """What the per-layer metrics read (README), from two traced
    sub-windows of the settings' `trace_calls` calls each. The first, the
    port's spans off: the layer clock at the adapter's points and the
    profiler's busy time and breakdown. The second, the spans on, after
    one call that makes their CUDA events (which the window's spans record
    again): the spans' totals and the device's idle gaps by span."""
    import devtrace
    import program

    cfg, calls = spec["config"], spec["settings"]["trace_calls"]
    clock = devtrace.LayerClock(program.clock_points(cfg, mode.model()), mode.train, cuda)
    clock.install()
    traced = {}
    prof = devtrace.profile(lambda: traced.update(scenes=mode.traced(calls)), cuda)
    clock.remove()
    log(f"traced: {prof['window_s']} s")
    ctx = {"mode": spec["traffic"]["mode"], "cfg": cfg, "batch": spec["traffic"].get("batch", 1),
           "scenes": traced["scenes"], "layers_ms": clock.totals_ms(),
           "busy_s": prof["busy_s"], "window_s": prof["window_s"],
           "breakdown": prof["breakdown"],
           "h2d_ms": mode.h2d_ms() if hasattr(mode, "h2d_ms") else [],
           "work": importlib.import_module(f"work.{cfg['arch']}"),
           "device": mode.device, "setup_spans": program.setup_totals()}
    program.tracing(True)
    try:
        mode.traced(1)
        program.clear_spans()
        idle = devtrace.profile_spans(
            lambda: traced.update(span_scenes=mode.traced(calls)), cuda)
        ctx["spans"] = program.span_totals()
    finally:
        program.tracing(False)
    log(f"traced with spans: {idle['window_s']} s; idle ms by span {idle['idle_by_span_ms']}")
    ctx.update(span_scenes=traced["span_scenes"], span_idle=idle)
    return ctx


def check_verdict(mode, limits: dict) -> tuple:
    from check import verdict

    numbers = mode.numbers()
    return verdict({k: numbers.get(k, math.inf) for k in limits}, limits)


def main(argv=None) -> int:
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        result = run(argv)
    if result is None:
        return 2
    found = loaded_forbidden()
    if found:
        print(f"loaded, and must not be: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in result["checked"]:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
