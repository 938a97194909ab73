"""What a traced run reads: device time by layer, marked at the model's own
modules; the device's busy time from torch.profiler; and the idle gaps by
the port's spans.

`LayerClock` stamps the stream at the modules the architecture's adapter
names (`clock_points`, `programs/<arch>.py`), forward and, in training,
backward: the backbone, its first convolution, the laterals and the BEV
head, the first module after the sampling. Sampling is everything between
the last lateral and the BEV head. The spans:

- base forward: the backbone's pre-hook to its hook;
- sampling forward: the last lateral's hook to the BEV head's pre-hook;
- base backward: the first gradient that reaches an output of the backbone
  to the gradient of its first convolution's weight (its last);
- sampling backward: the gradient that leaves the BEV head's input to the
  first gradient that reaches a lateral's output.

Autograd runs a node after every node created later in the forward that is
ready, so the laterals' backward follows the whole sampling backward, and
the backbone's follows theirs. An adapter that names no points gets no
clock: nothing is installed and no span is stamped.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

TOP = 10
NAMED_GAPS = 200   # the longest idle gaps, each named by its host event


class _Mark(torch.autograd.Function):
    """Identity whose backward calls `stamp(tag)`."""

    @staticmethod
    def forward(ctx, x, stamp, tag):
        ctx.stamp, ctx.tag = stamp, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.stamp(ctx.tag)
        return g, None, None


class LayerClock:
    """Stamps of every call between `install` and `remove`. `stamp` takes
    a tag; on a card it records a CUDA event on the current stream
    (`cuda=True`), else the host clock (for tests). `points` maps
    "backbone" to a module and, each optional, "backbone_first" to the
    module whose weight's gradient ends the backbone's backward,
    "laterals" to a list of modules and "bev_head" to a module; None
    installs nothing."""

    # span: (first tag, last tag, whether the span starts at the first
    # tag's last stamp); stamps of one tag come in stream order
    SPANS = {"base_fwd": ("base_f0", "base_f1", True),
             "sampling_fwd": ("lat_f1", "fuse_f0", True),
             "base_bwd": ("base_b0", "base_b1", False),
             "sampling_bwd": ("fuse_b", "lat_b", False)}

    def __init__(self, points: dict | None, train: bool, cuda: bool):
        if points is not None and "backbone" not in points:
            raise ValueError(f"clock points need a backbone: {sorted(points)}")
        self.points, self.train, self.cuda = points, train, cuda
        self.calls = []
        self.handles = []
        self._grad_handle = None

    def stamp(self, tag: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.calls[-1][tag].append(ev)

    def _mark(self, x, tag):
        return _Mark.apply(x, self.stamp, tag)

    def install(self) -> None:
        p = self.points
        if p is None:
            return
        reg = self.handles.append
        grads = lambda: self.train and torch.is_grad_enabled()

        def base_pre(mod, args):
            self.calls.append(defaultdict(list))
            self.stamp("base_f0")
            if grads() and "backbone_first" in p:
                self._watch_first(p["backbone_first"])

        def base_post(mod, args, out):
            self.stamp("base_f1")
            if grads():
                return tuple(self._mark(o, "base_b0") for o in out)
            return None

        def lat_post(mod, args, out):
            self.stamp("lat_f1")
            if grads():
                return self._mark(out, "lat_b")
            return None

        def head_pre(mod, args):
            self.stamp("fuse_f0")
            if grads():
                return (self._mark(args[0], "fuse_b"),)
            return None

        reg(p["backbone"].register_forward_pre_hook(base_pre))
        reg(p["backbone"].register_forward_hook(base_post))
        for lateral in p.get("laterals", ()):
            reg(lateral.register_forward_hook(lat_post))
        if "bev_head" in p:
            reg(p["bev_head"].register_forward_pre_hook(head_pre))

    def _watch_first(self, first) -> None:
        """Stamp 'base_b1' when the gradient of the weight that `first`
        uses in this call is computed (under mixed precision the call's
        cast copy, a tensor of its own each step)."""
        clock = self

        def pre(mod, args):
            handle.remove()
            w = mod.weight

            def on_grad(g):
                clock.stamp("base_b1")
                hook.remove()
                return None

            hook = w.register_hook(on_grad)
            clock._grad_handle = hook

        handle = first.register_forward_pre_hook(pre)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles.clear()
        if self._grad_handle is not None:
            self._grad_handle.remove()

    def totals_ms(self) -> dict:
        """Each span's time summed over the calls, in ms (after the device
        has finished them). A span that was not stamped is left out."""
        out = {}
        for span, (a, b, from_last) in self.SPANS.items():
            pairs = [(c[a][-1] if from_last else c[a][0], c[b][0])
                     for c in self.calls if c.get(a) and c.get(b)]
            if pairs:
                out[span] = sum(s.elapsed_time(e) if self.cuda else (e - s) * 1e3
                                for s, e in pairs)
        return out


def _profiled(fn, cuda: bool) -> tuple:
    """fn() under torch.profiler (CPU activity, and CUDA activity on a
    card), bracketed by device synchronisations, the events kept in
    memory: (the events, the host seconds of the bracket)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch_profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


def profile(fn, cuda: bool) -> dict:
    """Run fn() under torch.profiler (`_profiled`). Returns busy_s (the
    union of the intervals in which a kernel, copy or set ran on the
    device), window_s (host clock over the bracket), and the breakdown:
    the ten device operations that took most time, and the ten host
    activities under which the device sat idle longest (the innermost host
    event at the midpoint of each of the NAMED_GAPS longest idle gaps,
    summed by its name; the rest as 'shorter gaps')."""
    from torch.autograd import DeviceType

    events, window_s = _profiled(fn, cuda)
    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.time_range.end > e.time_range.start:
            host.append(span)
    return reduce_trace(dev, host, window_s)


def profile_spans(fn, cuda: bool) -> dict:
    """Run fn() under torch.profiler (`_profiled`), the port's spans on, and
    reduce the device's idle gaps by the spans' `vfa.` ranges
    (`reduce_spans`). The ranges the profiler mirrors from the host onto
    the device's timeline (`gpu_user_annotation`) are not device work."""
    from torch.autograd import DeviceType

    events, window_s = _profiled(fn, cuda)
    dev, ranges = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("vfa."):
                dev.append((a, b))
        elif e.name.startswith("vfa.") and b > a:
            ranges.append((a, b, e.name[4:]))
    return reduce_spans(dev, ranges, window_s)


def _merge(intervals) -> tuple:
    """(busy, gaps) of intervals whose first two items are (start, end):
    the length of their union and the gaps between its pieces, in the
    intervals' unit."""
    busy, gaps, cur = 0, [], None
    for a, b, *_ in sorted(intervals):
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
    return busy, gaps


def _innermost(points, ranges: list, block: int = 4096) -> np.ndarray:
    """For each point, the index of the shortest of `ranges` ((start, end,
    name), ends included) that holds it, the first in list order on a tie;
    -1 where none does. Blocks of points bound the memory."""
    out = np.full(len(points), -1)
    if not ranges:
        return out
    start = np.array([r[0] for r in ranges], np.float64)
    end = np.array([r[1] for r in ranges], np.float64)
    for i in range(0, len(points), block):
        p = points[i:i + block, None]
        inside = (start <= p) & (p <= end)
        j = np.where(inside, end - start, np.inf).argmin(1)
        out[i:i + block] = np.where(inside.any(1), j, -1)
    return out


def reduce_spans(dev: list, ranges: list, window_s: float) -> dict:
    """From device intervals (start_us, end_us) and the spans' host ranges
    (start_us, end_us, span name): busy_s, window_s, and the idle gaps
    between the device's intervals: their total ms (idle_gaps_ms), the ms
    of those whose middle falls inside a span's range (idle_in_spans_ms),
    and the gaps' ms by the innermost such span ('the caller' outside
    every span; idle_by_span_ms)."""
    busy, gaps = _merge(dev)
    by_span = defaultdict(float)
    mids = np.array([(a + b) / 2 for a, b in gaps], np.float64)
    for (a, b), j in zip(gaps, _innermost(mids, ranges)):
        by_span[ranges[j][2] if j >= 0 else "the caller"] += (b - a) * 1e-3
    idle_ms = sum(by_span.values())
    return {"busy_s": busy * 1e-6, "window_s": window_s, "idle_gaps_ms": idle_ms,
            "idle_in_spans_ms": idle_ms - by_span.get("the caller", 0.0),
            "idle_by_span_ms": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def span_ms(spans: dict, *names) -> float | None:
    """The summed device ms of the port's spans `names` (`span_totals`),
    None where one is missing or has no device time."""
    vals = [spans.get(n, {}).get("device_ms") for n in names]
    return None if any(v is None for v in vals) else sum(vals)


def reduce_trace(dev: list, host: list, window_s: float) -> dict:
    """busy_s and the breakdown from device intervals and host events, each
    (start_us, end_us, name)."""
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[name[:120]] += (b - a) * 1e-6
    busy, gaps = _merge(dev)
    idle = defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[NAMED_GAPS:]:
        idle["shorter gaps"] += (b - a) * 1e-6
    for a, b in gaps[:NAMED_GAPS]:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2][:120] if inner else "no host event"
        idle[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}
