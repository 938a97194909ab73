"""What a traced run reads: device time by layer, marked at the model's own
modules, and the device's busy time from torch.profiler.

Layers are the port's modules, found by the names its state dict keeps:
the backbone `base`, the laterals `lat*` / `bn*`, and `fuse`. Sampling is
everything between the last lateral and `fuse`. `LayerClock` stamps the
stream at those boundaries, forward and, in training, backward:

- base forward: `base` pre-hook to `base` hook;
- sampling forward: the last `bn*` hook to the `fuse` pre-hook;
- base backward: the first gradient that reaches an output of `base` to the
  gradient of `base.conv1`'s weight (its last);
- sampling backward: the gradient that leaves `fuse`'s input to the first
  gradient that reaches a lateral's output.

Autograd runs a node after every node created later in the forward that is
ready, so the laterals' backward follows the whole sampling backward, and
the backbone's follows theirs.
"""

from __future__ import annotations

import time
from collections import defaultdict

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
    (`cuda=True`), else the host clock (for tests)."""

    # span: (first tag, last tag, whether the span starts at the first
    # tag's last stamp); stamps of one tag come in stream order
    SPANS = {"base_fwd": ("base_f0", "base_f1", True),
             "sampling_fwd": ("lat_f1", "fuse_f0", True),
             "base_bwd": ("base_b0", "base_b1", False),
             "sampling_bwd": ("fuse_b", "lat_b", False)}

    def __init__(self, model, train: bool, cuda: bool):
        self.model, self.train, self.cuda = model, train, cuda
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
        m = self.model
        reg = self.handles.append

        def base_pre(mod, args):
            self.calls.append(defaultdict(list))
            self.stamp("base_f0")
            if self.train and torch.is_grad_enabled():
                self._watch_conv1()

        def base_post(mod, args, out):
            self.stamp("base_f1")
            if self.train and torch.is_grad_enabled():
                return tuple(self._mark(o, "base_b0") for o in out)
            return None

        def lat_post(mod, args, out):
            self.stamp("lat_f1")
            if self.train and torch.is_grad_enabled():
                return self._mark(out, "lat_b")
            return None

        def fuse_pre(mod, args):
            self.stamp("fuse_f0")
            if self.train and torch.is_grad_enabled():
                return (self._mark(args[0], "fuse_b"),)
            return None

        reg(m.base.register_forward_pre_hook(base_pre))
        reg(m.base.register_forward_hook(base_post))
        for s in (8, 16, 32):
            reg(getattr(m, f"bn{s}").register_forward_hook(lat_post))
        reg(m.fuse.register_forward_pre_hook(fuse_pre))

    def _watch_conv1(self) -> None:
        """Stamp 'base_b1' when the gradient of the weight that `base.conv1`
        uses in this call is computed (under mixed precision the call's
        cast copy, a tensor of its own each step)."""
        conv1 = self.model.base.conv1
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

        handle = conv1.register_forward_pre_hook(pre)

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


def profile(fn) -> dict:
    """Run fn() under torch.profiler (CPU and CUDA activity), bracketed by
    device synchronisations, keeping the events in memory. Returns busy_s
    (the union of the intervals in which a kernel, copy or set ran on the
    device), window_s (host clock over the bracket), and the breakdown:
    the ten device operations that took most time, and the ten host
    activities under which the device sat idle longest (the innermost host
    event at the midpoint of each of the NAMED_GAPS longest idle gaps,
    summed by its name; the rest as 'shorter gaps')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.time_range.end > e.time_range.start:
            host.append(span)
    return reduce_trace(dev, host, window_s)


def reduce_trace(dev: list, host: list, window_s: float) -> dict:
    """busy_s and the breakdown from device intervals and host events, each
    (start_us, end_us, name)."""
    by_op = defaultdict(float)
    for a, b, name in dev:
        by_op[name[:120]] += (b - a) * 1e-6
    busy, gaps = 0.0, []
    cur = None
    for a, b, _ in sorted(dev):
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
