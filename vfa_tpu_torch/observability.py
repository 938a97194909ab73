"""Observability: metrics writers, profiler traces, numerics debugging
(port of `vfa_tpu/observability.py`).

  * MetricsWriter — TensorBoard scalars/figures (torch.utils.tensorboard,
    when it imports) plus an always-on `metrics.jsonl` mirror (appended on
    reopen, readable without TensorBoard);
  * profile_trace — a context manager around torch.profiler (CPU activity,
    and CUDA activity when a card is there) that writes a Chrome trace under
    its logdir, viewable in Perfetto or TensorBoard, with the port's spans
    on;
  * enable_nan_debugging / check_finite — the counterpart of
    `jax_debug_nans`: the train step checks its loss and every gradient
    with `torch.isfinite` after the backward and raises FloatingPointError
    naming the step. That costs one host sync a step, so it runs only when
    enabled (the train CLI's `--debug_nans`);
  * tracing / span / backward_span / untraced / span_totals — the port's
    own spans at each layer (see "Spans" below), off by default;
  * setup_span / setup_totals — set-up spans (the rig's build or load),
    host clock only, always recorded.

Spans. `tracing(True)` switches them on for the process. A span records
its name, the host clock (`perf_counter`) at its start and end, a CUDA
event on the current stream at each end (`device=True` once CUDA is
initialised), its parent (the span open when it started) and a call id
shared by every span under one top-level span; while a profiler runs it
also opens a torch.profiler range `vfa.<name>`, so the trace puts each
host event and each idle gap of the device inside the span the host was
in.
Records stay in memory; the events are resolved only when they are read
(`span_totals`, after a device wait). With tracing off `span` returns one
shared no-op context after a single flag test, and `backward_span` places
nothing: no record, no event, no profiler range, no autograd hook. The
spans the port places (the layer and where): stage (`train_lib.
stage_images`), forward, backbone, laterals, sampling, heads
(`model/vfanet.py`), sampling.kernel (each scale's rig forward,
`ops/rig_cuda.py`), decode (`codec.decode_frame`), train_step, cast,
targets, loss, backward, optimizer (`train_lib.make_train_step`; optimizer
twice a step, the gradients' reset and the update), and, in the backward,
sampling.bwd and backbone.bwd.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import types
import weakref
from typing import Dict, List, Optional

import torch

_NAN_DEBUG = False
_TRACING = False
_OFF = contextlib.nullcontext()


class MetricsWriter:
    """Scalars to TensorBoard (if available) + metrics.jsonl, figures to TB."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        # TensorBoard's event writer needs no TensorFlow, but tensorboard
        # imports TensorFlow (seconds) wherever it is installed unless this
        # marker module exists; with it, tensorboard takes its own stub
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"MetricsWriter: TensorBoard unavailable ({e}); writing "
                  "metrics.jsonl only")
        else:
            self._tb = SummaryWriter(os.path.join(logdir, "tensorboard"))

    @property
    def tensorboard(self) -> bool:
        return self._tb is not None

    def scalars(self, tag: str, values: dict, step: int):
        rec = {"tag": tag, "step": step, "time": time.time(), **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag}/{k}", float(v), step)

    def text(self, tag: str, content: str, step: int = 0):
        if self._tb:
            self._tb.add_text(tag, content, step)

    def figure(self, tag: str, fig, step: int):
        """A matplotlib figure to TensorBoard; closed either way."""
        if self._tb:
            self._tb.add_figure(tag, fig, step)      # closes it
        else:
            import matplotlib.pyplot as plt

            plt.close(fig)

    def close(self):
        self._jsonl.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Capture a torch.profiler trace of the block into
    `<logdir>/trace_<pid>_<time>.json`; a no-op for an empty logdir. CUDA
    activity is traced when a card is available, and the block's device
    work is waited for before the trace stops. The port's spans are on in
    the block, so the trace carries their `vfa.` ranges; their records
    (cleared when the block starts) stay for `span_totals`."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    clear_spans()
    was = tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        tracing(was)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def enable_nan_debugging(on: bool = True):
    """Fail fast on non-finite losses or gradients in the train step."""
    global _NAN_DEBUG
    _NAN_DEBUG = on


def nan_debugging() -> bool:
    return _NAN_DEBUG


def check_finite(step: int, loss: torch.Tensor, named_grads) -> None:
    """Raise FloatingPointError naming `step` when the loss or any gradient
    of `named_grads` ((name, tensor or None) pairs) holds a NaN or an Inf.
    One host sync for all of them."""
    grads = [(n, g) for n, g in named_grads if g is not None]
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for _, g in grads]).cpu()
    if bool(flags.all()):
        return
    bad = [n for (n, _), ok in zip([("loss", loss)] + grads, flags.tolist()) if not ok]
    raise FloatingPointError(
        f"non-finite values at step {step}: {', '.join(bad[:8])}"
        + (f" and {len(bad) - 8} more" if len(bad) > 8 else ""))


@dataclasses.dataclass
class SpanRecord:
    """One span: host clock (s) and CUDA events (or None) at its ends, the
    index of its parent among its trace's records, and its call id."""
    name: str
    parent: Optional[int]
    call: int
    t0: float
    t1: float = math.nan
    ev0: object = None
    ev1: object = None


class _Trace:
    """The records of one kind of span, in start order, and the stack of
    those open. One stack for the process: the port's spans run on one
    thread, except the backward's, which autograd runs while the thread
    that called `backward()` waits inside its span."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.stack: List[int] = []
        self.calls = 0
        self.generation = 0       # of the records: a clear starts the next

    def open(self, name: str, event) -> int:
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            self.calls += 1
            call = self.calls
        else:
            call = self.records[parent].call
        self.records.append(SpanRecord(name, parent, call, time.perf_counter(),
                                       ev0=event()))
        self.stack.append(len(self.records) - 1)
        return self.stack[-1]

    def close(self, i: int, generation: int, event) -> None:
        if generation != self.generation:
            return                # opened before a clear
        rec = self.records[i]
        rec.t1 = time.perf_counter()
        rec.ev1 = event()
        self.stack.remove(i)

    def clear(self) -> None:
        self.records.clear()
        self.stack.clear()
        self.calls = 0
        self.generation += 1

    def totals(self) -> Dict[str, dict]:
        """name -> calls, host_ms, device_ms, self_host_ms, self_device_ms
        over the closed records (device ms None without events); a span's
        self time is its time less what its children's spans cover."""
        done = [r for r in self.records if not math.isnan(r.t1)]
        timed = [r for r in done if r.ev0 is not None and r.ev1 is not None]
        if timed:
            torch.cuda.synchronize()
            ref = timed[0].ev0
        host = {id(r): (r.t0 * 1e3, r.t1 * 1e3) for r in done}
        dev = {id(r): (ref.elapsed_time(r.ev0), ref.elapsed_time(r.ev1)) for r in timed}
        children = collections.defaultdict(list)
        for r in done:
            if r.parent is not None:
                children[id(self.records[r.parent])].append(r)
        out: Dict[str, dict] = {}
        for r in done:
            t = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "device_ms": None,
                                        "self_host_ms": 0.0, "self_device_ms": None})
            t["calls"] += 1
            for key, ends in (("host_ms", host), ("device_ms", dev)):
                if id(r) not in ends:
                    continue
                a, b = ends[id(r)]
                inner = [ends[id(c)] for c in children[id(r)] if id(c) in ends]
                t[key] = (t[key] or 0.0) + (b - a)
                t[f"self_{key}"] = (t[f"self_{key}"] or 0.0) + (b - a) - covered(a, b, inner)
        return out


def covered(a: float, b: float, intervals) -> float:
    """How much of [a, b] the union of `intervals` ((start, end) pairs)
    covers."""
    total, reach = 0.0, a
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, b)
        if e > s:
            total += e - s
            reach = e
    return total


_SPANS = _Trace()
_SETUP = _Trace()


def _no_event():
    return None


# CUDA events of cleared span records, recorded again by later spans (an
# event's first record creates it, most of a span's cost on the host)
_EVENTS: list = []


# the backward spans placed and not closed yet, by name (`backward_span`)
_PENDING: dict = {}


def _cuda_event():
    ev = _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """A traced span: a context manager, or opened and closed by
    `backward_span`'s hooks."""

    __slots__ = ("name", "event", "index", "generation", "range")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.event = _cuda_event if device and torch.cuda.is_initialized() else _no_event
        self.index = None

    def open(self) -> None:
        # the clocks first and last, so that the span's times hold its own
        # profiler range; a range costs ~10 us even with no profiler to take it
        self.index = _SPANS.open(self.name, self.event)
        self.generation = _SPANS.generation
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(f"vfa.{self.name}")
            self.range.__enter__()

    def close(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _SPANS.close(self.index, self.generation, self.event)

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def tracing(on: bool) -> bool:
    """Switch the port's spans on or off for the process; returns the
    previous state."""
    global _TRACING
    was, _TRACING = _TRACING, bool(on)
    return was


def span(name: str, device: bool = True):
    """A context manager that records span `name` while tracing is on
    (module docstring), else the shared no-op context."""
    if not _TRACING:
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def untraced():
    """Spans off for the block, whatever the switch says: a checkpoint's
    recompute in the backward (`model.resnet.remat`) runs the forward's
    code again, and would record its spans a second time. The recompute's
    time counts to the span the backward is in."""
    global _TRACING
    was, _TRACING = _TRACING, False
    try:
        yield
    finally:
        _TRACING = was


def traced(name: str):
    """Decorator: the function's calls as span `name` (`span`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _TRACING:
                return fn(*args, **kwargs)
            with _Span(name, True):
                return fn(*args, **kwargs)
        return call
    return wrap


def backward_span(name: str, start, ends) -> None:
    """While tracing is on and autograd records: span `name` opens in the
    backward when the first gradient of a tensor of `start` is computed and
    closes when the first gradient of a tensor of `ends` is, through tensor
    hooks that pass the gradients on unchanged, add no autograd node and
    are removed once the span closes. A parameter (a leaf) may be in
    `ends`. A backward span of the same name whose `ends` are the same
    tensors and which has not closed takes these `start` tensors too, so
    the calls of one layer over chunks of a batch (`backbone_chunks`) make
    one span."""
    if not _TRACING or not torch.is_grad_enabled():
        return
    start, ends = ([t for t in ([ts] if torch.is_tensor(ts) else ts) if t.requires_grad]
                   for ts in (start, ends))
    if not (start and ends):
        return
    pending = _PENDING.get(name)
    if pending is not None and pending.ends_are(ends):
        pending.hook(start, pending.open)
    else:
        _PENDING[name] = _BackwardSpan(name, start, ends)


class _BackwardSpan:
    def __init__(self, name: str, start, ends):
        self.span = _Span(name, True)
        self.closed = False
        self.ends = [weakref.ref(t) for t in ends]
        self.handles = []
        self.hook(start, self.open)
        self.hook(ends, self.close)

    def hook(self, tensors, fn) -> None:
        self.handles += [t.register_hook(fn) for t in tensors]

    def ends_are(self, ends) -> bool:
        return not self.closed and len(ends) == len(self.ends) and all(
            r() is t for r, t in zip(self.ends, ends))

    def open(self, grad) -> None:
        if self.span.index is None:
            self.span.open()

    def close(self, grad) -> None:
        # also where the span never opened (a forward whose backward did
        # not run leaves its hook on a parameter until the next backward)
        if self.closed:
            return
        self.closed = True
        if _PENDING.get(self.span.name) is self:
            del _PENDING[self.span.name]
        if self.span.index is not None:
            self.span.close()
        for h in self.handles:
            h.remove()


def span_totals() -> Dict[str, dict]:
    """Per span name, over the records since the last `clear_spans`: calls,
    host ms, device ms (None where no CUDA event was recorded; read after a
    device wait) and the self times of both (`_Trace.totals`)."""
    return _SPANS.totals()


def clear_spans() -> None:
    """Drop the span records (set-up spans stay); their CUDA
    events go back to be recorded again. A span open across the clear is
    not recorded."""
    _EVENTS.extend(ev for r in _SPANS.records for ev in (r.ev0, r.ev1) if ev is not None)
    _SPANS.clear()


@contextlib.contextmanager
def setup_span(name: str):
    """A set-up span: the host clock only, recorded whether tracing is on
    or off (one a process is nearly free); read by `setup_totals`."""
    i = _SETUP.open(name, _no_event)
    try:
        yield
    finally:
        _SETUP.close(i, _SETUP.generation, _no_event)


def setup_totals() -> Dict[str, dict]:
    """Per set-up span name: calls, host ms and self host ms."""
    return _SETUP.totals()
