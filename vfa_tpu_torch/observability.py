"""Observability: metrics writers, profiler traces, numerics debugging
(port of `vfa_tpu/observability.py`).

  * MetricsWriter — TensorBoard scalars/figures (torch.utils.tensorboard,
    when it imports) plus an always-on `metrics.jsonl` mirror (appended on
    reopen, readable without TensorBoard);
  * profile_trace — a context manager around torch.profiler (CPU activity,
    and CUDA activity when a card is there) that writes a Chrome trace under
    its logdir, viewable in Perfetto or TensorBoard;
  * enable_nan_debugging / check_finite — the counterpart of
    `jax_debug_nans`: the train step checks its loss and every gradient
    with `torch.isfinite` after the backward and raises FloatingPointError
    naming the step. That costs one host sync a step, so it runs only when
    enabled (the train CLI's `--debug_nans`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import types
from typing import Optional

import torch

_NAN_DEBUG = False


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
    work is waited for before the trace stops."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
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
