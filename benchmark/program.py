"""The system under test, as the benchmark drives it: with `programs/`, the
only code of the benchmark that imports the port (`vfa_tpu_torch`). The
modes call the functions here; each forwards to the adapter of the
architecture the configuration names under "arch", `programs/<arch>.py`,
which gives:

- `prepare(cfg, calibs, device, train, cache_dir)`: what the model needs
  besides its weights and the scene, made at set-up from the cameras (for
  VFANet the compiled rig), opaque to the harness;
- `server(cfg, state, prepared, device, calibs, grid)`: serve(images) ->
  (predictions, detections) on the device, with `serve.model` the model;
- `trainer(cfg, state, device)`: (step, model, optimizer), where
  step(batch, prepared) runs one training step and returns its loss under
  "loss";
- `clock_points(model)`: the modules the layer clock stamps
  (`devtrace.LayerClock`), or None.

What is the port's whatever the architecture stays here: the request
staging and the port's spans (`vfa_tpu_torch.observability`), each of the
latter empty where the port lacks it.
"""

from __future__ import annotations

import importlib

import torch


def adapter(cfg: dict):
    """The adapter module of the configuration's architecture."""
    return importlib.import_module(f"programs.{cfg['arch']}")


def prepare(cfg: dict, calibs, device, train: bool, cache_dir: str):
    return adapter(cfg).prepare(cfg, calibs, device, train, cache_dir)


def server(cfg: dict, state: dict, prepared, device, calibs, grid):
    return adapter(cfg).server(cfg, state, prepared, device, calibs, grid)


def trainer(cfg: dict, state: dict, device):
    return adapter(cfg).trainer(cfg, state, device)


def clock_points(cfg: dict, model):
    return adapter(cfg).clock_points(model)


def stage(images_u8, device, dtype: str) -> torch.Tensor:
    """The port's request staging: a host uint8 batch to the card, made
    [0, 1] there (`train_lib.stage_images`)."""
    from vfa_tpu_torch.train_lib import stage_images

    return stage_images(images_u8, device, getattr(torch, dtype))


def _observability(name: str):
    """The port's `observability.<name>`, or None where the port lacks it."""
    try:
        from vfa_tpu_torch import observability
    except ImportError:
        return None
    return getattr(observability, name, None)


def tracing(on: bool) -> None:
    """Switch the port's spans on or off."""
    fn = _observability("tracing")
    if fn is not None:
        fn(on)


def span_totals() -> dict:
    """Per span name since the last `clear_spans`: calls, host ms, device
    ms (None without CUDA events) and the self times of both."""
    fn = _observability("span_totals")
    return fn() if fn is not None else {}


def clear_spans() -> None:
    fn = _observability("clear_spans")
    if fn is not None:
        fn()


def setup_totals() -> dict:
    """Per set-up span name (the rig's `rig.load` or `rig.build`): calls,
    host ms and self host ms."""
    fn = _observability("setup_totals")
    return fn() if fn is not None else {}
