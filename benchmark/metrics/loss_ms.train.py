"""Device ms a scene of a training step's targets and loss (the port's
`encode_targets`, the rotation cells and `losses.py`): the port's spans
`targets` plus `loss` by their CUDA events, summed over the spans' traced
sub-window, over its scenes."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "targets", "loss")
    if ctx["mode"] != "train" or ms is None:
        return None
    return ms / ctx["span_scenes"]
