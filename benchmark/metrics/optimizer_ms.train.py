"""Device ms a scene of a training step's optimizer (the master weights'
bf16 casts, the gradients' reset and the SGD update): the port's spans
`cast` plus `optimizer` by their CUDA events, summed over the spans'
traced sub-window, over its scenes."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "cast", "optimizer")
    if ctx["mode"] != "train" or ms is None:
        return None
    return ms / ctx["span_scenes"]
