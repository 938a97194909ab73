"""Device ms a scene of the laterals in serving (the port's `lat*` / `bn*`:
1x1 convolution, GroupNorm, ReLU at each scale): the port's span
`laterals` by its CUDA events, summed over the spans' traced sub-window,
over its scenes."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "laterals")
    if ctx["mode"] != "serve" or ms is None:
        return None
    return ms / ctx["span_scenes"]
