"""Device ms a scene of the fuse block and the heads in serving (the port's
`fuse`, `map_classifier`, `tytx_pred` and, in 3D, `thtwtl_pred`,
`orient_pred`): the port's span `heads` by its CUDA events, summed over
the spans' traced sub-window, over its scenes."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "heads")
    if ctx["mode"] != "serve" or ms is None:
        return None
    return ms / ctx["span_scenes"]
