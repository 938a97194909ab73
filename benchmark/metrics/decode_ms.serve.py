"""Device ms a scene of the decode in serving (the port's
`codec.decode_frame`: sigmoid, max-pool NMS, top-k, the boxes): the port's
span `decode` by its CUDA events, summed over the spans' traced
sub-window, over its scenes."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "decode")
    if ctx["mode"] != "serve" or ms is None:
        return None
    return ms / ctx["span_scenes"]
