"""Device ms a scene of the rig sampling's glue in serving: the port's span
`sampling` (every route, from the laterals' features to the BEV features)
less its `sampling.kernel` spans (each scale's rig forward, K1-bf16), by
their CUDA events, summed over the spans' traced sub-window, over its
scenes: the layouts, copies and the epilogue around the kernel."""

from devtrace import span_ms


def read(ctx):
    whole, kernel = span_ms(ctx["spans"], "sampling"), span_ms(ctx["spans"], "sampling.kernel")
    if ctx["mode"] != "serve" or whole is None or kernel is None:
        return None
    return (whole - kernel) / ctx["span_scenes"]
