"""Device ms a scene of the backbone's forward (the port's `model.base`,
ResNet-GN) in serving: the layer clock's span from `base`'s pre-hook to its
hook, summed over the traced calls, over their scenes."""


def read(ctx):
    ms = ctx["layers_ms"].get("base_fwd")
    if ctx["mode"] != "serve" or ms is None:
        return None
    return ms / ctx["scenes"]
