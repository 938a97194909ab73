"""Device ms a scene of the backbone (the port's `model.base`) in a
training step, forward and backward: the layer clock's forward span plus
its backward span (the first gradient at an output of `base` to the
gradient of `base.conv1`'s weight), over the traced steps' scenes."""


def read(ctx):
    ms = ctx["layers_ms"]
    if ctx["mode"] != "train" or "base_fwd" not in ms or "base_bwd" not in ms:
        return None
    return (ms["base_fwd"] + ms["base_bwd"]) / ctx["scenes"]
