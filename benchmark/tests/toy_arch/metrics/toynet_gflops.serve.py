"""GFLOPs of the toy's forward over the traced calls (its work counts)."""


def read(ctx):
    if ctx["mode"] != "serve":
        return None
    return ctx["work"].forward_flops(ctx["cfg"], ctx["device"]) * ctx["scenes"] * 1e-9
