"""Share (%) of its roofline that the sampling layer's backward reaches in
a training step (the rig's backward kernels and their reductions): the
least time for the collapse's two backward products or the layer's least
bytes (`work/vfanet.py`) over the layer clock's backward span (the
gradient leaving `fuse`'s input to the first gradient at a lateral's
output)."""


def read(ctx):
    ms = ctx["layers_ms"].get("sampling_bwd")
    if ctx["mode"] != "train" or ms is None or ctx["peak"] is None:
        return None
    w, cfg, b = ctx["work"], ctx["cfg"], ctx["batch"]
    calls = ctx["scenes"] / b
    bound = w.bound_s(w.sampling_flops(cfg, b, True, ctx["device"]),
                      w.sampling_bytes(cfg, b, True), ctx["peak"]) * calls
    return bound / (ms * 1e-3) * 100.0
