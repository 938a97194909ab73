"""Share (%) of its roofline that the sampling layer's forward reaches in
serving (the port's rig sampling, `ops/rig_cuda.py`, from the last lateral
to `fuse`): the least time the chip needs for the layer's work
(`work/vfanet.py`: the collapse over the visible pairs at the bf16 peak, or
its least bytes at the memory bandwidth) over the layer clock's time of
the span."""


def read(ctx):
    ms = ctx["layers_ms"].get("sampling_fwd")
    if ctx["mode"] != "serve" or ms is None or ctx["peak"] is None:
        return None
    w, cfg, b = ctx["work"], ctx["cfg"], ctx["batch"]
    calls = ctx["scenes"] / b
    bound = w.bound_s(w.sampling_flops(cfg, b, False, ctx["device"]),
                      w.sampling_bytes(cfg, b, False), ctx["peak"]) * calls
    return bound / (ms * 1e-3) * 100.0
