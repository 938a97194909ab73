"""Share (%) of its roofline that the trunk reaches in serving (the port's
dilated ResNet of MVDet, `model/mvdet.py`): the trunk's FLOPs
(`work/<arch>.py`'s `trunk_flops`) at the card's dense peak in the
configuration's dtype, over the device time of the port's span `backbone`
in the spans' traced sub-window. None where the architecture counts no
trunk FLOPs or the span is missing."""

from devtrace import span_ms


def read(ctx):
    ms = span_ms(ctx["spans"], "backbone")
    flops = getattr(ctx["work"], "trunk_flops", None)
    if ctx["mode"] != "serve" or ms is None or flops is None or ctx["peak"] is None:
        return None
    bound = ctx["work"].bound_s(flops(ctx["cfg"]) * ctx["span_scenes"], 0, ctx["peak"])
    return bound / (ms * 1e-3) * 100.0
