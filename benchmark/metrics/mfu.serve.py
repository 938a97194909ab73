"""The whole serving call's share (%) of the card's dense peak in the
configuration's dtype: the model's forward FLOPs a scene
(`work/<arch>.py`) times the window's scenes a second."""


def read(ctx):
    if ctx["mode"] != "serve" or ctx["peak"] is None:
        return None
    flops = ctx["work"].forward_flops(ctx["cfg"], ctx["device"])
    return flops * ctx["rate"] / ctx["peak"]["flops"] * 100.0
