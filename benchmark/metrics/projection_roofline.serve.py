"""Share (%) of its roofline that the ground-plane projection reaches in
serving (MVDet's upsampling, warp and concatenation, `model/mvdet.py`):
its least bytes (`work/<arch>.py`'s `projection_bytes`: the /8 features
read once, the world features written once) at the card's memory
bandwidth, over the self device time of the port's span `projection` (its
time less the image head's `heads` spans inside it) in the spans' traced
sub-window. None where the architecture counts no projection bytes or the
span is missing."""


def read(ctx):
    ms = ctx["spans"].get("projection", {}).get("self_device_ms")
    nbytes = getattr(ctx["work"], "projection_bytes", None)
    if ctx["mode"] != "serve" or ms is None or nbytes is None or ctx["peak"] is None:
        return None
    bound = ctx["work"].bound_s(0, nbytes(ctx["cfg"]) * ctx["span_scenes"], ctx["peak"])
    return bound / (ms * 1e-3) * 100.0
