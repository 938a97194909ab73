"""Mean ms of a request's staging on the card (the port's
`train_lib.stage_images`: the uint8 copy from host memory and the
normalisation there), by CUDA events around it in the traced requests."""


def read(ctx):
    ms = ctx["h2d_ms"]
    if ctx["mode"] != "request" or not ms:
        return None
    return sum(ms) / len(ms)
