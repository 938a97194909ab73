"""Share (%) of the traced sub-window in which no kernel, copy or set ran
on the card (torch.profiler's device events), in the train mode."""


def read(ctx):
    if ctx["mode"] != "train" or ctx["window_s"] <= 0:
        return None
    return (1.0 - ctx["busy_s"] / ctx["window_s"]) * 100.0
