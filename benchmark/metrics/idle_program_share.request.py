"""Share (%) of the device's idle time in the request mode that falls while
the host is inside one of the port's spans: over the idle gaps between
the device's operations in the spans' traced sub-window (torch.profiler),
those whose middle lies inside a `vfa.` range, by length. The rest is the
caller's: the detections' copy back, the loop. None where the port placed
no span or the device never idled."""


def read(ctx):
    idle = ctx["span_idle"]
    if ctx["mode"] != "request" or not ctx["spans"] or idle["idle_gaps_ms"] <= 0:
        return None
    return 100.0 * idle["idle_in_spans_ms"] / idle["idle_gaps_ms"]
