"""What the work counts of every architecture share (`work/<arch>.py`, which
the harness hands the per-layer metrics as `ctx["work"]` and which gives
these two names too): a convolution's FLOPs and the least time a piece of
work can take on the chip."""

from __future__ import annotations


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """FLOPs of a k x k convolution producing (cout, h, w)."""
    return 2 * cin * cout * k * k * h * w


def bound_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: operations at the peak rate or
    bytes at the memory bandwidth, whichever is longer."""
    return max(flops / peak["flops"], nbytes / peak["bytes_per_s"])
