"""Seconds of set-up spent loading the port's compiled rig from the
benchmark's cache: the port's set-up span `rig.load` by the host clock
(the npz read, the placing on the card, the dII index). None on a cache
miss, where set-up builds the rig (`rig.build`) instead."""


def read(ctx):
    load = ctx["setup_spans"].get("rig.load")
    return None if load is None else load["host_ms"] * 1e-3
