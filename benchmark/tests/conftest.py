"""The harness's tests: the harness and the reference on the CPU at a tiny
size. Tests that need the card carry the marker `card` and skip here."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


def tiny(spec: dict) -> dict:
    """A cell's spec at a size the CPU holds: the world cut to a sixteenth
    (at least 4 cubes a side), the images to an eighth, 2 cameras, 2
    scenes a batch, 2 requests in the pool, 2 checked scenes, 1 traced
    call."""
    spec = copy.deepcopy(spec)
    ds = spec["config"]["dataset"]
    cube = ds["cube_size"]
    ds["world_size"] = [max(4 * cube[i], (s // 16) // cube[i] * cube[i])
                        for i, s in enumerate(ds["world_size"])]
    ds["image_size"] = [s // 8 for s in ds["image_size"]]
    ds["resize_size"] = [s // 8 for s in ds["resize_size"]]
    ds["num_cam"] = 2
    t = spec["traffic"]
    for key, value in (("batch", 2), ("distinct_batches", 2), ("pool", 2)):
        if key in t:
            t[key] = value
    if "checked_steps" in spec["settings"]:
        t["distinct_batches"] = spec["settings"]["checked_steps"]
    s = spec["settings"]
    if "check_scenes" in s:
        s["check_scenes"] = t.get("pool") or t["batch"] * t["distinct_batches"]
    if "trace_calls" in s:
        s["trace_calls"] = 1
    return spec


@pytest.fixture
def tiny_spec():
    import run

    return lambda cell: tiny(run.cell_spec(cell))
