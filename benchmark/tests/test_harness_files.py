"""BENCHMARK.json and the files it names: every configuration, cell, traffic
mix and per-layer metric is found by name, and the file keeps the
benchmark's contract of keys and names."""

import json
import os
import re

import pytest

import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


def reduced_faults(entry: dict, cfg: dict) -> list:
    """What breaks the rule for a configuration's `reduced` (its
    BENCHMARK.json entry, its file): each entry names a key of the file
    whose published value the file states beside it, under "published",
    and that differs from the value run; the file lists the same keys."""
    faults = [] if cfg.get("reduced", []) == entry["reduced"] else ["the file's reduced differs"]
    published = cfg.get("published", {})
    for key in entry["reduced"]:
        if key not in cfg:
            faults.append(f"{key}: not a key of the file")
        elif key not in published:
            faults.append(f"{key}: no published value")
        elif published[key] == cfg[key]:
            faults.append(f"{key}: the published value is the one run")
    return faults


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    spec = run.cell_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert os.path.exists(os.path.join(run.HERE, "modes", f"{spec['traffic']['mode']}.py"))
    entry = {c["name"]: c for c in BENCH["configs"]}[spec["cell"]["config"]]
    assert reduced_faults(entry, spec["config"]) == []
    for folder in ("programs", "reference", "work"):
        assert os.path.exists(os.path.join(run.HERE, folder, f"{spec['config']['arch']}.py"))
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names
        reader = run.load_module(os.path.join(run.HERE, "metrics", f"{m['name']}.py"), "m")
        assert callable(reader.read)
    assert spec["settings"]["limits"]


def test_every_file_is_used():
    """Each configuration, traffic mix, workload, metric and architecture
    file belongs to an entry."""
    configs = {c["file"] for c in BENCH["configs"]}
    for name in os.listdir(os.path.join(run.HERE, "configs")):
        assert f"benchmark/configs/{name}" in configs
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert {n[:-5] for n in os.listdir(os.path.join(run.HERE, "traffic"))} == traffic
    assert {n[:-5] for n in os.listdir(os.path.join(run.HERE, "workloads"))} == set(CELLS)
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert {n[:-3] for n in os.listdir(os.path.join(run.HERE, "metrics"))
            if n.endswith(".py")} == metrics
    archs = {run.load_json(ROOT, c["file"])["arch"] for c in BENCH["configs"]}
    for folder in ("programs", "reference", "work"):
        assert {n[:-3] for n in os.listdir(os.path.join(run.HERE, folder))
                if n.endswith(".py") and n != "__init__.py"} == archs, folder


@pytest.mark.parametrize("entry,cfg,faults", [
    ({"reduced": []}, {"reduced": [], "model": {"layers": 8}}, 0),
    ({"reduced": ["model"]}, {"reduced": ["model"], "model": {"layers": 2},
                              "published": {"model": {"layers": 8}}}, 0),
    ({"reduced": ["model"]}, {"reduced": ["model"], "model": {"layers": 2}}, 1),
    ({"reduced": ["depth"]}, {"reduced": ["depth"], "model": {"layers": 2},
                              "published": {"depth": 8}}, 1),
    ({"reduced": ["model"]}, {"reduced": ["model"], "model": {"layers": 8},
                              "published": {"model": {"layers": 8}}}, 1),
    ({"reduced": ["model"]}, {"reduced": [], "model": {"layers": 2},
                              "published": {"model": {"layers": 8}}}, 1),
])
def test_reduced_rule(entry, cfg, faults):
    """A configuration cut to one chip passes where it states what it cut."""
    assert len(reduced_faults(entry, cfg)) == faults


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_reference_keys_are_the_programs(config):
    """The state dict the benchmark makes loads into the port strictly."""
    import importlib

    import torch

    import program

    cfg = run.load_json(ROOT, f"benchmark/configs/{config}.json")
    ref = importlib.import_module(f"reference.{cfg['arch']}")
    state = ref.init_state(ref.Reference(cfg["dataset"], cfg["model"]),
                           torch.Generator().manual_seed(1), "cpu")
    model = program.server(cfg, state, None, torch.device("cpu"), None, None).model
    assert set(model.state_dict()) == set(state)
