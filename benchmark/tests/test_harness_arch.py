"""A second architecture is new files only: a toy one (`toy_arch/`: its
adapter, reference, work counts, configuration, traffic, cells and a
metric, laid out as in the benchmark) put beside a copy of the benchmark's
files, which are left as they are, runs serve and train on the CPU, with
`--trace 0` and `--trace 1`, and comes out correct. No file of the
benchmark names it."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import run

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy_arch")
SCRIPT = """
import json, sys
sys.path[:0] = [{bench!r}]
import torch
import run

out = {{}}
for cell in ("toy_serve", "toy_train"):
    for trace in (0, 1):
        out[f"{{cell}}.{{trace}}"] = run.run(
            ["--workload", cell, "--seed", "2718281828459", "--seconds", "0.2",
             "--trace", str(trace)], device=torch.device("cpu"), spec=run.cell_spec(cell))
print(json.dumps(out))
"""


def toy_tree(root: str) -> str:
    """A copy of the benchmark's files under `root`/benchmark, with the toy's
    files added (none replaced) and its BENCHMARK.json at `root`."""
    bench = os.path.join(root, "benchmark")
    shutil.copytree(run.HERE, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    for folder, _, files in os.walk(TOY):
        if "__pycache__" in folder:
            continue
        rel = os.path.relpath(folder, TOY)
        for name in files:
            home = root if name == "BENCHMARK.json" else os.path.join(bench, rel)
            dst = os.path.join(home, name)
            assert not os.path.exists(dst), dst
            shutil.copy(os.path.join(folder, name), dst)
    return bench


def test_a_second_architecture_is_new_files_only(tmp_path):
    bench = toy_tree(str(tmp_path))
    # the benchmark's own files are there unchanged
    for folder, _, files in os.walk(run.HERE):
        if "/tests" in folder[len(run.HERE):] or ".cache" in folder or "__pycache__" in folder:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(folder, name), run.HERE)
            assert filecmp.cmp(os.path.join(run.HERE, rel), os.path.join(bench, rel),
                               shallow=False), rel
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(bench=bench)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for key, res in got.items():
        assert res["correct"] is True, (key, res["checked"])
    assert set(got["toy_serve.0"]["metrics"]) == {"serve_scenes_per_s", "setup_s"}
    assert set(got["toy_train.0"]["metrics"]) == {"train_scenes_per_s", "setup_s"}
    # traced: the toy's own metric reads its work counts; the layer clock
    # (no points), the spans (none placed) and the rig (none) read nothing
    serve, train = got["toy_serve.1"], got["toy_train.1"]
    assert set(serve["metrics"]) == {"toynet_gflops.serve", "idle_share.serve"}
    assert set(train["metrics"]) == {"idle_share.train"}
    flops = 2 * (2 * 3 * 8 * 32 * 48) + 2 * 8 * 9 * 4 * 12    # 2 cameras; 4 x 12 cells
    assert abs(serve["metrics"]["toynet_gflops.serve"]["value"] - flops * 4 * 1e-9) < 1e-12
    for res in (serve, train):
        assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_no_file_of_the_benchmark_names_the_toy():
    for folder, _, files in os.walk(run.HERE):
        if "/tests" in folder[len(run.HERE):] or ".cache" in folder:
            continue
        for name in files:
            if name.endswith((".py", ".json")):
                text = open(os.path.join(folder, name)).read()
                assert "toynet" not in text and "toy_" not in text, name
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        assert "toy" not in f.read()
