"""What the run command loads: no module of JAX or of the JAX package, and
a reference that takes nothing from the program under test; only
program.py and the adapters import the port."""

import ast
import glob
import os
import subprocess
import sys

import run

LOAD = """
import sys
sys.argv = ["run.py"]
sys.path[:0] = [{here!r}]
import run, calibrate, cell, check, devtrace, program, scene, work
import glob, importlib, os
for pkg in ("programs", "reference", "work"):
    for path in glob.glob(f"{{run.HERE}}/{{pkg}}/*.py"):
        importlib.import_module(f"{{pkg}}.{{os.path.basename(path)[:-3]}}")
for mode in ("serve", "request", "train"):
    run.load_module(f"{{run.HERE}}/modes/{{mode}}.py", mode)
for path in glob.glob(f"{{run.HERE}}/metrics/*.py"):
    run.load_module(path, "metric")
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(extra: str = "") -> set:
    """Top-level names of the modules that one process holds after
    importing the harness (and running `extra`)."""
    out = subprocess.run([sys.executable, "-c", LOAD.format(here=run.HERE, extra=extra)],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_after_the_harness_and_the_program():
    """The harness, the reference and the port's modules that a run drives,
    with the top-level names compared whole (vfa_tpu_torch is not vfa_tpu)."""
    mods = loaded("import vfa_tpu_torch.model.vfanet, vfa_tpu_torch.rig_cli, "
                  "vfa_tpu_torch.train_lib, vfa_tpu_torch.codec, vfa_tpu_torch.ops.rig_cuda")
    assert "vfa_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    mods = loaded()
    assert "vfa_tpu_torch" not in mods
    for path in glob.glob(os.path.join(run.HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.split(".")[0] in set(run.FORBIDDEN) | {"vfa_tpu_torch",
                                                                                "program"}]


def test_only_program_imports_the_port():
    """program.py and the architectures' adapters, programs/*.py."""
    for path in glob.glob(os.path.join(run.HERE, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, run.HERE)
        if rel == "program.py" or rel.startswith(("programs/", "tests/")):
            continue
        assert "vfa_tpu_torch" not in open(path).read().replace('"vfa_tpu_torch"', ""), path


def test_the_forbidden_check_names_whole_modules(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "vfa_tpu_torchlike", types.ModuleType("vfa_tpu_torchlike"))
    assert "vfa_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "vfa_tpu.geometry", types.ModuleType("vfa_tpu.geometry"))
    assert "vfa_tpu" in run.loaded_forbidden()
