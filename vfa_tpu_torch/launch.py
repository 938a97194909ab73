"""Run a function in several ranks of one process group, each a process of
its own, and collect what each returns.

    results = run_ranks("vfa_tpu_torch.entry:_dryrun_rank", 4, args=(...))

Each rank is `python -m vfa_tpu_torch.launch <spec>`: it joins the group
through a file:// rendezvous in a temporary directory (no fixed port, so
concurrent runs do not collide), with the backend of
`parallel.backend_for`, calls `module:function(*args)` and saves the
result with torch.save; `run_ranks` waits for every rank and returns the
results in rank order, or raises with the failed rank's output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile

import torch


def run_ranks(target: str, nprocs: int, args=(), device: str = "cpu",
              threads: int = 1, timeout: float = 600, env=None,
              pythonpath=()) -> list:
    """`target` ("module:function") in `nprocs` ranks on `device` ("cpu",
    or "cuda": rank r on card r mod the card count), each with `threads`
    intra-op threads; `args` must pickle. `pythonpath`: directories the
    ranks import `target` from besides the repository."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="vfa_ranks_") as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"target": target, "args": args, "nprocs": nprocs,
                         "device": device, "threads": threads,
                         "init": "file://" + os.path.join(tmp, "rendezvous"),
                         "out": tmp}, f)
        run_env = {**os.environ, **(env or {})}
        run_env["PYTHONPATH"] = os.pathsep.join(
            [repo, *pythonpath] + ([run_env["PYTHONPATH"]] if run_env.get("PYTHONPATH") else []))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "vfa_tpu_torch.launch", spec, str(r)],
            cwd=repo, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(nprocs)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"rank {r} of {target} failed "
                                   f"(exit {p.returncode}):\n{log[-4000:]}")
        out = []
        for r, log in enumerate(logs):
            res = torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            res["log"] = log
            out.append(res)
        return out


def _rank_main(spec_path: str, rank: int) -> None:
    from vfa_tpu_torch.parallel import init_multihost

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    os.environ["VFA_PROCESS_ID"] = str(rank)
    os.environ["VFA_NUM_PROCESSES"] = str(spec["nprocs"])
    device = init_multihost(spec["init"], spec["nprocs"], rank, spec["device"])
    module, name = spec["target"].split(":")
    try:
        result = getattr(importlib.import_module(module), name)(device, *spec["args"])
    finally:
        torch.distributed.destroy_process_group()
    torch.save({"result": result}, os.path.join(spec["out"], f"rank{rank}.pt"))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
