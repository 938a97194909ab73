#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--seconds 2]

For each seed: the cell's whole set-up, a short window of its traffic, the
program freed, and the check's numbers (the lower readings), with each
head's or leaf's part. On the first `--control` seeds also the control's
numbers, 'fp8_*': the reference with its operands in float8 put in the
program's place, against the same fp32 reference (the upper readings);
for a training cell, also the half-batch fault planted in the reference
(each step on the first half of its batch). One JSON line a seed on
stdout, then the summary (`summary`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

import run  # noqa: E402  (sets the path and the cache directories)

import torch  # noqa: E402


def half_batch_fault(mode) -> dict:
    """A training cell's numbers with the half-batch fault in the
    reference's place: its steps on the first half of each batch (and,
    under 'half_batch_parts', both sides' norms)."""
    from check import norms, train_numbers

    B = mode.traffic["batch"]
    n = mode.settings["checked_steps"]

    def steps(keep):
        batches = [(mode.scenes.floats(slice(i * B, i * B + keep)),
                    {k: v[:keep] if v.dim() and v.shape[0] == B else v
                     for k, v in mode.batches[i].items()}) for i in range(n)]
        out = mode.ref.train_steps(mode.reference(), batches, mode.calibs, mode.grid, mode.cfg)
        return {"losses": out["losses"], "pred": out["pred"], "grads": norms(out["grads"]),
                "change": norms(out["change"])}

    half, full = steps(B // 2), steps(B)
    drop = lambda side: {k: v for k, v in side.items() if k != "pred"}
    return {**{f"half_batch_{k}": v for k, v in train_numbers(half, full).items()},
            "half_batch_parts": {"half": drop(half), "ref": drop(full)}}


def readings(spec: dict, device, seeds: list, control: int, seconds: float):
    """Yield one dict of numbers a seed (module docstring)."""
    for i, seed in enumerate(seeds):
        with contextlib.redirect_stdout(sys.stderr):
            mode = run.load_module(os.path.join(run.HERE, "modes", f"{spec['traffic']['mode']}.py"),
                                   "mode").Mode(spec["config"], spec["traffic"], spec["settings"],
                                                seed, device, os.path.join(run.CACHE, "rig"))
            mode.setup()
            mode.window(seconds)
            mode.release()
            row = {"seed": seed, **mode.numbers(lows=("fp8",) if i < control else (),
                                                detail=True)}
            if mode.train and i < control:
                row.update(half_batch_fault(mode))
            del mode
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        yield row


def summary(rows: list) -> dict:
    """The largest reading of each number, the smallest of each control or
    fault reading."""
    keys = sorted({k for r in rows for k in r} - {"seed"})
    return {k: (min if k.startswith(("fp8_", "half_batch_")) else max)(
        r[k] for r in rows if k in r) for k in keys if "." not in k and "parts" not in k}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    spec = run.cell_spec(args.workload)
    device = run.find_device(spec["cell"]["chips"])
    if device is None:
        return 2
    rows = []
    for row in readings(spec, device, args.seeds, args.control, args.seconds):
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "card": torch.cuda.get_device_name(device), **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
