"""What every traffic mode shares: the cell's weights and inputs from the
seed, the timed loop, the traced sub-window and the reference.

A mode (`modes/<mode>.py`, named by the traffic file's "mode") subclasses
`Cell` and gives `setup` (build the program and warm up every shape the
traffic uses), `call` (one unit of traffic, returning the scenes it
completes), `metrics` (its end-to-end metrics over the window), `release`
(drop the program, keep what the check needs) and `numbers` (the check's
numbers, `check.py`).
"""

from __future__ import annotations

import importlib
import time

import torch

from check import decode_mismatch, head_parts, vs_twin
from scene import sub_seeds


class Cell:
    train = False

    def __init__(self, cfg: dict, traffic: dict, settings: dict, seed: int, device,
                 cache_dir: str):
        self.cfg, self.traffic, self.settings = cfg, traffic, settings
        self.seed, self.device, self.cache_dir = seed, device, cache_dir
        self.ds = cfg["dataset"]
        self.dtype = getattr(torch, cfg["dtype"])
        # the plain reference of the configuration's architecture
        self.ref = importlib.import_module(f"reference.{cfg['arch']}")
        self.twin = cfg["check_twin"]
        gen = torch.Generator(device=device).manual_seed(sub_seeds(seed, 3)[2])
        self.state = self.ref.init_state(self.ref.Reference(self.ds, cfg["model"]), gen, device)
        self.calls = 0

    # -- the timed path ---------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> tuple:
        """Calls back to back until `seconds` have passed, then a wait for
        the device: (scenes completed, seconds from the first call to the
        end of the wait)."""
        self.sync()
        t0 = time.perf_counter()
        scenes = 0
        while True:
            scenes += self.call()
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        return scenes, time.perf_counter() - t0

    def traced(self, calls: int) -> int:
        """`calls` calls (inside a traced bracket); the scenes completed."""
        return sum(self.call() for _ in range(calls))

    def model(self):
        """The program's model (for the layer clock's hooks)."""
        raise NotImplementedError

    # -- the check --------------------------------------------------------
    def reference(self, low: str | None = None):
        """The reference in fp32 (or, with `low`, its operands rounded:
        'fp8', the control; the configuration's `check_twin`, the twin)
        with the cell's weights, on the cell's device."""
        ref = self.ref.Reference(self.ds, self.cfg["model"], low).to(self.device)
        ref.load_state_dict(self.state)
        return ref

    def sample(self, population: int, count: int) -> list:
        """`count` distinct indices below `population`, drawn from the seed."""
        g = torch.Generator().manual_seed(sub_seeds(self.seed, 4)[3])
        return sorted(torch.randperm(population, generator=g)[:count].tolist())

    @torch.no_grad()
    def serving_numbers(self, preds: dict, outputs: list, lows=(), detail=False) -> dict:
        """pred_vs_bf16 over `preds` (scene index -> the program's
        predictions of that scene, a leading axis of 1) against the
        reference's forward of the scene and its bf16 twin's;
        decode_mismatch over `outputs`, (predictions, detections) pairs of
        the program. For each name in `lows` also '<low>_pred_vs_bf16':
        the reference rounded so (`reference`) in the program's place.
        `detail` adds pred_rel_l2 (the largest relative distance of a head,
        not in twin's units) and the parts."""
        ref = self.reference().eval()
        twin = self.reference(self.twin).eval()
        others = {low: self.reference(low).eval() for low in lows}
        parts = {"prog": [], **{low: [] for low in lows}}
        for s, pred in preds.items():
            args = (self.scenes.floats([s]), self.calibs, self.grid)
            want, tw = ref(*args), twin(*args)
            parts["prog"] += head_parts(pred, want, tw)
            for low, m in others.items():
                parts[low] += head_parts(m(*args), want, tw)
        out = {"pred_vs_bf16": vs_twin(parts["prog"])}
        out.update({f"{low}_pred_vs_bf16": vs_twin(parts[low]) for low in lows})
        out["decode_mismatch"] = sum(decode_mismatch(det, self.ref.decode(pred, self.cfg))
                                     for pred, det in outputs)
        if detail:
            out["pred_rel_l2"] = vs_twin([(h, r, e, r) for h, r, e, _ in parts["prog"]], 0.0)
            out["parts"] = parts
        return out
