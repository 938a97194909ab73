"""One site, closed loop: a client sends one synchronised frame set (the
configuration's cameras, uint8, in host memory) at a time, the program
stages it on the card (copy and normalisation there), runs the model and
the decode, and the detections are copied to the host before the next
request goes out. Requests cycle over a pool of `pool` scenes.

End-to-end: request_p95_ms, the 95th percentile of every request's time
from send to detections on the host. Checked: the last answer to each pool
scene; the predictions of `check_scenes` of them drawn from the seed
against the reference's forward, every answer's decode against the
reference decoder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import program
from cell import Cell
from scene import Scenes


class Mode(Cell):
    def setup(self) -> None:
        dev = self.device
        P = self.traffic["pool"]
        self.scenes = Scenes(self.ds, self.seed, P, dev)
        self.host = [self.scenes.images[i].cpu().numpy() for i in range(P)]
        self.calibs = torch.as_tensor(self.scenes.calibs, device=dev)
        self.grid = torch.as_tensor(self.scenes.grid, device=dev)
        prepared = program.prepare(self.cfg, self.scenes.calibs, dev, False, self.cache_dir)
        self.serve = program.server(self.cfg, self.state, prepared, dev, self.calibs, self.grid)
        self.last = [None] * P
        self.latency = []
        self.h2d = None
        for _ in range(self.settings["warm_passes"]):
            for _ in range(P):
                self.call()
        self.latency.clear()

    def call(self) -> int:
        i = self.calls % len(self.host)
        t0 = time.perf_counter()
        if self.h2d is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        images = program.stage(self.host[i], self.device, self.cfg["dtype"])[None]
        if self.h2d is not None:
            ev[1].record()
            self.h2d.append(ev)
        pred, det = self.serve(images)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        self.latency.append(time.perf_counter() - t0)
        self.last[i] = (pred, det)
        self.calls += 1
        return 1

    def model(self):
        return self.serve.model

    def window(self, seconds: float) -> tuple:
        self.latency.clear()
        return super().window(seconds)

    def traced(self, calls: int) -> int:
        self.h2d = [] if self.device.type == "cuda" else None
        return super().traced(calls)

    def h2d_ms(self) -> list:
        """ms of each traced request's staging on the card (CUDA events
        around the copy and the normalisation)."""
        return [a.elapsed_time(b) for a, b in self.h2d or []]

    def metrics(self, scenes: int, seconds: float) -> dict:
        return {"request_p95_ms": float(np.percentile(np.asarray(self.latency) * 1e3, 95))}

    def release(self) -> None:
        del self.serve
        self.sync()

    def numbers(self, lows=(), detail=False) -> dict:
        picked = self.sample(len(self.host), self.settings["check_scenes"])
        return self.serving_numbers({s: self.last[s][0] for s in picked}, self.last, lows, detail)
