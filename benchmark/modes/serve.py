"""Batched serving: `distinct_batches` batches of `batch` scenes, staged on
the card in the configuration's dtype before the window, run through the
model and the decode back to back in turn, one wait at the end.

End-to-end: serve_scenes_per_s, all scenes over all the window's time.
Checked: every call's last outputs of each batch; the predictions of
`check_scenes` scenes drawn from the seed against the reference's forward,
the decode of every scene against the reference decoder.
"""

from __future__ import annotations

import torch

import program
from cell import Cell
from scene import Scenes


class Mode(Cell):
    def setup(self) -> None:
        B, D = self.traffic["batch"], self.traffic["distinct_batches"]
        dev = self.device
        self.scenes = Scenes(self.ds, self.seed, B * D, dev)
        self.calibs = torch.as_tensor(self.scenes.calibs, device=dev)
        self.grid = torch.as_tensor(self.scenes.grid, device=dev)
        prepared = program.prepare(self.cfg, self.scenes.calibs, dev, False, self.cache_dir)
        self.serve = program.server(self.cfg, self.state, prepared, dev, self.calibs, self.grid)
        self.inputs = [self.scenes.floats(slice(i * B, (i + 1) * B), self.dtype)
                       for i in range(D)]
        self.last = [None] * D
        for _ in range(self.settings["warm_passes"]):
            for _ in range(D):
                self.call()
            self.sync()

    def call(self) -> int:
        i = self.calls % len(self.inputs)
        self.last[i] = self.serve(self.inputs[i])
        self.calls += 1
        return self.traffic["batch"]

    def model(self):
        return self.serve.model

    def metrics(self, scenes: int, seconds: float) -> dict:
        return {"serve_scenes_per_s": scenes / seconds}

    def release(self) -> None:
        del self.serve, self.inputs
        self.sync()

    def numbers(self, lows=(), detail=False) -> dict:
        B = self.traffic["batch"]
        picked = self.sample(len(self.scenes), self.settings["check_scenes"])
        return self.serving_numbers(
            {s: {k: v[s % B:s % B + 1] for k, v in self.last[s // B][0].items()}
             for s in picked},
            self.last, lows, detail)
