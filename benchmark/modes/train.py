"""Training: `distinct_batches` batches of `batch` scenes (images staged on
the card in the configuration's dtype, the padded objects and the
ground-truth heatmap) and the program's training step (forward, targets,
loss, backward, the optimizer's update) on them in turn, back to back, one
wait at the end.

Set-up builds one training step with its model and optimizer and drives it
through the first `checked_steps` steps on the first batches (all scenes
distinct), reading their losses, the first gradient from the optimizer's
state after one step and each parameter's change after the last; that same
step then runs the window. End-to-end: train_scenes_per_s, all scenes over
all the window's time. Checked: those steps against the reference's
(`reference.train_steps`).
"""

from __future__ import annotations

import torch

import program
from cell import Cell
from check import head_parts, norms, train_numbers, vs_twin
from scene import Scenes


class Mode(Cell):
    train = True

    def setup(self) -> None:
        B, D = self.traffic["batch"], self.traffic["distinct_batches"]
        if D < self.settings["checked_steps"]:
            raise ValueError("the checked steps need a batch each: distinct_batches "
                             f"{D} < checked_steps {self.settings['checked_steps']}")
        dev = self.device
        self.scenes = Scenes(self.ds, self.seed, B * D, dev)
        self.calibs = torch.as_tensor(self.scenes.calibs, device=dev)
        self.grid = torch.as_tensor(self.scenes.grid, device=dev)
        self.prepared = program.prepare(self.cfg, self.scenes.calibs, dev, True, self.cache_dir)
        self.step, self.net, opt = program.trainer(self.cfg, self.state, dev)
        self.batches = []
        for i in range(D):
            idx = slice(i * B, (i + 1) * B)
            batch = self.scenes.batch(idx, dev)
            batch.update(images=self.scenes.floats(idx, self.dtype), calibs=self.calibs[None]
                         .expand(B, -1, -1, -1), grid=self.grid)
            self.batches.append(batch)
        self.first = self._first_steps(opt)
        for _ in range(self.settings["warm_steps"]):
            self.call()
        self.sync()

    def _first_steps(self, opt) -> dict:
        params = dict(self.net.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        wd = self.cfg["train"]["weight_decay"]
        losses, grads, pred = [], None, {}
        hook = self.net.register_forward_hook(
            lambda mod, args, out: pred.update({k: v.detach().float() for k, v in out.items()}))
        for _ in range(self.settings["checked_steps"]):
            losses.append(self._step()["loss"])
            hook.remove()
            if grads is None:
                # the optimizer's momentum after its first step is the
                # gradient plus the weight decay's term (none: it got none)
                grads = norms({k: opt.state.get(p, {}).get("momentum_buffer",
                                                           wd * start[k]) - wd * start[k]
                               for k, p in params.items()})
        change = norms({k: p.detach() - start[k] for k, p in params.items()})
        return {"losses": [float(v) for v in losses], "pred": pred, "grads": grads,
                "change": change}

    def _step(self) -> dict:
        out = self.step(self.batches[self.calls % len(self.batches)], self.prepared)
        self.calls += 1
        return out

    def call(self) -> int:
        self._step()
        return self.traffic["batch"]

    def model(self):
        return self.net

    def metrics(self, scenes: int, seconds: float) -> dict:
        return {"train_scenes_per_s": scenes / seconds}

    def release(self) -> None:
        del self.step, self.net, self.prepared
        self.sync()

    def numbers(self, lows=(), detail=False) -> dict:
        """The check's numbers of the first steps against the reference's
        (`check.train_numbers`) and pred1_vs_bf16, the first step's
        predictions against the reference's in units of its bf16 twin's
        (a training-mode forward at the same weights); for each name in
        `lows` also '<low>_<number>' of the reference rounded so in the
        program's place."""
        B, n = self.traffic["batch"], self.settings["checked_steps"]
        batches = [(self.scenes.floats(slice(i * B, (i + 1) * B)), self.batches[i])
                   for i in range(n)]

        def steps(low=None):
            out = self.ref.train_steps(self.reference(low), batches, self.calibs, self.grid,
                                       self.cfg)
            return {"losses": out["losses"], "pred": out["pred"], "grads": norms(out["grads"]),
                    "change": norms(out["change"])}

        ref = steps()
        twin = self.ref.train_forward(self.reference(self.twin), batches[0][0], self.calibs,
                                      self.grid)
        sides = {"prog": self.first, **{low: steps(low) for low in lows}}
        out = {}
        for name, side in sides.items():
            nums = train_numbers(side, ref, detail and name == "prog")
            nums["pred1_vs_bf16"] = vs_twin(head_parts(side["pred"], ref["pred"], twin))
            out.update({(k if name == "prog" else f"{name}_{k}"): v for k, v in nums.items()})
        if detail:
            out["parts"] = {k: {kk: vv for kk, vv in v.items() if kk != "pred"}
                            for k, v in {"ref": ref, **sides}.items()}
        return out
