"""A whole run of each cell on the CPU at a tiny size (the look for a card
skipped), sound and then with the timed path broken underneath: `correct`
must come out true, then false for each fault that the cell can have."""

import pytest
import torch

import program
import run

CPU = torch.device("cpu")
ARGS = ["--seed", "31415926535", "--seconds", "0.2", "--trace", "0"]


def broken_server(fault):
    real = program.server

    def server(*args, **kwargs):
        serve = real(*args, **kwargs)

        def call(images):
            B = images.shape[0]
            if fault == "half_batch":
                pred, det = serve(images[:B // 2])
                twice = lambda d: {k: torch.cat([v, v])[:B] for k, v in d.items()}
                return twice(pred), twice(det)
            pred, det = serve(images)
            loc = det["location"].clone()
            loc[0, 0, 0] += 1.0
            return pred, {**det, "location": loc}

        call.model = serve.model
        return call

    return server


def broken_trainer(fault):
    real = program.trainer

    def trainer(*args, **kwargs):
        step, model, opt = real(*args, **kwargs)
        if fault == "frozen":
            opt.step = lambda closure=None: None
            return step, model, opt
        if fault == "half_batch":
            def half(batch, rig):
                B = batch["images"].shape[0]
                return step({k: v[:B // 2] if k != "grid" else v for k, v in batch.items()}, rig)
            return half, model, opt

        return step, model, opt

    return trainer


def correct(spec, cell) -> bool:
    return run.run(["--workload", cell, *ARGS], device=CPU, spec=spec)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("mvc_serve_b32", None), ("mvc_serve_b32", "half_batch"), ("mvc_serve_b32", "answer"),
    ("wt_serve_b32", None), ("wt_serve_b32", "half_batch"), ("wt_serve_b32", "answer"),
    ("mvc_request_b1", None), ("mvc_request_b1", "answer")])
def test_serving_faults(tiny_spec, monkeypatch, cell, fault):
    if fault:
        monkeypatch.setattr(program, "server", broken_server(fault))
    assert correct(tiny_spec(cell), cell) is (fault is None)


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch", "answer"])
def test_training_faults(tiny_spec, monkeypatch, fault):
    """answer: the loss altered where it is produced (and so its gradient)."""
    if fault == "answer":
        from vfa_tpu_torch import train_lib

        real = train_lib.compute_loss2d

        def altered(*args, **kwargs):
            total, parts = real(*args, **kwargs)
            return total * 1.5, {**parts, "loss": total * 1.5}

        monkeypatch.setattr(train_lib, "compute_loss2d", altered)
    elif fault:
        monkeypatch.setattr(program, "trainer", broken_trainer(fault))
    assert correct(tiny_spec("wt_train_b8"), "wt_train_b8") is (fault is None)
