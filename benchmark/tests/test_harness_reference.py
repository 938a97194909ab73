"""The plain reference against the port's plain CPU path, both in fp32, at
a tiny size: a whole cell of each kind, the program in fp32, must read the
distances of two fp32 implementations that sum in other orders (the
reference samples in fp64)."""

import copy

import pytest
import torch

import calibrate
import run

CPU = torch.device("cpu")


def fp32_numbers(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["config"]["dtype"] = "float32"
    return next(calibrate.readings(spec, CPU, [20260101], 0, 0.2))


@pytest.mark.parametrize("cell", ["mvc_serve_b32", "wt_serve_b32", "mvc_request_b1"])
def test_serving_reference_is_the_port_in_fp32(tiny_spec, cell):
    got = fp32_numbers(tiny_spec(cell))
    assert got["pred_rel_l2"] < 1e-4
    assert got["decode_mismatch"] == 0


@pytest.mark.parametrize("config", ["wildtrack_bf16", "multiviewc_bf16"])
def test_training_reference_is_the_port_in_fp32(tiny_spec, config):
    """Three steps of the 2D and the 3D losses; the worst leaf's change
    moves most (a GroupNorm scale's change is the difference of two close
    updates)."""
    import conftest

    spec = tiny_spec("wt_train_b8")
    spec["config"] = conftest.tiny({**spec, "config": run.load_json(
        run.HERE, "configs", f"{config}.json")})["config"]
    got = fp32_numbers(spec)
    assert got["loss_gap"] < 1e-3
    assert got["grad_gap"] < 2e-3
    assert got["change_gap"] < 2e-2


@pytest.mark.parametrize("cell", ["mvc_serve_b32", "wt_train_b8"])
def test_control_fails_at_a_tiny_size(tiny_spec, cell):
    """The control (the reference with float8 operands in the program's
    place) fails the cell's limits where the program passes them."""
    from check import verdict

    spec = tiny_spec(cell)
    limits = spec["settings"]["limits"]
    row = next(calibrate.readings(spec, CPU, [8675309], 1, 0.2))
    assert verdict(row, limits)[0], row
    fp8 = {k: row.get(f"fp8_{k}", 0) for k in limits}
    assert not verdict(fp8, limits)[0], row
