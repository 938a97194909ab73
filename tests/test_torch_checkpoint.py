"""The port's checkpoints, weight conversion and observability on the CPU:
a checkpoint round trip (state dict, momentum, OneCycle step, epoch, meta
as the JAX package's `_meta`, generator states) and the JAX "latest"
rule; a reference `.pth` through the port's `load_reference_checkpoint`
equal to JAX's `convert_state_dict` carried across by `params_from_jax`;
torchvision weights partial-loaded as JAX's loader does on the same
fabricated state dict; the metrics writer, the profiler trace and the NaN
check."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.model_zoo

from vfa_tpu import checkpoint as jckpt
from vfa_tpu import convert as jconvert
from vfa_tpu.config import TrainConfig as JTrainConfig
from vfa_tpu.config import mc_opts
from vfa_tpu.data.synthetic import make_scene
from vfa_tpu.data.synthetic import tiny_config as j_tiny_config
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import checkpoint, convert, observability
from vfa_tpu_torch.config import TrainConfig, get_config
from vfa_tpu_torch.data.synthetic import tiny_config
from vfa_tpu_torch.model.vfanet import VFANet, init_weights
from vfa_tpu_torch.train_lib import make_optimizer

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = tiny_config(get_config("MultiviewC"))


def _model(seed):
    return init_weights(VFANet(CFG), torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def jax_trees():
    """JAX init trees of the tiny MultiviewC VFANet (shapes from
    `eval_shape`, values from a numpy seed)."""
    tc = j_tiny_config(mc_opts)
    s = make_scene(tc, seed=0, num_objects=2)
    shapes = jax.eval_shape(create_model(tc, JTrainConfig(pretrained=False)).init,
                            jax.random.PRNGKey(0), jnp.asarray(s.images[None]),
                            jnp.asarray(s.calibs[None]), jnp.asarray(s.grid))
    rng = np.random.default_rng(0)
    trees = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(x.dtype), shapes)
    return trees["params"], trees["batch_stats"]


def test_checkpoint_round_trip(tmp_path):
    tcfg = TrainConfig(epochs=7, pretrained=False)
    model = _model(0)
    opt = make_optimizer(model, tcfg, steps_per_epoch=3)
    for _ in range(2):
        opt.zero_grad()
        sum((p * p).sum() for p in model.parameters()).backward()
        opt.step()
    gen = np.random.default_rng(12)
    gen.integers(0, 9, 5)
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), model, opt, CFG, tcfg, 3,
                                      extra={"dim_mean": [1.0, 2.0, 3.0]},
                                      rng={"loader": gen.bit_generator.state})
    assert os.path.basename(path) == "epoch_0003"

    other = _model(1)
    other_opt = make_optimizer(other, tcfg, steps_per_epoch=3)
    assert checkpoint.restore_checkpoint(path, other, other_opt) == 3
    for (k, v), (k2, v2) in zip(model.state_dict().items(), other.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    assert other_opt.count == opt.count == 2
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           other_opt.state[q]["momentum_buffer"])
    state = checkpoint.load_state(path)       # weights_only=True
    fresh = np.random.default_rng(0)
    fresh.bit_generator.state = state["rng"]["loader"]
    assert fresh.integers(0, 1 << 30) == gen.integers(0, 1 << 30)

    cfg, got_tcfg, epoch, extra = checkpoint.load_meta(path)
    assert cfg == CFG and got_tcfg == tcfg and epoch == 3
    assert extra == {"dim_mean": [1.0, 2.0, 3.0]}
    # the meta is the JAX package's, field for field
    want = jckpt._meta(j_tiny_config(mc_opts), JTrainConfig(epochs=7, pretrained=False),
                       3, {"dim_mean": [1.0, 2.0, 3.0]})
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f) == json.loads(json.dumps(want, default=str))
    assert state["meta"] == json.loads(json.dumps(want, default=str))


def test_latest_checkpoint_rule_matches_jax(tmp_path):
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    for d in ("epoch_0005", "epoch_0010", "epoch_0002", "other"):
        os.makedirs(tmp_path / d)
    (tmp_path / "epoch_9999").write_text("a file, not a checkpoint")
    assert checkpoint.latest_checkpoint(str(tmp_path)) == \
        jckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_0010")


def test_reference_checkpoint_equals_jax_conversion(tmp_path, jax_trees):
    params, stats = jax_trees
    ref = dict(convert.params_from_jax(params, stats))
    # the buffers a reference state dict carries that JAX skips
    ref["fuse.1.num_batches_tracked"] = torch.tensor(7)
    ref["vfa8.z_corners"] = torch.zeros(3)
    ref["mean"] = torch.zeros(3)
    torch.save({"model_state_dict": ref, "epoch": 4}, tmp_path / "ref.pth")
    zeros = jax.tree_util.tree_map(np.zeros_like, (params, stats))
    jp, js = jconvert.load_reference_checkpoint(str(tmp_path / "ref.pth"), *zeros)
    want = convert.params_from_jax(jp, js)

    model = convert.load_reference_checkpoint(str(tmp_path / "ref.pth"), _model(3))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    for bad, err in (({"foo.weight": torch.zeros(1)}, KeyError),
                     ({"tytx_pred.1.running_mean": torch.zeros(1)}, KeyError),
                     ({"lat8.weight": torch.zeros(1)}, ValueError)):
        with pytest.raises(err):
            convert.convert_state_dict(bad, got)
    assert set(convert.convert_state_dict({"foo.weight": torch.zeros(1)}, got,
                                          strict=False)) == set(got)


def test_torchvision_partial_load_equals_jax(tmp_path, jax_trees, monkeypatch):
    params, _ = jax_trees
    model = _model(4)
    rng = np.random.default_rng(6)
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("base."):
            sd[k[5:]] = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
            if k.endswith("bn1.weight") or "downsample.1.weight" in k:
                sd[k[5:-6] + "running_mean"] = torch.ones(v.shape)
                sd[k[5:-6] + "num_batches_tracked"] = torch.tensor(1)
    sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, 512), torch.ones(1000)
    sd["layer9.0.conv1.weight"] = torch.ones(3, 3, 3, 3)     # no such module
    sd["conv1.bias"] = torch.ones(64)                        # no such parameter
    monkeypatch.setattr(torch.utils.model_zoo, "load_url", lambda url: sd)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    want = convert.named_jax_leaves(jconvert.load_torchvision_resnet_params(zeros))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = convert.load_torchvision_resnet_params(model, sd).state_dict()
    for k, v in got.items():
        if k.startswith("base."):
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            assert torch.equal(v, before[k]), k

    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    with pytest.raises(FileNotFoundError, match="resnet18"):
        convert.load_torchvision_resnet_file(_model(5))
    os.makedirs(tmp_path / "hub" / "checkpoints")
    torch.save(sd, convert.torchvision_resnet_path())
    loaded = convert.load_torchvision_resnet_file(_model(5))
    assert loaded == str(tmp_path / "hub" / "checkpoints" / "resnet18-5c106cde.pth")


def test_metrics_writer_and_profile_trace(tmp_path):
    w = observability.MetricsWriter(str(tmp_path / "run"))
    w.scalars("train", {"loss": 1.5}, 1)
    w.text("config", "{}")
    w.close()
    w = observability.MetricsWriter(str(tmp_path / "run"))     # appends
    w.scalars("val", {"loss": 0.5, "acc": 2}, 2)
    assert w.tensorboard
    w.close()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in recs] == [("train", 1), ("val", 2)]
    assert recs[1]["loss"] == 0.5 and recs[1]["acc"] == 2 and "time" in recs[1]
    assert os.listdir(tmp_path / "run" / "tensorboard")

    with observability.profile_trace(None):
        pass
    with observability.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(tmp_path / "prof")
    assert os.path.getsize(tmp_path / "prof" / trace) > 0


def test_check_finite_names_the_step():
    g = torch.ones(3)
    observability.check_finite(4, torch.tensor(1.0), [("a", g), ("b", None)])
    with pytest.raises(FloatingPointError, match="step 4: b"):
        observability.check_finite(4, torch.tensor(1.0), [("a", g), ("b", g / 0 * 0)])
    with pytest.raises(FloatingPointError, match="step 9: loss"):
        observability.check_finite(9, torch.tensor(float("inf")), [])
