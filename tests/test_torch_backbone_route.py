"""VFANet's backbone route (`vfa_tpu_torch/ops/group_norm.py`) on the CPU
at a tiny size: the route's plain versions against `nn.GroupNorm` and the
block's library chain bit for bit, for each norm's epilogue (a
downsample's none, a block's ReLU, its residual add and ReLU, the stem's
ReLU and max-pool); a bf16 no-grad forward on CPU tensors with the
parent's bits (the parent's block and stem written out here); and the
route's rule, with the card faked: a bf16 forward that needs no gradient
hands every GroupNorm of the trunk to the kernel wrapper (20 calls),
while a forward that needs a gradient, fp32 and MVDet's BatchNorm trunk
never reach it, and nothing is launched on the CPU. The kernels
themselves are held against the library on the card
(`test_torch_kernels_gpu.py`)."""

import dataclasses

import pytest
import torch
from torch import nn

from vfa_tpu_torch import kernels
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.model.resnet import BasicBlock, ResNetGN
from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
from vfa_tpu_torch.ops import group_norm as gn
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops import stem as tstem

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ACTS = ["none", "relu", "add_relu", "relu_pool"]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def library_chain(norm, x, act, identity=None):
    """The parent's ops after a norm module, one by one."""
    y = norm(x)
    if act == "relu":
        return torch.relu(y)
    if act == "add_relu":
        return torch.relu(y + identity)
    if act == "relu_pool":
        return nn.MaxPool2d(3, 2, 1)(torch.relu(y))
    return y


def parent_block(block, x):
    """BasicBlock.forward as the parent wrote it."""
    identity = x if block.downsample is None else block.downsample(x)
    out = torch.relu(block.bn1(block.conv1(x)))
    out = block.bn2(block.conv2(out))
    return torch.relu(out + identity)


def parent_stem(base, x):
    """ResNetGN.stem as the parent wrote it."""
    x = base.conv1(x)
    if base.fused_stem_on():
        return tstem.gn_relu_pool(x, base.bn1.weight, base.bn1.bias, base.bn1.num_groups,
                                  base.bn1.eps)
    return nn.MaxPool2d(3, 2, 1)(torch.relu(base.bn1(x)))


def _norm_input(dtype, layout, C=64, H=11, W=14, seed=0):
    g = torch.Generator().manual_seed(seed)
    norm = nn.GroupNorm(16, C, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.randn(C, generator=g))
        norm.bias.copy_(torch.randn(C, generator=g) * 0.5)
    norm = norm.to(dtype)
    x = (torch.randn(3, C, H, W, generator=g) * 2 + 1).to(dtype)
    ident = torch.randn(3, C, H, W, generator=g).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
        ident = ident.contiguous(memory_format=torch.channels_last)
    return norm, x, ident


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("act", ACTS)
def test_plain_versions_equal_the_library_chain(act, dtype, layout):
    """`group_norm_act_plain`, the wrapper on CPU tensors and the route
    (`norm_act`, `norm_relu_pool`) give `nn.GroupNorm` and the block's
    ops bit for bit, and launch nothing."""
    norm, x, ident = _norm_input(dtype, layout)
    identity = ident if act == "add_relu" else None
    want = library_chain(norm, x, act, identity)
    n0 = kernels.launch_counts()
    with torch.no_grad():
        got = [gn.group_norm_act_plain(x, norm.weight, norm.bias, 16, 1e-5, act, identity),
               gn.group_norm_nhwc(x, norm.weight, norm.bias, 16, 1e-5, act, identity),
               gn.norm_relu_pool(norm, x) if act == "relu_pool"
               else gn.norm_act(norm, x, act, identity)]
    assert kernels.launch_counts() == n0
    for g in got:
        assert same(g, want.detach())


@pytest.fixture(scope="module")
def tiny_vfanet():
    """The tiny MultiviewC config, its bf16 window rig, seeded weights and
    images of 2 scenes."""
    tc = tiny_config(get_config("MultiviewC"))
    rig = trig.build_rig(make_calibrations(tc), tc,
                         make_grid(tc.world_size, tc.cube_size[:2], tc.name),
                         trig.pyramid_feat_shapes(tc.resize_size), tile_v=16,
                         band_buckets=3, device="cpu", dtype=torch.bfloat16)
    state = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).state_dict()
    images = torch.rand((2, tc.num_cam, *tc.resize_size, 3),
                        generator=torch.Generator().manual_seed(1))
    return tc, rig, state, images


def _vfanet(tiny_vfanet, dtype=torch.bfloat16):
    tc, _, state, _ = tiny_vfanet
    model = VFANet(tc)
    model.load_state_dict(state, strict=True)
    return cast_model(model, dtype).eval()


@pytest.mark.parametrize("fused_stem", ["0", "1"])
def test_bf16_no_grad_forward_on_the_cpu_gives_the_parents_bits(tiny_vfanet, monkeypatch,
                                                                fused_stem):
    """A bf16 serving forward (eval, no_grad) of VFANet on CPU tensors:
    every output equals, bit for bit, the same forward through the
    parent's block and stem, with the fused stem off and on."""
    _, rig, _, images = tiny_vfanet
    monkeypatch.setenv("VFA_FUSED_STEM", fused_stem)
    model = _vfanet(tiny_vfanet)
    x = images.to(torch.bfloat16)
    n0 = kernels.launch_counts()
    with torch.no_grad():
        got = model(x, rig)
    assert kernels.launch_counts() == n0
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(BasicBlock, "forward", parent_block)
        m.setattr(ResNetGN, "stem", parent_stem)
        want = model(x, rig)
    assert got.keys() == want.keys()
    for k in got:
        assert same(got[k], want[k]), k


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, True), (torch.float32, False),
                                        (torch.float32, True)], ids=["bf16-grad", "fp32",
                                                                     "fp32-grad"])
def test_backbone_on_the_cpu_gives_the_parents_bits(dtype, grad):
    """The trunk alone, in training mode where a gradient is needed and in
    fp32: the parent's features bit for bit, and with a gradient the
    parent's input gradient too."""
    net = ResNetGN().to(dtype)
    x = torch.rand((2, 3, 40, 56), generator=torch.Generator().manual_seed(4)).to(dtype)
    with torch.set_grad_enabled(grad):
        xs = [x.clone().requires_grad_(grad) for _ in range(2)]
        got = net(xs[0])
        with pytest.MonkeyPatch.context() as m:
            m.setattr(BasicBlock, "forward", parent_block)
            m.setattr(ResNetGN, "stem", parent_stem)
            want = net(xs[1])
    for a, b in zip(got, want):
        assert same(a.detach(), b.detach())
    if grad:
        sum(f.float().sum() for f in got).backward()
        sum(f.float().sum() for f in want).backward()
        assert same(xs[0].grad, xs[1].grad)


def _fake_card(monkeypatch):
    """Make the route see the card and record each call of the kernels'
    wrapper by its epilogue; the call returns the plain chain's output."""
    calls = []

    def wrapper(x, weight, bias, num_groups, eps, act="none", identity=None):
        calls.append(act)
        return gn.group_norm_act_plain(x, weight, bias, num_groups, eps, act, identity)

    monkeypatch.setattr(gn, "on_card", lambda x: True)
    monkeypatch.setattr(gn, "group_norm_nhwc", wrapper)
    return calls


def _mvdet(dtype):
    from vfa_tpu_torch.model.mvdet import MVDet, init_weights as mvdet_init

    cfg = dataclasses.replace(get_config("Wildtrack"), world_size=(32, 96),
                              image_size=(128, 192), resize_size=(64, 96), num_cam=2)
    return mvdet_init(MVDet(cfg), torch.Generator().manual_seed(23)).to(dtype).eval()


@pytest.mark.parametrize("case,want", [
    ("bf16", 20), ("bf16_grad", 0), ("bf16_grad_on_frozen", 20), ("fp32", 0),
    ("mvdet_bf16", 0), ("cpu_bf16", 0),
])
def test_route_rule_with_the_card_faked(monkeypatch, case, want):
    """With the card faked (`on_card`), a bf16 trunk forward that needs no
    gradient hands all 20 GroupNorms to the wrapper (the stem's ReLU and
    pool once, a ReLU 8 times, an add and ReLU 8 times, a downsample's
    norm alone 3 times), also with gradients on where neither the input
    nor a parameter needs one; a forward that needs a gradient, fp32,
    MVDet's BatchNorm trunk and (not faked) CPU tensors never reach it;
    and nothing is launched."""
    calls = _fake_card(monkeypatch) if case != "cpu_bf16" else []
    if case == "cpu_bf16":
        monkeypatch.setattr(gn, "group_norm_nhwc",
                            lambda *a, **k: calls.append("called") or pytest.fail())
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    x = torch.rand((2, 3, 40, 56), generator=torch.Generator().manual_seed(5)).to(dtype)
    n0 = kernels.launch_counts()
    if case == "mvdet_bf16":
        net = _mvdet(dtype)
        with torch.no_grad():
            net.trunk(x.permute(0, 2, 3, 1))
    else:
        net = ResNetGN().to(dtype).eval()
        if case == "bf16_grad_on_frozen":
            net.requires_grad_(False)
        with torch.set_grad_enabled(case.startswith("bf16_grad")):
            net(x)
    assert kernels.launch_counts() == n0
    assert len(calls) == want
    if want:
        assert sorted(calls) == sorted(["relu_pool"] + ["relu"] * 8 + ["add_relu"] * 8
                                       + ["none"] * 3)


@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
def test_fused_stem_switch_chooses_the_training_backward_only(monkeypatch, grad):
    """VFA_FUSED_STEM=1 with the card faked: a bf16 serving forward takes
    the stem's kernel (the wrapper's ReLU + pool) and not
    `ops.stem.gn_relu_pool`; a training forward takes `gn_relu_pool`."""
    calls = _fake_card(monkeypatch)
    fused = []
    real = tstem.gn_relu_pool
    monkeypatch.setattr(tstem, "gn_relu_pool", lambda *a: fused.append(1) or real(*a))
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    net = ResNetGN().to(torch.bfloat16)
    x = torch.rand((1, 3, 40, 56), generator=torch.Generator().manual_seed(6))
    with torch.set_grad_enabled(grad):
        net(x.to(torch.bfloat16))
    assert calls.count("relu_pool") == (0 if grad else 1)
    assert len(fused) == (1 if grad else 0)
    assert len(calls) == (0 if grad else 20)


@pytest.mark.parametrize("C,groups,takes", [(64, 16, True), (128, 16, True), (256, 16, True),
                                            (512, 16, True), (48, 16, False), (96, 16, False),
                                            (64, 32, False), (1024, 16, True),
                                            (2048, 512, True), (2048, 256, True),
                                            (4096, 16, False)])
def test_kernel_shapes(C, groups, takes):
    """The kernels take C a multiple of 8 with C / 8 dividing 256 and 4 or
    a multiple of 8 channels a group; the route sends the rest to the
    library."""
    assert gn.kernel_takes(C, groups) == takes


@pytest.mark.parametrize("fault", ["none", "boundary", "near_zero", "mean", "rstd", "nan"])
def test_stats_vs_aten_passes_atens_own_and_flags_a_fault(fault):
    """`stats_vs_aten`, which the card tests and the smoke hold the
    kernel's statistics to: ATen's own fp32 statistics read 0 and sound,
    also where ATen's bf16 statistic lies across a rounding boundary from
    its fp32 one (its bf16 path sums in an order of its own), and a mean
    near 0 a few bf16 ulps but far less than STATS_TOL from ATen's; a mean
    or rstd moved by 2^-10 of its scale reads above STATS_TOL; a NaN where
    ATen has none is not sound."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(3, 64, 6, 7, generator=g) * 2 + 1).to(torch.bfloat16)
    aten, ref = gn.aten_stats(x, 16)
    got = ref.clone()
    if fault == "boundary":     # fp32 just below the boundary, ATen's bf16 above it
        lo = ref[1, 3, 1].to(torch.bfloat16)
        hi = (lo.view(torch.int16) + 1).view(torch.bfloat16)
        mid = (lo.float() + hi.float()) / 2
        ref[1, 3, 1] = got[1, 3, 1] = mid * (1 - 2 ** -20)
        aten[1, 3, 1] = hi.float()
        d_mean, d_rstd, off, sound = gn.stats_vs_aten(got, ref, aten)
        assert (d_mean, d_rstd, sound) == (0.0, 0.0, True)
        assert off.nonzero().tolist() == [[1, 3]]
        return
    if fault == "near_zero":    # 1e-7 against 1.03e-7: 6 bf16 ulps, far below STATS_TOL
        ref[2, 5, 0], got[2, 5, 0] = 1e-7, 1.03e-7
        aten[2, 5, 0] = ref[2, 5, 0].to(torch.bfloat16).float()
        d_mean, d_rstd, off, sound = gn.stats_vs_aten(got, ref, aten)
        assert d_mean < gn.STATS_TOL and sound
        assert off.nonzero().tolist() == [[2, 5]]
        return
    if fault == "mean":
        got[1, 3, 0] += (got[1, 3, 0].abs() + 1 / got[1, 3, 1]) * 2 ** -10
    elif fault == "rstd":
        got[2, 7, 1] *= 1 + 2 ** -10
    elif fault == "nan":
        got[0, 0, 0] = float("nan")
    d_mean, d_rstd, off, sound = gn.stats_vs_aten(got, ref, aten)
    assert off.shape == (3, 16)
    if fault == "none":
        assert (d_mean, d_rstd, bool(off.any()), sound) == (0.0, 0.0, False, True)
    elif fault == "nan":
        assert not sound
    else:
        assert max(d_mean, d_rstd) > gn.STATS_TOL


@pytest.mark.parametrize("act", ACTS)
def test_library_route_frees_the_norms_input_before_the_epilogue(act):
    """On the library route (here a BatchNorm in eval mode, MVDet's
    serving trunk) the convolution's output handed to `norm_act` /
    `norm_relu_pool` is freed once the norm has read it, before the ReLU,
    the add or the pool allocate, as in the chain the block wrote out: a
    serving peak set in a block does not rise by an activation."""
    import weakref

    inputs = []

    class Norm(nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = nn.BatchNorm2d(8).eval()

        def forward(self, x):
            inputs.append(weakref.ref(x))
            return self.bn(x)

    freed = []

    def watch(op):
        return lambda *a, **k: freed.append(inputs[-1]() is None) or op(*a, **k)

    x = torch.randn(2, 8, 6, 6)
    with pytest.MonkeyPatch.context() as m, torch.no_grad():
        m.setattr(torch, "relu", watch(torch.relu))
        if act == "relu_pool":
            gn.norm_relu_pool(Norm(), x * 2)
        else:
            gn.norm_act(Norm(), x * 2, act, x if act == "add_relu" else None)
    assert freed == ([] if act == "none" else [True])
    assert inputs[-1]() is None


@pytest.mark.parametrize("norm", ["batch_norm", "group_norm"])
def test_block_frees_its_intermediates_before_its_last_relu(norm):
    """A BasicBlock on the library route (eval, no gradient): by the time
    its last ReLU runs, conv1's output, the first ReLU's and conv2's are
    freed, as in the parent's block."""
    import weakref

    from vfa_tpu_torch.model import resnet

    block = BasicBlock(64, 64, norm=getattr(resnet, norm)).eval()
    refs = {}
    for name in ("conv1", "conv2"):
        getattr(block, name).register_forward_hook(
            lambda m, a, out, name=name: refs.__setitem__(name, weakref.ref(out)))
    states = []
    real = torch.relu

    def relu(t):
        states.append({k: r() is None for k, r in refs.items()})
        out = real(t)
        refs.setdefault("relu1", weakref.ref(out))
        return out

    with pytest.MonkeyPatch.context() as m, torch.no_grad():
        m.setattr(torch, "relu", relu)
        block(torch.randn(2, 64, 6, 6))
    assert states[-1] == {"conv1": True, "conv2": True, "relu1": True}
