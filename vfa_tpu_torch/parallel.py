"""Multi-process training on torch.distributed (port of
`vfa_tpu/parallel.py`).

JAX lets GSPMD partition one program over a (data, cam) device mesh; here
each rank runs the model on its share and the collectives are written out.
Scenes shard over the mesh's `data` axis and cameras over its `cam` axis:
the per-camera BEV sum (`vfa/model/vfanet.py:64-82` in the reference) is
then an all-reduce over `cam`. The fuse BatchNorms take their statistics
over the global batch (an all-reduce over `data`, as GSPMD computes them),
and the loss over the global batch (its counts are summed over `data`, so
each rank's loss is its share of the global one).

Gradients after a step (`reduce_gradients`): every parameter sums over
`data` (each rank holds its share of the global loss's gradient). The
parameters upstream of the camera sum (backbone, laterals, collapses) also
sum over `cam`, since each rank saw only its cameras; those downstream of
it (fuse, heads) see the same summed features on every rank of a cam group
and are not counted twice. `parallel_bev.py` adds the `bev` axis.

Every collective is an `all_reduce` or a `broadcast`, the two that gloo
also runs on CUDA tensors, so the same code runs with gloo on the CPU,
with gloo on CUDA tensors of ranks that share one card, and with NCCL, one
rank per card (`backend_for`).
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

def backend_for(device_type: str, num_processes: int) -> Tuple[str, str]:
    """(backend, reason): NCCL when each rank has a card of its own, gloo
    otherwise (the CPU, or ranks that share a card: NCCL refuses two ranks
    on one device)."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if cards >= num_processes:
        return "nccl", f"{cards} cards for {num_processes} ranks, one each"
    return "gloo", f"{cards} card(s) shared by {num_processes} ranks"


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device: str = "cuda") -> torch.device:
    """Join the process group of `num_processes` ranks as `process_id`
    through the rendezvous at `coordinator` (host:port, or any
    init_method URL such as file://...), with the backend of `backend_for`;
    returns this rank's device (card process_id mod the card count).
    Prints the rule's choice."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend, why = backend_for(dev.type, num_processes)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    print(f"multihost: rank {process_id} of {num_processes}, backend {backend} "
          f"({why}), device {dev}", flush=True)
    return dev


def process_local_indices(n: int, process_id: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """Frame indices this process loads: a strided shard of the dataset
    (the identity with one process)."""
    pid = (dist.get_rank() if dist.is_initialized() else 0) if process_id is None else process_id
    pc = (dist.get_world_size() if dist.is_initialized() else 1) if process_count is None else process_count
    return np.arange(n)[pid::pc]


class Mesh:
    """The ranks as a grid of `shape` over `axis_names`, row-major (rank =
    the flat index of its coordinates), with a process group along every
    set of axes. Every rank must build the same meshes in the same order
    (`dist.new_group` is collective). Without an initialized process group
    the mesh is one rank, and every collective is a no-op."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(self.shape) != world:
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.shape))} "
                             f"!= {world} ranks")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
        self._groups = {}
        # every subset of axes, in a fixed order on every rank
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(range(len(self.shape)), k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                mine = None
                others = [a for a in range(len(self.shape)) if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    ranks = []
                    for moving in itertools.product(*(range(self.shape[a]) for a in axes)):
                        c = [0] * len(self.shape)
                        for a, v in zip(others, fixed):
                            c[a] = v
                        for a, v in zip(axes, moving):
                            c[a] = v
                        ranks.append(int(np.ravel_multi_index(c, self.shape)))
                    group = (None if len(ranks) == world
                             else dist.new_group(ranks))
                    if self.rank in ranks:
                        mine = group if group is not None else dist.group.WORLD
                self._groups[tuple(self.axis_names[a] for a in axes)] = mine

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    def group(self, axes):
        """The process group of this rank along `axes` (one name or
        several), or None when they span one rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes and self.size(a) > 1)
        return self._groups[axes] if axes else None

    def __repr__(self):
        return "x".join(f"{n}{s}" for n, s in zip(self.axis_names, self.shape))


def make_mesh(data: int = -1, cam: int = 1) -> Mesh:
    """A (data, cam) mesh of all ranks; data=-1 takes the rest."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if world % cam:
            raise ValueError(f"{world} ranks not divisible by cam={cam}")
        data = world // cam
    return Mesh(("data", "cam"), (data, cam))


# --- collectives under autograd -------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _SumShared(torch.autograd.Function):
    """Sum over the group of partials that every rank then consumes in its
    own way: the backward sums the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """Sum over the group of partials whose consumers are replicated (the
    same computation on every rank): each rank's cotangent is already the
    whole one, so the backward passes it on."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToPartial(torch.autograd.Function):
    """A replicated input that each rank uses for its own part: the
    forward passes it on, the backward sums the parts' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumShared.apply(x, group)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumReplicated.apply(x, group)


def copy_to_partial(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToPartial.apply(x, group)


def sum_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of a tensor, detached (counts, reported losses)."""
    return x if group is None else _all_reduce(x.detach(), group)


# --- batches, parameters and gradients ------------------------------------

CAMERA_KEYS = ("images", "calibs")
SCENE_KEYS = ("images", "calibs", "heatmap", "location", "valid", "dimension",
              "rotation", "objects", "index", "frame")


def _take(v, sl, axis):
    if isinstance(v, list):
        return v[sl]
    idx = [slice(None)] * axis + [sl]
    return v[tuple(idx)]


def camera_slice(mesh: Mesh, num_cam: int) -> slice:
    """This rank's cameras of `num_cam`: a contiguous share by its cam
    coordinate."""
    cams = mesh.size("cam")
    if num_cam % cams:
        raise ValueError(f"{num_cam} cameras not divisible by cam={cams}")
    per = num_cam // cams
    return slice(mesh.index("cam") * per, (mesh.index("cam") + 1) * per)


def make_global_batch(local_batch: Dict, mesh: Mesh) -> Dict:
    """This rank's part of a batch whose scenes are already its data shard
    (the loaders' strided shard): its cameras. The port's counterpart of
    JAX's assembly of process-local batches into one global array."""
    out = dict(local_batch)
    for k in CAMERA_KEYS:
        if k in out:
            out[k] = _take(out[k], camera_slice(mesh, out[k].shape[1]), 1)
    return out


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's part of a global batch: its scenes (by its data
    coordinate) and its cameras; the grid is replicated."""
    out = {}
    for k, v in batch.items():
        if k in SCENE_KEYS:
            n = len(v)
            if n % mesh.size("data"):
                raise ValueError(f"{k}: {n} scenes not divisible by "
                                 f"data={mesh.size('data')}")
            per = n // mesh.size("data")
            v = _take(v, slice(mesh.index("data") * per,
                               (mesh.index("data") + 1) * per), 0)
        out[k] = v
    return make_global_batch(out, mesh)


def camera_rig(rig, mesh: Mesh):
    """A CameraRig cut to this rank's cameras (`camera_slice`): each
    bucket's A and starts and inv_perm, with the dII order made anew."""
    import dataclasses

    from vfa_tpu_torch.ops.rig import _dii_orders

    if mesh.size("cam") == 1:
        return rig
    cams = camera_slice(mesh, rig.scales[0].inv_perm.shape[0])
    scales = []
    for sr in rig.scales:
        starts = [s[cams].contiguous() for s in sr.starts]
        A = tuple(a[cams].contiguous() for a in sr.A)
        scales.append(dataclasses.replace(
            sr, A=A, starts=tuple(starts),
            inv_perm=sr.inv_perm[cams].contiguous(),
            dii_order=_dii_orders([s.cpu().numpy() for s in starts], sr.window_hw,
                                  [a.shape[-1] for a in A], sr.feat_hw,
                                  A[0].device)))
    return dataclasses.replace(rig, scales=scales)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0, so every rank
    starts from the same state. Returns the model."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in itertools.chain(model.parameters(), model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


def gradient_axes(model: torch.nn.Module) -> Dict[int, Tuple[str, ...]]:
    """The mesh axes that each parameter of VFANet (by id) sums its
    gradient over (module docstring; `parallel_bev.py` for bev): the image
    features (`VFANet.feature_modules`) over data and cam, the collapses
    over every axis, the rest over data and bev."""
    axes = {id(p): ("data", "bev") for p in model.parameters()}
    for mod in model.feature_modules():
        axes.update((id(p), ("data", "cam")) for p in mod.parameters())
    for mod in model.collapses():
        axes.update((id(p), ("data", "cam", "bev")) for p in mod.parameters())
    return axes


@torch.no_grad()
def reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every gradient over its `gradient_axes`: one flat all-reduce per
    process group."""
    axes = gradient_axes(model)
    buckets = {}
    for p in model.parameters():
        if p.grad is None:
            continue
        group = mesh.group(axes[id(p)])
        if group is not None:
            buckets.setdefault(id(group), (group, []))[1].append(p.grad)
    for group, grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def camera_psum_bev(mesh: Mesh, lats, boxes, collapse_kernel, collapse_bias):
    """The camera sum of the BEV with cameras sharded over the mesh's `cam`
    axis, written out: lats (N, C, fh, fw) and boxes (N, nl, L, W, 4) of
    all N cameras; this rank samples its share (`ops.voxel.sample_voxels`),
    collapses it (relu(vox @ kernel + bias), kernel (C*nl, O)), sums it and
    all-reduces the sum over `cam`. Returns (L, W, O), the same on every
    rank."""
    from vfa_tpu_torch.ops.voxel import sample_voxels

    cams = camera_slice(mesh, lats.shape[0])
    out = 0
    for lat, bx in zip(lats[cams], boxes[cams]):
        vox = sample_voxels(lat, bx)
        out = out + torch.relu(vox @ collapse_kernel + collapse_bias)
    return sum_replicated(out, mesh.group("cam"))


def shard_train_step(train_step, mesh: Mesh):
    """step(global_batch, rig): the train step of a model set up on `mesh`
    (`train_lib.make_train_step(..., mesh=mesh)`) on this rank's part of
    the global batch (`shard_batch`)."""
    def step(batch, rig=None):
        return train_step(shard_batch(batch, mesh), rig)

    return step


def free_port() -> int:
    """A free localhost port for a tcp:// rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
