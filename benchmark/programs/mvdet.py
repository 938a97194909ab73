"""The adapter of the port's MVDet (`vfa_tpu_torch.model.mvdet`), the
architecture `"mvdet"` (`program.py` names the functions every adapter
gives). Set-up makes the cameras' ground-plane sampling positions from the
calibrations (`geometry.ground_positions`); serving runs the port's model
in the configuration's dtype in eval mode and its decode
(`codec.decode_map`). MVDet's training is out of scope: `trainer` raises.
"""

from __future__ import annotations

import torch


def dataset_config(ds: dict):
    """The port's DatasetConfig of a configuration's `dataset` group."""
    from vfa_tpu_torch.config import DatasetConfig

    return DatasetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ds.items()})


def port_model() -> dict:
    """The `model` group of the MVDet that the port builds, under the
    configuration's keys."""
    from vfa_tpu_torch.model import mvdet
    from vfa_tpu_torch.model.resnet import batch_norm
    from vfa_tpu_torch.model.vfanet import RESNET_LAYERS

    return {"base": mvdet.BASE, "resnet_layers": list(RESNET_LAYERS[mvdet.BASE]),
            "dilation": list(mvdet.DILATE), "norm": type(batch_norm(1)).__name__,
            "img_reduce": mvdet.IMG_REDUCE, "grid_reduce": mvdet.GRID_REDUCE}


def check_model(cfg: dict) -> None:
    """Refuse a configuration whose `model` group is not the port's MVDet:
    the reference and the work counts read that group, the port builds
    its own constants."""
    port = port_model()
    if cfg["model"] != port:
        raise ValueError(f"the configuration's model {cfg['model']} is not the port's {port}")


def prepare(cfg: dict, calibs, device, train: bool, cache_dir: str):
    """The sampling positions (N, L, W, 2) on the device, from the
    calibrations and the dataset's BEV grid."""
    from vfa_tpu_torch.geometry import ground_positions, make_grid
    from vfa_tpu_torch.model.mvdet import IMG_REDUCE

    if train:
        raise NotImplementedError("MVDet's training is out of scope of the benchmark")
    check_model(cfg)
    ds = dataset_config(cfg["dataset"])
    grid = make_grid(ds.world_size, ds.cube_size[:2], ds.name)
    map_hw = tuple(int(s / IMG_REDUCE) for s in ds.image_size)
    return ground_positions(calibs, grid, ds.name, ds.image_size, map_hw).to(device)


def server(cfg: dict, state: dict, positions, device, calibs, grid):
    """serve(images) -> (predictions, detections), both on the device: the
    port's MVDet loaded strictly from `state`, cast to the configuration's
    dtype (every floating parameter and buffer) in eval mode (BatchNorm on
    its running statistics), then the decode of its score map over the
    grid's cell positions."""
    from vfa_tpu_torch.codec import decode_map
    from vfa_tpu_torch.model.mvdet import MVDet

    check_model(cfg)
    dec = cfg["decode"]
    model = MVDet(dataset_config(cfg["dataset"]))
    model.load_state_dict(state, strict=True)
    model = model.to(device=device, dtype=getattr(torch, cfg["dtype"])).eval()
    cells = None if grid is None else grid[..., :2].contiguous()

    @torch.no_grad()
    def serve(images):
        pred = model(images, positions)
        det = decode_map(pred["heatmap"], cells, cls_thresh=dec["cls_thresh"],
                         nms_dist=dec["nms_dist"], topk=dec["topk"])
        return pred, det

    serve.model = model
    return serve


def trainer(cfg: dict, state: dict, device):
    raise NotImplementedError("MVDet's training (its Gaussian targets and losses, BatchNorm "
                              "statistics per camera) is out of scope of the benchmark")


def clock_points(model):
    """No layer clock: MVDet's layers are read from the port's spans."""
    return None
