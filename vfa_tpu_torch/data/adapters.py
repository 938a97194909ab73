"""Dataset adapters: MultiviewC, MultiviewX, Wildtrack (port of
`vfa_tpu/data/adapters.py`).

Parse per-dataset annotations + calibrations, build per-frame object lists
and cached gt heatmaps, and generate the `gt.txt` MODA evaluation file.

Reference behavior (all paths under the reference's vfa/data/):
  - MultiviewC (`multiviewC.py:22-164`): 7 cams, 560 frames, 3D cow boxes;
    OpenCV XML calibrations with R_z; RGK/GK heatmap caches; ClassAverage of
    cow dimensions.
  - MultiviewX (`multiviewX.py:18-194`): 6 cams, 400 frames, positionID ->
    (x=pos%1000, y=pos//1000); GK occupancy heatmaps.
  - Wildtrack (`wildtrack.py:19-205`): 7 cams, 2000 frames, positionID ->
    (x=pos%480, y=pos//480), cm units with (-300,-900) origin; swapped grid
    index order.

Fixed reference bugs (SURVEY.md §7 quirk table): `prepare_gt` referencing the
nonexistent `self.base` (`multiviewX.py:154`, `wildtrack.py:165`) uses `self`
here; Wildtrack's `reload_GK=True` default (which rebuilt the cache on every
run, `wildtrack.py:27`) defaults to False.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from vfa_tpu_torch.calib import camera_matrix, load_extrinsic, load_intrinsic
from vfa_tpu_torch.data.heatmaps import (
    HeatmapCache,
    rotated_gaussian_stamp,
    smooth_occupancy_maps,
)
from vfa_tpu_torch.utils import Obj2D, Obj3D

_MC_INTR = [f"intr_Camera{i}.xml" for i in range(1, 8)]
_MC_EXTR = [f"extr_Camera{i}.xml" for i in range(1, 8)]
_MX_INTR = [f"intr_Camera{i}.xml" for i in range(1, 7)]
_MX_EXTR = [f"extr_Camera{i}.xml" for i in range(1, 7)]
_WT_INTR = ["intr_CVLab1.xml", "intr_CVLab2.xml", "intr_CVLab3.xml",
            "intr_CVLab4.xml", "intr_IDIAP1.xml", "intr_IDIAP2.xml",
            "intr_IDIAP3.xml"]
_WT_EXTR = ["extr_CVLab1.xml", "extr_CVLab2.xml", "extr_CVLab3.xml",
            "extr_CVLab4.xml", "extr_IDIAP1.xml", "extr_IDIAP2.xml",
            "extr_IDIAP3.xml"]


class _BaseAdapter:
    """Common surface consumed by FrameDataset: intrinsic/extrinsic matrices,
    labels (per-frame object lists), heatmaps, image path lookup."""

    name: str
    num_cam: int
    num_frame: int
    label_names: List[str]

    def get_image_fpaths(self, frame_range):
        raise NotImplementedError

    @property
    def calibrations(self) -> np.ndarray:
        """(N, 3, 4) projection matrices K @ [R|t]."""
        return np.stack([
            camera_matrix(k, e)
            for k, e in zip(self.intrinsic_matrices, self.extrinsic_matrices)
        ])


class MultiviewC(_BaseAdapter):
    name = "MultiviewC"

    def __init__(
        self,
        root: str,
        heatmap_type: str = "RGK",
        ann_root: str = "annotations",
        img_root: str = "images",
        calib_root: str = "calibrations",
        world_size=(3900, 3900),
        cube_LWH=(25, 25, 32),
        cache_dir: Optional[str] = None,
        reload_cache: bool = False,
    ):
        assert heatmap_type in ("RGK", "GK")
        self.root = root
        self.heatmap_type = heatmap_type
        self.world_size = tuple(world_size)
        self.cube_LWH = tuple(cube_LWH)
        self.reduced_grid_size = [
            world_size[0] // cube_LWH[0], world_size[1] // cube_LWH[1]
        ]
        self.num_cam, self.num_frame = 7, 560
        self.label_names = ["Cow"]
        self.ann_root = os.path.join(root, ann_root)
        self.img_root = os.path.join(root, img_root)
        self.calib_root = os.path.join(root, calib_root)
        cache_dir = cache_dir or os.path.join(root, "cache")

        self.intrinsic_matrices = []
        self.extrinsic_matrices = []
        self.R_z = []
        for i in range(self.num_cam):
            k = load_intrinsic(os.path.join(self.calib_root, "intrinsic", _MC_INTR[i]))
            e, rz = load_extrinsic(os.path.join(self.calib_root, "extrinsic", _MC_EXTR[i]))
            self.intrinsic_matrices.append(k)
            self.extrinsic_matrices.append(e)
            self.R_z.append(rz)

        self.rgk_cache = HeatmapCache(os.path.join(cache_dir, "mc_RGK.npy"))
        self.gk_cache = HeatmapCache(os.path.join(cache_dir, "mc_GK.npy"))
        self.class_average_path = os.path.join(cache_dir, "ClsAvg.json")
        self.labels, self.heatmaps, self.dim_mean = self._load(reload_cache)

    def _load(self, reload_cache: bool):
        ann_paths = sorted(
            os.path.join(self.ann_root, p) for p in os.listdir(self.ann_root)
        )
        build = reload_cache or not (self.rgk_cache.exists() and self.gk_cache.exists())
        build_avg = reload_cache or not os.path.exists(self.class_average_path)

        labels = []
        dim_total, dim_count = np.zeros(3), 0
        for ann_path in ann_paths:
            with open(ann_path) as f:
                ann = json.load(f)
            objs = []
            rgk = np.zeros(self.reduced_grid_size, np.float32)
            occ = np.zeros(self.reduced_grid_size, np.float32)
            for cow in ann["C1"]:
                loc = cow["location"]
                dim = cow["dimension"]
                rot = np.deg2rad(cow["rotation"])
                objs.append(Obj3D("Cow", dimension=dim, location=loc,
                                  rotation=rot, conf=None))
                if build_avg:
                    dim_total += np.asarray(dim, np.float64)
                    dim_count += 1
                if build:
                    cx = loc[0] * self.reduced_grid_size[0] / self.world_size[0]
                    cy = loc[1] * self.reduced_grid_size[1] / self.world_size[1]
                    _, w, l = dim
                    rgk = rotated_gaussian_stamp(rgk, cx, cy, l, w, cow["rotation"])
                    occ[int(cy), int(cx)] = 1.0
            labels.append(objs)
            if build:
                self.rgk_cache.add(rgk)
                self.gk_cache.add(occ)

        if build_avg:
            os.makedirs(os.path.dirname(self.class_average_path), exist_ok=True)
            mean = (dim_total / max(dim_count, 1)).tolist()
            with open(self.class_average_path, "w") as f:
                json.dump({"cow": {"total": dim_total.tolist(),
                                   "count": dim_count, "mean": mean}}, f, indent=4)
        with open(self.class_average_path) as f:
            dim_mean = np.asarray(json.load(f)["cow"]["mean"], np.float32)

        if build:
            rgk_maps = self.rgk_cache.dump()
            occ = np.stack(self.gk_cache.items)
            gk_maps = self.gk_cache.dump(smooth_occupancy_maps(occ))
        else:
            rgk_maps = self.rgk_cache.load()
            gk_maps = self.gk_cache.load()
        maps = rgk_maps if self.heatmap_type == "RGK" else gk_maps
        return labels, maps, dim_mean

    def get_image_fpaths(self, frame_range):
        out = {cam: {} for cam in range(1, self.num_cam + 1)}
        for cam in range(1, self.num_cam + 1):
            folder = os.path.join(self.img_root, f"C{cam}")
            for fname in sorted(os.listdir(folder)):
                frame = int(fname.split(".")[0])
                if frame in frame_range:
                    out[cam][frame] = os.path.join(folder, fname)
        return out


class _PedestrianAdapter(_BaseAdapter):
    """Shared logic of MultiviewX / Wildtrack (positionID annotations)."""

    grid_reduce = 4

    def __init__(self, root: str, world_size, cube_LWH, cache_name: str,
                 cache_dir: Optional[str] = None, reload_cache: bool = False,
                 force_gt: bool = False):
        self.root = root
        self.world_size = tuple(world_size)
        self.cube_LWH = tuple(cube_LWH)
        self.reduced_grid_size = [s // self.grid_reduce for s in world_size]
        self.label_names = ["Person"]
        cache_dir = cache_dir or os.path.join(root, "cache")
        self.gk_cache = HeatmapCache(os.path.join(cache_dir, cache_name))
        self.dim_mean = None

        self.intrinsic_matrices, self.extrinsic_matrices = self._load_calibs()
        self.labels, self.heatmaps = self._load(reload_cache)

        self.gt_fpath = os.path.join(self.root, "gt.txt")
        if not os.path.exists(self.gt_fpath) or force_gt:
            self.prepare_gt()

    # dataset-specific
    def pos_to_grid(self, pos: int) -> Tuple[int, int]:
        raise NotImplementedError

    def _occupancy_index(self, x, y):
        """(row, col) of the occupancy stamp — Wildtrack swaps."""
        raise NotImplementedError

    def _load_calibs(self):
        raise NotImplementedError

    def _load(self, reload_cache: bool):
        ann_dir = os.path.join(self.root, "annotations_positions")
        build = reload_cache or not self.gk_cache.exists()
        labels = []
        for fname in sorted(os.listdir(ann_dir)):
            with open(os.path.join(ann_dir, fname)) as f:
                peds = json.load(f)
            objs = []
            occ = np.zeros(self.reduced_grid_size, np.float32)
            for ped in peds:
                x, y = self.pos_to_grid(ped["positionID"])
                objs.append(Obj2D("Person",
                                  location=np.array([x, y, 0], dtype=np.int64),
                                  conf=None))
                if build:
                    r, c = self._occupancy_index(x, y)
                    occ[int(r), int(c)] = 1.0
            labels.append(objs)
            if build:
                self.gk_cache.add(occ)
        if build:
            occ_all = np.stack(self.gk_cache.items)
            maps = self.gk_cache.dump(smooth_occupancy_maps(occ_all, self.grid_reduce))
        else:
            maps = self.gk_cache.load()
        return labels, maps

    def prepare_gt(self):
        """Write gt.txt rows `frame grid_x grid_y` for pedestrians visible in
        at least one camera (`multiviewX.py:138-158` with the self.base bug
        fixed)."""
        ann_dir = os.path.join(self.root, "annotations_positions")
        rows = []
        for fname in sorted(os.listdir(ann_dir)):
            frame = int(fname.split(".")[0])
            with open(os.path.join(ann_dir, fname)) as f:
                peds = json.load(f)
            for ped in peds:
                views = ped["views"]
                visible = any(
                    not (views[c]["xmin"] == -1 and views[c]["xmax"] == -1
                         and views[c]["ymin"] == -1 and views[c]["ymax"] == -1)
                    for c in range(self.num_cam)
                )
                if not visible:
                    continue
                gx, gy = self.pos_to_grid(ped["positionID"])
                rows.append([frame, gx, gy])
        os.makedirs(os.path.dirname(self.gt_fpath), exist_ok=True)
        np.savetxt(self.gt_fpath, np.asarray(rows), "%d")

    def get_image_fpaths(self, frame_range):
        out = {cam: {} for cam in range(1, self.num_cam + 1)}
        subsets = os.path.join(self.root, "Image_subsets")
        for camera_folder in sorted(os.listdir(subsets)):
            cam = int(camera_folder[-1])
            if cam >= self.num_cam + 1:
                continue
            for fname in sorted(os.listdir(os.path.join(subsets, camera_folder))):
                frame = int(fname.split(".")[0])
                if frame in frame_range:
                    out[cam][frame] = os.path.join(subsets, camera_folder, fname)
        return out


class MultiviewX(_PedestrianAdapter):
    name = "MultiviewX"

    def __init__(self, root: str, world_size=(640, 1000), cube_LWH=(4, 4, 8),
                 **kw):
        self.num_cam, self.num_frame = 6, 400
        super().__init__(root, world_size, cube_LWH, "mx_GK.npy", **kw)

    def pos_to_grid(self, pos: int):
        return pos % 1000, pos // 1000

    def _occupancy_index(self, x, y):
        return y / self.grid_reduce, x / self.grid_reduce

    def _load_calibs(self):
        intr, extr = [], []
        for i in range(self.num_cam):
            intr.append(load_intrinsic(
                os.path.join(self.root, "calibrations", "intrinsic", _MX_INTR[i])))
            e, _ = load_extrinsic(
                os.path.join(self.root, "calibrations", "extrinsic", _MX_EXTR[i]))
            extr.append(e)
        return intr, extr

    @staticmethod
    def get_worldcoord_from_worldgrid(worldgrid):
        grid_x, grid_y = worldgrid[:2]
        return np.array([grid_x / 40.0, grid_y / 40.0])


class Wildtrack(_PedestrianAdapter):
    name = "Wildtrack"

    def __init__(self, root: str, world_size=(480, 1440), cube_LWH=(4, 4, 4),
                 **kw):
        self.num_cam, self.num_frame = 7, 2000
        super().__init__(root, world_size, cube_LWH, "wt_GK.npy", **kw)

    def pos_to_grid(self, pos: int):
        return pos % 480, pos // 480

    def _occupancy_index(self, x, y):
        # Wildtrack stamps (x, y) in (row, col) order (`wildtrack.py:189-191`)
        return x / self.grid_reduce, y / self.grid_reduce

    def _load_calibs(self):
        intr, extr = [], []
        for i in range(self.num_cam):
            intr.append(load_intrinsic(
                os.path.join(self.root, "calibrations", "intrinsic_zero", _WT_INTR[i])))
            e, _ = load_extrinsic(
                os.path.join(self.root, "calibrations", "extrinsic", _WT_EXTR[i]))
            extr.append(e)
        return intr, extr

    @staticmethod
    def get_worldcoord_from_worldgrid(worldgrid):
        if len(worldgrid) == 2:
            gx, gy = worldgrid
            return np.array([-300 + 2.5 * gx, -900 + 2.5 * gy])
        gx, gy, gz = worldgrid
        return np.array([-300 + 2.5 * gx, -900 + 2.5 * gy, 2.5 * gz])


ADAPTERS = {"MultiviewC": MultiviewC, "MultiviewX": MultiviewX,
            "Wildtrack": Wildtrack}
