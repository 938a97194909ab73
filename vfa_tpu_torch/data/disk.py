"""On-disk frame sets written from seeds.

`write_multiviewc(root, cfg, ...)` writes a dataset in MultiviewC's layout
that `data.adapters.MultiviewC` reads: OpenCV-XML intrinsics and
extrinsics (`calibrations/{intrinsic,extrinsic}/`) of the port's synthetic
ring of cameras (`data.synthetic.make_camera_params`), one annotation JSON
a frame (`annotations/`, seeded synthetic cows) and one PNG a camera and
frame (`images/C<cam>/<frame>.png`) at the configuration's resize size, so
the loader reads the written pixels back exactly. The CPU tests write it at
the tiny configuration; `chip_smoke.py` writes it at full width.

`ensure_dataset` / `DiskFrames` are the bench's bare JPEG frame tree (the
port's copy of `tools/bench_loader.py:39-104`): `python -m
vfa_tpu_torch.bench --from_disk` decodes it through the SceneLoader.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import sys
import time

import numpy as np

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.data.frame_dataset import FrameDataset


def write_opencv_xml(path: str, nodes: dict) -> None:
    """An OpenCV FileStorage-style XML of matrix and scalar nodes, every
    number at full float64 precision."""
    lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, val in nodes.items():
        val = np.atleast_2d(np.asarray(val, np.float64))
        if val.size == 1:
            lines.append(f"<{name}>{val.item()!r}</{name}>")
        else:
            data = " ".join(repr(float(x)) for x in val.ravel())
            lines.append(
                f'<{name} type_id="opencv-matrix"><rows>{val.shape[0]}</rows>'
                f"<cols>{val.shape[1]}</cols><dt>d</dt>"
                f"<data>{data}</data></{name}>")
    lines.append("</opencv_storage>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def make_frame(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 with photographic statistics: low-frequency
    background, textured blobs and sensor noise, so decode cost tracks a
    real frame's (`tools/bench_loader.py::make_frame`)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        120 + 60 * np.sin(yy / 97.0) + 40 * np.cos(xx / 131.0),
        110 + 50 * np.cos(yy / 71.0 + 1.0) + 45 * np.sin(xx / 89.0),
        100 + 55 * np.sin((xx + yy) / 113.0),
    ], axis=-1)
    for _ in range(24):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        rh, rw = rng.integers(20, 90), rng.integers(15, 60)
        y0, y1 = max(0, cy - rh), min(h, cy + rh)
        x0, x1 = max(0, cx - rw), min(w, cx + rw)
        img[y0:y1, x0:x1] += rng.normal(0, 28, (y1 - y0, x1 - x0, 3))
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_multiviewc_calibrations(root: str, cfg: DatasetConfig) -> None:
    """The 7 cameras' XMLs under `root/calibrations`: K as `camera_matrix`,
    [R|t] as `rvec` (R's rotation vector) and `tvec`, and `R_z` 0."""
    from scipy.spatial.transform import Rotation

    from vfa_tpu_torch.data.adapters import _MC_EXTR, _MC_INTR
    from vfa_tpu_torch.data.synthetic import make_camera_params

    intr = os.path.join(root, "calibrations", "intrinsic")
    extr = os.path.join(root, "calibrations", "extrinsic")
    os.makedirs(intr, exist_ok=True)
    os.makedirs(extr, exist_ok=True)
    for i, (K, Rt) in enumerate(make_camera_params(cfg, 7)):
        write_opencv_xml(os.path.join(intr, _MC_INTR[i]), {"camera_matrix": K})
        rvec = Rotation.from_matrix(Rt[:, :3]).as_rotvec()
        write_opencv_xml(os.path.join(extr, _MC_EXTR[i]), {
            "rvec": rvec[None], "tvec": Rt[:, 3][None], "R_z": 0.0})


def write_multiviewc(root: str, cfg: DatasetConfig, num_frames: int,
                     seed: int = 0, num_objects: int = 6, border: float = 0.1,
                     keep_frames=None) -> dict:
    """Write a MultiviewC-format dataset of `num_frames` frames x 7 cameras
    at `cfg.resize_size` under `root` (calibrations, annotations, PNGs;
    frame f's objects and pixels come from seed `seed * 10_000 + f`).
    Objects lie at least `border` of the world's size from its edges: the
    adapter's rotated-gaussian stamp (as the reference's) needs half its
    kernel, 12 cells for a cow, between an object and the BEV border, so a
    tiny configuration's 9x9 grid takes 0.35.
    Returns {(cam, frame): (h, w, 3) uint8} of the written pixels of
    `keep_frames` (default: every frame when the frames are small, as in
    the tiny configuration, else none)."""
    from PIL import Image

    write_multiviewc_calibrations(root, cfg)
    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    for cam in range(1, 8):
        os.makedirs(os.path.join(root, "images", f"C{cam}"), exist_ok=True)
    h, w = cfg.resize_size
    if keep_frames is None:
        keep_frames = range(num_frames) if h * w <= 256 * 256 else ()
    keep_frames = set(keep_frames)

    def frame_job(f):
        rng = np.random.default_rng(seed * 10_000 + f)
        ws = np.asarray(cfg.world_size, np.float64)
        cows = []
        for _ in range(num_objects):
            xy = rng.uniform(border, 1.0 - border, size=2) * ws
            dim = rng.uniform([120, 100, 220], [170, 140, 290])
            cows.append({"location": [float(xy[0]), float(xy[1]), 0.0],
                         "dimension": [float(x) for x in dim],
                         "rotation": float(rng.uniform(-180.0, 180.0))})
        with open(os.path.join(ann, f"{f:04d}.json"), "w") as fp:
            json.dump({"C1": cows}, fp)
        out = {}
        for cam in range(1, 8):
            px = make_frame(rng, h, w)
            Image.fromarray(px).save(
                os.path.join(root, "images", f"C{cam}", f"{f:04d}.png"),
                compress_level=1)
            if f in keep_frames:
                out[(cam, f)] = px
        return out

    pixels = {}
    with cf.ThreadPoolExecutor(8) as pool:
        for out in pool.map(frame_job, range(num_frames)):
            pixels.update(out)
    return pixels


def ensure_dataset(root: str, frames: int, cams: int, size, quality: int):
    """cam{c}/{f:05d}.jpg tree of `make_frame` images at `size` (h, w),
    written once (on 8 threads, each image from its own seed); returns
    fpaths {cam: {frame: path}}."""
    from PIL import Image

    h, w = size
    fpaths = {}
    todo = []
    for cam in range(1, cams + 1):
        d = os.path.join(root, f"cam{cam}")
        os.makedirs(d, exist_ok=True)
        fpaths[cam] = {}
        for f in range(frames):
            p = os.path.join(d, f"{f:05d}.jpg")
            fpaths[cam][f] = p
            if not os.path.isfile(p):
                todo.append((cam, f, p))
    if todo:
        t0 = time.perf_counter()

        def write(job):
            cam, f, p = job
            rng = np.random.default_rng(cam * 100003 + f)
            Image.fromarray(make_frame(rng, h, w)).save(p, quality=quality)

        with cf.ThreadPoolExecutor(8) as pool:
            list(pool.map(write, todo))
        print(f"# wrote {len(todo)} jpegs ({time.perf_counter() - t0:.0f}s, "
              f"{os.path.getsize(todo[-1][2]) / 1e3:.0f} KB each)", file=sys.stderr)
    return fpaths


class DiskFrames(FrameDataset):
    """FrameDataset over a bare on-disk JPEG tree (no annotations): empty
    labels / zero heatmaps, real image decode path. Duck-type compatible
    with SceneLoader."""

    def __init__(self, cfg, fpaths, num_frames: int, backend: str):
        self.cfg = cfg
        self.image_backend = backend
        self.num_cam = len(fpaths)
        self.frame_range = range(num_frames)
        self.fpaths = fpaths
        self.labels = [[] for _ in range(num_frames)]
        L, W = cfg.grid_shape
        self.heatmaps = [np.zeros((L, W), np.float32)] * num_frames
        self.calibs = np.zeros((self.num_cam, 3, 4), np.float32)
        self.grid = np.zeros((L, W, 3), np.float32)
        self.dim_mean = None
