"""Calibration parsing: OpenCV-FileStorage XML -> K, [R|t] (host-side numpy;
port of `vfa_tpu/calib.py`).

Reference: `vfa/data/multiviewC.py:90-110`, `multiviewX.py:99-118`,
`wildtrack.py:108-129` — intrinsics from `camera_matrix`, extrinsics from
Rodrigues(rvec) hstacked with tvec. Implemented with xml.etree + our own
Rodrigues (`vfa_tpu_torch.geometry.rodrigues`), so there is no OpenCV
dependency.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from vfa_tpu_torch.geometry import rodrigues


def read_opencv_node(path: str, node: str) -> np.ndarray:
    """Read a matrix or scalar node from an OpenCV FileStorage XML file."""
    root = ET.parse(path).getroot()
    el = root.find(node)
    if el is None:
        raise KeyError(f"node {node!r} not found in {path}")
    data = el.find("data")
    if data is None:
        # scalar node (e.g. R_z) or whitespace-separated vector text
        vals = [float(x) for x in el.text.split()]
        return np.array(vals[0] if len(vals) == 1 else vals)
    rows = int(el.find("rows").text)
    cols = int(el.find("cols").text)
    vals = np.array([float(x) for x in data.text.split()])
    return vals.reshape(rows, cols)


def load_intrinsic(path: str) -> np.ndarray:
    return read_opencv_node(path, "camera_matrix").astype(np.float64)


def load_extrinsic(path: str):
    """Returns (3, 4) [R|t] from rvec/tvec nodes (plus R_z if present)."""
    rvec = np.asarray(read_opencv_node(path, "rvec")).reshape(-1)
    tvec = np.asarray(read_opencv_node(path, "tvec")).reshape(-1)
    R = rodrigues(rvec)
    ext = np.hstack([R, tvec.reshape(3, 1)]).astype(np.float64)
    try:
        r_z = float(read_opencv_node(path, "R_z"))
    except KeyError:
        r_z = None
    return ext, r_z


def camera_matrix(intrinsic: np.ndarray, extrinsic: np.ndarray) -> np.ndarray:
    """K @ [R|t] -> (3, 4) projection matrix (`vfa/data/dataset.py:64`)."""
    return (np.asarray(intrinsic) @ np.asarray(extrinsic)).astype(np.float32)
