"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface (shared device code is in
`csrc/*.cuh`). It is compiled with nvcc for Hopper (`sm_90a`) into
`_build/lib<name>.so` at first use and bound with ctypes; nothing is built
when this module is imported. A failed build or a missing nvcc raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# libcuda, for the TMA tensor maps (cuTensorMapEncodeTiled)
NVCC_LIBS = ["-lcuda"]

P, I = ctypes.c_void_p, ctypes.c_int
LL, D = ctypes.c_longlong, ctypes.c_double
# argtypes per exported C function: pointers and the stream as c_void_p
SIGNATURES = {
    "rig_window_fwd": {
        "rig_window_fwd_f32": [P] * 6 + [I] * 13 + [P],
        # per-bucket host arrays (A, starts, T, K, ww, off_t), nb, Kr, vox, out
        "rig_window_fwd_bf16": [P] * 7 + [I] + [P] * 3 + [I] * 9 + [P],
    },
    "rig_window_bwd": {
        "rig_window_bwd_f32": [P] * 9 + [I] * 13 + [P],
        # + the dII scratch and order index (pixels, ptr, adds), n_pixels, serial
        "rig_window_bwd_bf16": [P] * 13 + [I] * 15 + [P],
    },
    "rig_flat_fwd": {
        "rig_flat_fwd_f32": [P] * 6 + [I] * 11 + [P],
        # per-bucket host arrays (A, starts, T, K, off_t), nb, Kr, vox, out
        "rig_flat_fwd_bf16": [P] * 6 + [I] + [P] * 3 + [I] * 8 + [P],
    },
    "rig_flat_bwd": {
        "rig_flat_bwd_f32": [P] * 9 + [I] * 11 + [P],
        # + the dII scratch and order index (pixels, ptr, adds), n_pixels
        "rig_flat_bwd_bf16": [P] * 13 + [I] * 12 + [P],
    },
    "stem_bwd": {
        # + the scratch's items per plane
        "stem_bwd_stats_f32": [P] * 5 + [I] * 5 + [P],
        "stem_bwd_dx_f32": [P] * 4 + [I] * 4 + [P],
        "stem_bwd_stats_bf16": [P] * 5 + [I] * 5 + [P],
        "stem_bwd_dx_bf16": [P] * 4 + [I] * 4 + [P],
    },
    "rig_bev_epilogue": {
        # per-scale host arrays (tiles, inv_perm, bias, rows), S, out, N, B, V2d
        "rig_bev_epilogue_bf16": [P] * 4 + [I] + [P] + [I] * 3 + [P],
    },
    "mvdet_project": {
        # feats, positions, out; feats' strides (b, n, h, w); B, N, C, h8, w8,
        # h, w, L, W, K; 2 / (w - 1), 2 / (h - 1)
        "mvdet_project_bf16": [P] * 3 + [LL] * 4 + [I] * 10 + [D] * 2 + [P],
    },
    "voxel_tap_bwd": {
        # g, the order index (ptr, rows, w), out; B, H * W, C
        "voxel_tap_bwd_f32": [P] * 5 + [I] * 3 + [P],
        "voxel_tap_bwd_bf16": [P] * 5 + [I] * 3 + [P],
    },
}


class KernelLibrary:
    """Builds kernels on demand from the sources in `csrc` and holds the
    loaded libraries."""

    def __init__(self, build_dir: str = BUILD, csrc: str = CSRC):
        self.build_dir = build_dir
        self.csrc = csrc
        self.ptxas_log: Dict[str, str] = {}
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    @staticmethod
    def nvcc() -> str:
        path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(path):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        return path

    def _paths(self, name: str):
        return (os.path.join(self.csrc, f"{name}.cu"),
                os.path.join(self.build_dir, f"lib{name}.so"))

    def _stale(self, name: str) -> bool:
        src, so = self._paths(name)
        deps = [src, *glob.glob(os.path.join(self.csrc, "*.cuh"))]
        return (not os.path.exists(so)
                or os.path.getmtime(so) < max(map(os.path.getmtime, deps)))

    def build(self, names: List[str]) -> None:
        """Compile the named sources that are out of date, one nvcc process
        per source, all started together."""
        todo = [n for n in names if self._stale(n)]
        if not todo:
            return
        os.makedirs(self.build_dir, exist_ok=True)
        nvcc = self.nvcc()
        procs = {}
        for name in todo:
            src, so = self._paths(name)
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src, *NVCC_LIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            self.ptxas_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))

    def load(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                self.build([name])
                lib = ctypes.CDLL(self._paths(name)[1])
                for fn, argtypes in SIGNATURES[name].items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                self._libs[name] = lib
            return lib


LIBRARY = KernelLibrary()


class LaunchCount:
    """The launch count of a kernel variant that has no wrapper of its own
    (the bf16 variants launch through the fp32 kernels' wrappers)."""

    def __init__(self):
        self.launches = 0


def launch(name: str, fn: str, device, *args) -> None:
    """Call the C entry point `fn` of kernel library `name` (built and
    loaded at first use) on `device` and PyTorch's current stream, which is
    passed as the last argument; raise if the launch was refused."""
    import torch

    lib = LIBRARY.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}.{fn} launch failed with cudaError_t {err}")


def launch_counts() -> Dict[str, int]:
    """name -> launches so far in this process, of every kernel variant of
    the port (each wrapper counts where it launches its kernel)."""
    from vfa_tpu_torch.ops import projection, rig_cuda, stem, voxel

    names = ("rig_window_fwd", "rig_window_bwd", "rig_flat_fwd", "rig_flat_bwd",
             "rig_window_fwd_bf16", "rig_flat_fwd_bf16", "rig_window_bwd_bf16",
             "rig_flat_bwd_bf16", "rig_bev_epilogue")
    out = {n: getattr(rig_cuda, n).launches for n in names}
    for n in ("stem_bwd_stats", "stem_bwd_dx", "stem_bwd_stats_bf16", "stem_bwd_dx_bf16"):
        out[n] = getattr(stem, n).launches
    for n in ("voxel_tap_bwd", "voxel_tap_bwd_bf16"):
        out[n] = getattr(voxel, n).launches
    out["mvdet_project"] = projection.project_world.launches
    return out
