"""Native (C++) host components of the port, built with g++ at first use
and bound through ctypes (port of `vfa_tpu/native/__init__.py`).

`linear_sum_assignment(cost)` / `batch_linear_sum_assignment` — the
min-cost bipartite matching of the MODA matching step, from the repo's
`native/matching.cpp` (a Jonker-Volgenant solver, the counterpart of the
reference devkit's `MinCostMatching.cpp` mex). Where the library cannot be
built (no compiler) or `VFA_TPU_NATIVE_MATCHING=0`, scipy's
`linear_sum_assignment` solves the same problems with the same answers, as
in the JAX package; `matcher_backend()` names the one that runs, and the
CLIs print it.

The libraries go into the git-ignored `vfa_tpu_torch/_build/` (beside the
CUDA kernels' libraries), never at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def build_shared(src: Path, name: str, libs=()) -> Path | None:
    """Compile `src` into BUILD_DIR/`name` with g++ (or $CXX) unless a
    library newer than the source is there; None (with the compiler's
    complaint on stderr) when it cannot be built. The library is written
    under a temporary name and renamed, so processes that build it at the
    same time never load a half-written file."""
    if not src.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / name
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    tmp = BUILD_DIR / f".{name}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC",
           "-std=c++17", str(src), "-o", str(tmp), *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        print(f"vfa_tpu_torch.native: building {name} failed:\n"
              f"{e.stderr.strip()[-600:]}", file=sys.stderr)
        return None
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"vfa_tpu_torch.native: building {name} failed ({e})",
              file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def load_shared(path: Path):
    """ctypes.CDLL of `path`, or None (saying why on stderr) when it does
    not load, e.g. a library built on another machine whose libjpeg is
    missing here."""
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        print(f"vfa_tpu_torch.native: cannot load {path.name} ({e})",
              file=sys.stderr)
        return None


def _get_lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = build_shared(SRC_DIR / "matching.cpp", "libvfa_matching.so")
        if path is None:
            _LIB_FAILED = True
            return None
        lib = load_shared(path)
        if lib is None:
            _LIB_FAILED = True
            return None
        lib.solve_lsap.restype = ctypes.c_int
        lib.solve_lsap.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.solve_lsap_batch.restype = ctypes.c_int
        lib.solve_lsap_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    return _LIB


def _native_lib():
    """The matching library when it is wanted and available, else None."""
    if os.environ.get("VFA_TPU_NATIVE_MATCHING", "1") == "0":
        return None
    return _get_lib()


def native_available() -> bool:
    return _get_lib() is not None


def matcher_backend() -> str:
    """The matcher that `linear_sum_assignment` and
    `batch_linear_sum_assignment` run."""
    if _native_lib() is not None:
        return "native (native/matching.cpp, Jonker-Volgenant)"
    return "scipy.optimize.linear_sum_assignment"


def linear_sum_assignment(cost: np.ndarray):
    """Optimal assignment of an (n, m) cost matrix.

    Returns (row_indices, col_indices) of the min(n, m) assigned pairs, like
    scipy.optimize.linear_sum_assignment (rows sorted ascending).
    """
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    lib = _native_lib()
    if lib is None:
        from scipy.optimize import linear_sum_assignment as scipy_lsa

        return scipy_lsa(cost)

    row_to_col = np.full(n, -1, np.int32)
    rc = lib.solve_lsap(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(n), np.int32(m),
        row_to_col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"native solve_lsap failed with code {rc}")
    rows = np.nonzero(row_to_col >= 0)[0]
    return rows.astype(np.int64), row_to_col[rows].astype(np.int64)


def batch_linear_sum_assignment(costs: np.ndarray, ns: np.ndarray,
                                ms: np.ndarray) -> np.ndarray:
    """Solve a batch of padded assignment problems in one native call.

    costs: (B, pad_n, pad_m); problem b is its top-left ns[b] x ms[b]
    submatrix (padding never read). Returns row_to_col (B, pad_n) int32
    with -1 for unassigned/padded rows — the batched form the vectorized
    CLEAR-metrics path (eval/moda.py) consumes. scipy solves the problems
    one by one where the native library is unavailable.
    """
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    B, pad_n, pad_m = costs.shape
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    ms = np.ascontiguousarray(ms, dtype=np.int32)
    out = np.full((B, pad_n), -1, np.int32)
    if B == 0:
        return out

    lib = _native_lib()
    if lib is not None:
        rc = lib.solve_lsap_batch(
            costs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(B), np.int32(pad_n), np.int32(pad_m),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"native solve_lsap_batch failed with code {rc}")
        return out

    from scipy.optimize import linear_sum_assignment as scipy_lsa

    for b in range(B):
        if ns[b] <= 0 or ms[b] <= 0:
            continue
        r, c = scipy_lsa(costs[b, :ns[b], :ms[b]])
        out[b, r] = c
    return out
