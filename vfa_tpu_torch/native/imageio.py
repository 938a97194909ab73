"""ctypes binding of the repo's native image loader, `native/imageio.cpp`
(port of `vfa_tpu/native/imageio.py`).

`load_image(path, (h, w))` returns float32 RGB HWC in [0, 1] (or uint8 into
a uint8 `out`). The C call decodes with libjpeg / libpng and releases the
GIL, so the SceneLoader's threads decode camera frames on real cores. The
library needs libjpeg's and libpng's headers to build; where it cannot be
built, `load_image` decodes with PIL, as the JAX package does.
`decoder_backend(backend)` names the decoder that runs, and the CLIs and
the bench print it.

Numerics: the native resize is plain bilinear; PIL's BILINEAR is an
antialiased triangle filter when it downscales, so resized pixels differ
slightly. Without a resize (the image already at the target size) both
give the file's pixels. The loaders default to PIL for reference-pipeline
parity; pass `backend='native'` (or VFA_TPU_IMAGE_BACKEND=native) for
throughput.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from vfa_tpu_torch.native import SRC_DIR, build_shared, load_shared

_LOCK = threading.Lock()
_LIB = None
_FAILED = False


def _get_lib():
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        path = build_shared(SRC_DIR / "imageio.cpp", "libvfa_imageio.so",
                            libs=("-ljpeg", "-lpng"))
        if path is None:
            _FAILED = True
            return None
        lib = load_shared(path)
        if lib is None:
            _FAILED = True
            return None
        lib.load_image_resized.restype = ctypes.c_int
        lib.load_image_resized.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.load_image_resized_u8.restype = ctypes.c_int
        lib.load_image_resized_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def resolve_backend(backend: str = "auto") -> str:
    """'native' or 'pil': the decoder `load_image(..., backend)` runs.
    'auto' reads VFA_TPU_IMAGE_BACKEND (default pil); 'native' without the
    library decodes with PIL."""
    if backend == "auto":
        backend = os.environ.get("VFA_TPU_IMAGE_BACKEND", "pil")
    if backend not in ("native", "pil"):
        raise ValueError(f"image backend must be auto, native or pil, got {backend!r}")
    if backend == "native" and not native_available():
        return "pil"
    return backend


def decoder_backend(backend: str = "auto") -> str:
    """A printable name of the decoder that `backend` resolves to."""
    if resolve_backend(backend) == "native":
        return "native (native/imageio.cpp, libjpeg/libpng)"
    asked = "" if backend in ("auto", "pil") else f"; {backend} asked, library unavailable"
    return f"PIL{asked}"


def load_image_native(path: str, size_hw, out=None) -> np.ndarray:
    """(h, w, 3) float32 in [0,1] (or uint8 [0,255] when `out` is uint8),
    or raises on decode failure. `out`: an optional preallocated
    C-contiguous (h, w, 3) slot the decoder writes into directly."""
    h, w = int(size_hw[0]), int(size_hw[1])
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native imageio unavailable")
    if out is None:
        out = np.empty((h, w, 3), np.float32)
    assert out.flags.c_contiguous and out.shape == (h, w, 3)
    if out.dtype == np.uint8:
        rc = lib.load_image_resized_u8(
            path.encode(), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    else:
        assert out.dtype == np.float32
        rc = lib.load_image_resized(
            path.encode(), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"load_image_resized({path}) failed with code {rc}")
    return out


def load_image_pil(path: str, size_hw, out=None) -> np.ndarray:
    from PIL import Image

    h, w = int(size_hw[0]), int(size_hw[1])
    img = Image.open(path).convert("RGB")
    if img.size != (w, h):
        img = img.resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, np.uint8)
    if out is None:
        return arr.astype(np.float32) / 255.0
    if out.dtype == np.uint8:  # PIL's resize output is uint8: plain copy
        out[...] = arr
    else:
        np.multiply(arr, np.float32(1 / 255.0), out=out)
    return out


def load_image(path: str, size_hw, backend: str = "auto", out=None) -> np.ndarray:
    """backend: 'pil' (reference parity), 'native' (fast), or 'auto'
    (VFA_TPU_IMAGE_BACKEND env, default pil)."""
    if resolve_backend(backend) == "native":
        return load_image_native(path, size_hw, out=out)
    return load_image_pil(path, size_hw, out=out)
