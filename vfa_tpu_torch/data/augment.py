"""Train-time image augmentation: ColorJitter with torchvision semantics
(port of `vfa_tpu/data/augment.py`).

The reference trains with
``ColorJitter(brightness=0.2, contrast=0.2, hue=0.2)`` applied per camera
image on the train split only (the reference's `train.py:209-214`,
`vfa/data/dataset.py:63`). This module reproduces torchvision's float-tensor
functional semantics in numpy (host-side, inside the data loader threads)
and in torch on the device (`device_color_jitter`, for uint8-staged
batches):

  * brightness: ``clip(img * f)`` with f ~ U[1-b, 1+b]
  * contrast:   ``clip(f * img + (1-f) * mean(grayscale(img)))`` with the
    ITU-R 601 luma weights (0.2989, 0.587, 0.114), f ~ U[1-c, 1+c]
  * hue:        RGB->HSV, h := (h + f) mod 1, HSV->RGB, f ~ U[-h, h]
  * the enabled ops are applied in a random order per image, like
    ``ColorJitter.forward``'s ``randperm``.

The numpy ops are the JAX package's, held to it exactly, and the device
ops to its `device_color_jitter` (tests/test_torch_augment.py).
Saturation is not jittered — the reference doesn't set it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_LUMA = np.array([0.2989, 0.587, 0.114], np.float32)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """img: (..., 3) float in [0,1]."""
    return np.clip(img * np.float32(factor), 0.0, 1.0)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = np.float32((img[..., :3] @ _LUMA).mean())
    return np.clip(np.float32(factor) * img + np.float32(1 - factor) * mean,
                   0.0, 1.0)


def _rgb_to_hsv(img: np.ndarray):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.max(img, axis=-1)
    minc = np.min(img, axis=-1)
    cr = maxc - minc
    eq = cr == 0
    s = np.where(eq, 0.0, cr / np.where(maxc == 0, 1.0, maxc))
    crd = np.where(eq, 1.0, cr)
    rc = (maxc - r) / crd
    gc = (maxc - g) / crd
    bc = (maxc - b) / crd
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(eq, 0.0, h)
    h = (h / 6.0) % 1.0
    return h, s, maxc


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # per-sector (r, g, b) selection
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ])
    return np.take_along_axis(
        choices, i[None, ..., None].repeat(3, -1), axis=0)[0]


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    h, s, v = _rgb_to_hsv(img.astype(np.float32))
    h = (h + np.float32(factor)) % 1.0
    return _hsv_to_rgb(h, s, v).astype(img.dtype)


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.2,
    contrast: float = 0.2,
    hue: float = 0.2,
) -> np.ndarray:
    """One image, factors sampled and ops applied in random order like
    ``ColorJitter.get_params`` + ``forward``."""
    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x, f=f: adjust_brightness(x, f))
    if contrast:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x, f=f: adjust_contrast(x, f))
    if hue:
        f = rng.uniform(-hue, hue)
        ops.append(lambda x, f=f: adjust_hue(x, f))
    for k in rng.permutation(len(ops)):
        img = ops[k](img)
    return img


# ---------------------------------------------------------------- device --
# On-device ColorJitter: the same torchvision float-tensor semantics as the
# numpy ops above, written in torch so the jitter runs on the card over the
# uint8-staged batch instead of on host loader threads. Factors and op
# order are sampled on the host per image (`sample_jitter_params`) and
# passed in, so the device op draws nothing. Plain elementwise torch: it
# follows `vfa_tpu/data/augment.py:139-218` op for op, and
# tests/test_torch_augment.py holds it to that function.

_PERMS3: Tuple[Tuple[int, int, int], ...] = (
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def sample_jitter_params(rng: np.random.Generator, n: int,
                         brightness: float = 0.2, contrast: float = 0.2,
                         hue: float = 0.2):
    """Host-side per-image jitter parameters for `device_color_jitter`.

    Returns (factors (n, 3) float32 [brightness, contrast, hue], order (n,)
    int32 index into `_PERMS3`) — the vectorized analog of
    ``ColorJitter.get_params``'s uniform draws + ``randperm``; the same
    draws from the same generator as the JAX package."""
    factors = np.stack([
        rng.uniform(max(0.0, 1 - brightness), 1 + brightness, n),
        rng.uniform(max(0.0, 1 - contrast), 1 + contrast, n),
        rng.uniform(-hue, hue, n),
    ], axis=-1).astype(np.float32)
    order = rng.integers(0, len(_PERMS3), size=n).astype(np.int32)
    return factors, order


def _per_image(f, img):
    """(k,) factors as (k, 1, 1, 1) to scale (k, H, W, 3) images."""
    return f.reshape(-1, *([1] * (img.dim() - 1)))


def _dev_brightness(img, f):
    return torch.clamp(img * _per_image(f, img), 0.0, 1.0)


def _dev_contrast(img, f):
    luma = torch.as_tensor(_LUMA, dtype=img.dtype, device=img.device)
    mean = torch.mean(img[..., :3] @ luma, dim=(1, 2))
    f = _per_image(f, img)
    return torch.clamp(f * img + (1 - f) * _per_image(mean, img), 0.0, 1.0)


def _dev_hue(img, f):
    # mirror _rgb_to_hsv / _hsv_to_rgb op for op
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.amax(img, dim=-1)
    minc = torch.amin(img, dim=-1)
    cr = maxc - minc
    eq = cr == 0
    one = torch.ones_like(maxc)
    s = torch.where(eq, torch.zeros_like(maxc),
                    cr / torch.where(maxc == 0, one, maxc))
    crd = torch.where(eq, one, cr)
    rc = (maxc - r) / crd
    gc = (maxc - g) / crd
    bc = (maxc - b) / crd
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(eq, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)

    h = torch.remainder(h + f.reshape(-1, 1, 1), 1.0)
    i = torch.floor(h * 6.0)
    fr = h * 6.0 - i
    i = torch.remainder(i.to(torch.int32), 6)
    v = maxc
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))

    # per-sector (r, g, b) through elementwise select cascades, not a
    # stacked 6-way gather (which would hold 6x the image at once)
    def sector(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return torch.stack([sector(v, q, p, p, t, v), sector(t, v, v, q, p, p),
                        sector(p, p, t, v, v, q)], -1)


def device_color_jitter(images: torch.Tensor, factors, order) -> torch.Tensor:
    """Vectorized ColorJitter on the images' device.

    images (n, H, W, 3) float in [0, 1]; factors (n, 3) [brightness,
    contrast, hue] (array or tensor); order (n,) int index into `_PERMS3`,
    on the host (numpy or a CPU tensor). Each image gets its three ops in
    its permutation's order: for each of the three positions, the images
    whose op there is the same run it as one batch, so a call launches a
    fixed number of elementwise passes whatever n is. Reading `order` on
    the host, and copying the factors and the image indices without
    waiting, is what keeps the host from waiting for the device."""
    if isinstance(order, torch.Tensor):
        if order.device.type != "cpu":
            raise ValueError("order must be on the host (numpy or a CPU tensor)")
        order = order.numpy()
    perms = np.asarray(_PERMS3, np.int64)[np.asarray(order, np.int64)]
    # small host arrays go to the card without waiting for its queued work
    factors = torch.as_tensor(np.asarray(factors, np.float32) if not isinstance(
        factors, torch.Tensor) else factors).to(images.device, torch.float32,
                                                non_blocking=True)
    ops = (_dev_brightness, _dev_contrast, _dev_hue)
    out = images
    n = images.shape[0]
    for pos in range(3):
        for j in range(3):
            idx = np.nonzero(perms[:, pos] == j)[0]
            if len(idx) == n:
                out = ops[j](out, factors[:, j])
            elif len(idx):
                sel = torch.as_tensor(idx).to(images.device, non_blocking=True)
                if out is images:
                    out = images.clone()
                out[sel] = ops[j](out[sel], factors[sel, j])
    return out


class ColorJitterAugment:
    """Scene-level augment hook for the loaders: jitters each camera image
    independently (the reference's per-image transform)."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2,
                 hue: float = 0.2):
        self.brightness = brightness
        self.contrast = contrast
        self.hue = hue

    def __call__(self, images: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        # images: (num_cam, H, W, 3) float32 [0,1]
        return np.stack([
            color_jitter(images[c], rng, self.brightness, self.contrast,
                         self.hue)
            for c in range(images.shape[0])
        ]).astype(images.dtype)
