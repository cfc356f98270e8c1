"""DreamBooth instance images: read, resized, cropped, recorded.

Counterpart of the JAX package's ``data/dreambooth.py``: the subject's
images are resized so the short side is the train resolution, cropped to a
square (center, or random as torchvision's RandomCrop), optionally flipped
first, and kept as float32 pixels in [-1, 1] with each view's SDXL
micro-conditioning records (original size, crop top-left).

The port reads PNG files with its own reader (``utils/png.py``) and
resizes with its own copy of PIL's ``Image.BICUBIC`` resampler, the one the
JAX package calls: separable, horizontal pass first; a cubic with
a = -0.5 whose support widens by the downscale factor; per output pixel the
coefficients normalized to sum 1 and rounded to 22-bit fixed point; after
each pass the sum rounded and clipped to uint8. JPEG, WebP and BMP files
are refused (the port has no decoder for them yet).
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np

from ..utils.png import read_png

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
_UNREAD_EXTS = (".jpg", ".jpeg", ".webp", ".bmp")
_PRECISION_BITS = 22  # PIL's fixed-point coefficients for 8-bit images


def image_files(directory: str) -> List[str]:
    """The image files of ``directory`` in name order. Raises
    ``NotImplementedError`` naming the first JPEG, WebP or BMP file: the
    port reads PNG only."""
    names = sorted(f for f in os.listdir(directory) if f.lower().endswith(IMAGE_EXTS))
    unread = [f for f in names if f.lower().endswith(_UNREAD_EXTS)]
    if unread:
        raise NotImplementedError(
            f"{os.path.join(directory, unread[0])}: the port reads PNG images only; JPEG, WebP "
            "and BMP wait for the port's own decoder (ROADMAP Queue 1 item 11). Convert the "
            "images to PNG.")
    return [os.path.join(directory, f) for f in names]


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` ->
    (first source index (out,), fixed-point taps (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # summed tap by tap, as PIL sums them
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_rows(arr: np.ndarray, out_size: int) -> np.ndarray:
    """One pass along axis 1 of (H, W, C) uint8 -> (H, out_size, C) uint8."""
    in_size = arr.shape[1]
    if in_size == out_size:
        return arr
    xmin, k = _coefficients(in_size, out_size)
    src = arr.astype(np.int64)
    acc = np.full((arr.shape[0], out_size, arr.shape[2]), 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)  # taps past the edge are 0
        acc += src[:, idx] * k[None, :, t, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (height, width, 3) uint8, PIL's
    ``Image.resize((width, height), Image.BICUBIC)``."""
    out = _resample_rows(arr, width)
    return _resample_rows(out.transpose(1, 0, 2), height).transpose(1, 0, 2)


def resize_crop(arr: np.ndarray, size: int, rng=None
                ) -> Tuple[np.ndarray, Tuple[int, int], Tuple[int, int]]:
    """-> (size x size x 3 uint8, original (h, w), crop (top, left)): the
    short side resized to ``size`` (the long side to ``round(long * scale)``,
    Python's ``round``), then a center crop (``rng=None``) or a random one
    (``rng.integers`` for the top, then the left)."""
    h0, w0 = arr.shape[:2]
    scale = size / min(h0, w0)
    nh, nw = round(h0 * scale), round(w0 * scale)
    img = resize_bicubic(arr, nh, nw) if (nh, nw) != (h0, w0) else arr
    if rng is None:
        top, left = (nh - size) // 2, (nw - size) // 2
    else:
        top = int(rng.integers(0, nh - size + 1))
        left = int(rng.integers(0, nw - size + 1))
    return img[top:top + size, left:left + size], (h0, w0), (top, left)


def to_model_range(uint8_images: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (the VAE's input range)."""
    return uint8_images.astype(np.float32) / 127.5 - 1.0


class DreamBoothDataset:
    """The views of a directory of instance (or class) images.

    ``center_crop=False`` keeps ``aug_pool`` random crops per source image
    (and per flip with ``random_flip``), drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so the VAE
    encodes every view once and training steps pick among them. The flip
    comes before the crop: the recorded crop is measured on the view the
    model sees. ``num_source`` (images x ``repeats``) is the dataset size of
    the epoch math."""

    def __init__(self, instance_data_dir: str, instance_prompt: str, resolution: int = 512,
                 repeats: int = 1, center_crop: bool = True, random_flip: bool = False,
                 aug_pool: int = 8, seed: int = 0):
        paths = image_files(instance_data_dir)
        if not paths:
            raise FileNotFoundError(f"no images in {instance_data_dir}")
        self.instance_prompt = instance_prompt
        self.resolution = resolution
        self.num_source = len(paths) * repeats
        self.pixel_values: List[np.ndarray] = []
        self.original_sizes: List[Tuple[int, int]] = []
        self.crop_top_lefts: List[Tuple[int, int]] = []
        rng = np.random.default_rng(seed)
        for path in paths * repeats:
            src = read_png(path)
            for view in [src] + ([src[:, ::-1]] if random_flip else []):
                views = ([resize_crop(view, resolution, None)] if center_crop else
                         [resize_crop(view, resolution, rng) for _ in range(aug_pool)])
                for arr, orig, crop in views:
                    self.pixel_values.append(to_model_range(np.ascontiguousarray(arr)))
                    self.original_sizes.append(orig)
                    self.crop_top_lefts.append(crop)

    def __len__(self):
        return len(self.pixel_values)
