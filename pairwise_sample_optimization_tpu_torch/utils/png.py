"""PNG files written with the standard library (``zlib``, ``struct``).

The port does not depend on PIL. A PNG here is 8-bit RGB, not interlaced,
every row with filter type 0, the image data in one zlib stream.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write ``rgb`` (H, W, 3) uint8 to ``path``."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def to_uint8(images) -> np.ndarray:
    """Images in [-1, 1] (a tensor or array, (B, H, W, 3)) -> uint8, as the
    JAX package saves them: (x + 1) * 127.5, clipped, truncated."""
    arr = images.detach().float().cpu().numpy() if hasattr(images, "detach") else images
    return ((np.asarray(arr, np.float32) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def save_pngs(images, out_dir: str, name: str = "{i}.png", first: int = 0) -> List[str]:
    """Images in [-1, 1] as PNGs under ``out_dir``, named by ``name`` with
    their index counted from ``first``; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, a in enumerate(to_uint8(images), start=first):
        paths.append(os.path.join(out_dir, name.format(i=i)))
        write_png(paths[-1], a)
    return paths
