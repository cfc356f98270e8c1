"""PNG files written and read with the standard library (``zlib``, ``struct``).

The port does not depend on PIL. A PNG written here is 8-bit RGB, not
interlaced, every row with filter type 0, the image data in one zlib
stream. The reader takes the non-interlaced files other writers make:
colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
(RGBA) at 8 bits (gray and palette also at 1, 2 and 4), the five row
filters, and returns RGB as PIL's ``convert("RGB")`` does: gray
replicated, the palette looked up, alpha dropped without compositing.
Interlaced and 16-bit files are refused.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


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
        f.write(_SIGNATURE)
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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters -> (h, stride) uint8. ``bpp``: bytes per
    pixel (at least 1), the distance of the Sub / Average / Paeth left
    neighbour."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: image data ends early ({len(data)} of "
                         f"{h * (stride + 1)} bytes)")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            line = cur.copy()
        elif kind == 1:  # Sub: a running sum along each byte lane of a pixel
            line = np.zeros(stride, np.uint8)
            for lane in range(min(bpp, stride)):
                line[lane::bpp] = np.cumsum(cur[lane::bpp], dtype=np.uint64).astype(np.uint8)
        elif kind == 2:  # Up
            line = cur + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one bpp to its left
            c_, p_ = cur.tolist(), prev.tolist()
            line_ = bytearray(stride)
            for i in range(stride):
                a = line_[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + p_[i]) >> 1
                else:
                    pred = _paeth(a, p_[i], p_[i - bpp] if i >= bpp else 0)
                line_[i] = (c_[i] + pred) & 0xFF
            line = np.frombuffer(bytes(line_), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has the unknown filter type {kind}")
        out[y] = prev = line
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB (see the module docstring for what
    is read and how it becomes RGB)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(_SIGNATURE), None, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNGs are not read; "
                                  "save it without interlacing")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth == 16:
        raise NotImplementedError(f"{path}: 16-bit PNGs are not read; save it at 8 bits")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{path}: bit depth {depth} is not valid for colour type {ctype}")
    channels = _CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, channels * depth // 8),
                    path)
    if depth < 8:  # samples packed most significant bit first
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (raw[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = samples.reshape(h, stride * per)[:, :w]
    else:
        px = raw.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px.reshape(h, w)]
    if ctype in (0, 4):
        gray = px.reshape(h, w) if ctype == 0 else px[..., 0]
        if depth < 8:
            gray = (gray.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
