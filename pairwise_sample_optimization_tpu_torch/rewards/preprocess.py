"""CLIP image preprocessing on the device.

Resize uses ``F.interpolate(mode="bicubic", antialias=True)``: against the
JAX package's ``jax.image.resize`` at 512 -> 224 it agrees to about 5e-7,
where torch's default ``antialias=False`` is off by about 0.7.

``clip_preprocess`` resizes to a square; ``clip_preprocess_max_size`` is
open_clip's ``ResizeMaxSize`` eval transform (longest side to ``size``,
the rest centre-padded with black), the same for square images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# OpenAI-CLIP normalization constants (all CLIP variants in the system)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, size: int = 224,
                    value_range: tuple[float, float] = (-1.0, 1.0)) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, size, size, 3) CLIP-normalized fp32.

    ``value_range`` describes the input encoding; VAE decodes land in
    [-1, 1].
    """
    x = _unit_range(images, value_range)
    if tuple(x.shape[1:3]) != (size, size):
        x = _resize(x, size, size)
    return _normalize(x)


def clip_preprocess_max_size(images: torch.Tensor, size: int = 224,
                             value_range: tuple[float, float] = (-1.0, 1.0)) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, size, size, 3) CLIP-normalized fp32, by
    open_clip's ``ResizeMaxSize``: the longest side resized to ``size``
    (aspect kept), the rest padded with black (0 in [0, 1]) around the
    centre. The same as :func:`clip_preprocess` for square images."""
    x = _unit_range(images, value_range)
    h, w = x.shape[1:3]
    scale = size / float(max(h, w))
    new_h, new_w = round(h * scale), round(w * scale)
    if scale != 1.0:
        x = _resize(x, new_h, new_w)
    if (new_h, new_w) != (size, size):
        pad_h, pad_w = size - new_h, size - new_w
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    return _normalize(x)


def _unit_range(images, value_range):
    lo, hi = value_range
    return torch.clamp((images.float() - lo) / (hi - lo), 0.0, 1.0)


def _resize(x, h, w):
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bicubic", align_corners=False,
                      antialias=True)
    return torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1)


def _normalize(x):
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
