"""CLIP image preprocessing on the device.

Resize uses ``F.interpolate(mode="bicubic", antialias=True)``: against the
JAX package's ``jax.image.resize`` at 512 -> 224 it agrees to about 5e-7,
where torch's default ``antialias=False`` is off by about 0.7.
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
    lo, hi = value_range
    x = torch.clamp((images.float() - lo) / (hi - lo), 0.0, 1.0)
    if tuple(x.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                          align_corners=False, antialias=True)
        x = torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
