"""Nearest-2x upsample followed by a 3x3 same-pad conv (NCHW).

The JAX package's plain ``upsample2x_conv3x3`` path; its subpixel and int8
variants are not ported yet.
"""

from __future__ import annotations

import torch.nn.functional as F


def upsample2x_conv3x3(x, weight, bias=None):
    """x (B, C, H, W), weight (O, C, 3, 3) -> (B, O, 2H, 2W)."""
    return F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), weight, bias, padding=1)
