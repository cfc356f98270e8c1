"""Nearest-2x upsample followed by a 3x3 same-pad conv (NCHW): the JAX
package's ``ops/upsample.py``.

Two paths, chosen process-wide by :func:`set_use_subpixel` (the
``kernels.subpixel_upsample`` knob; off by default):

- naive: ``F.interpolate`` then the 3x3 conv through
  ``qconv.decoder_conv2d``, which may run it in int8 (an ``allow_int8``
  site under the int8 decode, or inside the int8 reference pass);
- subpixel: nearest duplication makes neighbouring taps read the same
  source pixel, so per output parity the 3x3 kernel collapses to a 2x2
  kernel on the coarse grid: output row 2i+a reads coarse rows [i-1, i]
  (a = 0, taps [K0, K1+K2]) or [i, i+1] (a = 1, taps [K0+K1, K2]), and the
  same along columns. One conv with the four parities' kernels stacked on
  the output channels (16 products per coarse pixel and output channel
  instead of 36), then the parities interleaved. The collapsed taps are
  summed in fp32 and cast to the weight's dtype, as the JAX package sums
  them. The conv is ``F.conv2d``, as JAX computes it with
  ``lax.conv_general_dilated``; it never runs in int8, and it carries
  gradients (the UNet's up-blocks in training).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .qconv import decoder_conv2d

_USE_SUBPIXEL = False


def set_use_subpixel(flag: bool) -> None:
    """upsample + conv through the subpixel rewrite (True) or naively."""
    global _USE_SUBPIXEL
    _USE_SUBPIXEL = bool(flag)


def subpixel_kernel(weight):
    """(O, C, 3, 3) -> (4 * O, C, 2, 2): the collapsed kernels of the parities
    (a, b) = (0, 0), (0, 1), (1, 0), (1, 1), each O output channels."""
    kf = weight.float()
    rows = (torch.stack([kf[:, :, 0], kf[:, :, 1] + kf[:, :, 2]], dim=2),  # taps over [i-1, i]
            torch.stack([kf[:, :, 0] + kf[:, :, 1], kf[:, :, 2]], dim=2))  # over [i, i+1]

    def cols(r2, b):
        if b == 0:
            return torch.stack([r2[..., 0], r2[..., 1] + r2[..., 2]], dim=-1)
        return torch.stack([r2[..., 0] + r2[..., 1], r2[..., 2]], dim=-1)

    return torch.cat([cols(rows[a], b) for a in (0, 1) for b in (0, 1)]).to(weight.dtype)


def upsample2x_conv3x3(x, weight, bias=None, allow_int8: bool = False):
    """x (B, C, H, W), weight (O, C, 3, 3), bias (O,) -> (B, O, 2H, 2W)."""
    if not _USE_SUBPIXEL:
        return decoder_conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"), weight, bias,
                              allow_int8=allow_int8)
    b, _, h, w = x.shape
    o = weight.shape[0]
    # (B, 4O, H+1, W+1): position (i', j') reads coarse rows i'-1, i' and columns j'-1, j'
    y = F.conv2d(x, subpixel_kernel(weight), padding=1).view(b, 2, 2, o, h + 1, w + 1)
    # output pixel (2i+a, 2j+b) = y[a, b, :, i+a, j+b]
    top = torch.stack([y[:, 0, 0, :, :h, :w], y[:, 0, 1, :, :h, 1:]], dim=-1)
    bot = torch.stack([y[:, 1, 0, :, 1:, :w], y[:, 1, 1, :, 1:, 1:]], dim=-1)
    out = torch.stack([top, bot], dim=3).reshape(b, o, 2 * h, 2 * w)
    return out if bias is None else out + bias.to(out.dtype).view(1, -1, 1, 1)
