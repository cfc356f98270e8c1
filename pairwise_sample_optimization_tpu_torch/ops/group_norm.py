"""GroupNorm (+ optional fused SiLU) on NCHW activations: the dispatch seam.

Every ``act="silu"`` site goes through ``fused_groupnorm_silu`` (the CUDA
kernels on a CUDA tensor, the plain version on a CPU one). GroupNorm
without an activation stays on the plain path, as in the JAX package.

The plain path is the JAX package's ``ops/group_norm.py`` math: fp32
inputs get exact two-pass statistics; sub-fp32 inputs get fp32
E[x^2] - E[x]^2, clamped at 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm_plain(x, weight, bias, num_groups: int, eps: float = 1e-5, act=None):
    """x (B, C, *spatial); weight/bias (C,)."""
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of groups={num_groups}")
    grouped = x.reshape(b, num_groups, -1)
    xf = grouped.float()
    if x.dtype == torch.float32:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    affine = (c,) + (1,) * (x.ndim - 2)
    out = normed * weight.float().reshape(affine) + bias.float().reshape(affine)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unknown act: {act}")
    return out.to(x.dtype)


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-5, act=None):
    """NCHW group norm; ``act='silu'`` fuses the activation."""
    if act == "silu":
        from .fused_groupnorm import fused_groupnorm_silu

        return fused_groupnorm_silu(x, weight, bias, num_groups, eps)
    return group_norm_plain(x, weight, bias, num_groups, eps, act=act)
