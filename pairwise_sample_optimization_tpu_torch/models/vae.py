"""AutoencoderKL decoder (SDXL VAE) in PyTorch, NCHW.

Counterpart of the decode half of the JAX package's ``models/vae.py``:
``post_quant_conv`` and ``Decoder`` with diffusers keys
(``decoder.*``, ``post_quant_conv.*``). The encoder is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .layers import GroupNorm, ResnetBlock, Upsample


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.13025
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sdxl(dtype=torch.float32) -> "VAEConfig":
        return VAEConfig(dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8,
                         dtype=dtype)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (d = C)."""

    def __init__(self, channels: int, groups: int, dtype=None):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, eps=1e-6, dtype=dtype)
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, dtype=dtype)])

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q = self.to_q(x)[:, :, None, :]
        k = self.to_k(x)[:, :, None, :]
        v = self.to_v(x)[:, :, None, :]
        o = self.to_out[0](dot_product_attention(q, k, v)[:, :, 0, :])
        return o.transpose(1, 2).contiguous().view(b, c, h, w) + residual


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        channels = list(reversed(cfg.block_out_channels))
        resnet = lambda cin, cout: ResnetBlock(cin, cout, None, cfg.norm_groups, eps=1e-6,
                                               dtype=dt)
        self.conv_in = nn.Conv2d(cfg.latent_channels, channels[0], 3, padding=1, dtype=dt)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([resnet(channels[0], channels[0]),
                                                resnet(channels[0], channels[0])])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(channels[0], cfg.norm_groups, dt)])
        self.up_blocks = nn.ModuleList()
        h_ch = channels[0]
        for level, ch in enumerate(channels):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(h_ch, ch))
                h_ch = ch
            if level < len(channels) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch, dtype=dt)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(channels[-1], cfg.norm_groups, eps=1e-6, act="silu",
                                       dtype=dt)
        self.conv_out = nn.Conv2d(channels[-1], cfg.in_channels, 3, padding=1, dtype=dt)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """Decode side of the SDXL VAE."""

    def __init__(self, config: VAEConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.decoder = Decoder(config)
            self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1,
                                             dtype=config.dtype)

    def decode(self, z):
        """Scaled latents (B, 4, h, w) -> image (B, 3, H, W) in [-1, 1]."""
        z = (z.float() / self.config.scaling_factor).to(self.config.dtype)
        return self.decoder(self.post_quant_conv(z))
