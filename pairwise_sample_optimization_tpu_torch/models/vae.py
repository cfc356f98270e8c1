"""AutoencoderKL (SDXL VAE) in PyTorch, NCHW.

Counterpart of the JAX package's ``models/vae.py``, both directions, with
diffusers keys: ``encoder.*`` and ``quant_conv.*`` (``encode``: an image to
the latent moments, for DreamBooth's instance and negative images), and
``post_quant_conv.*`` and ``decoder.*`` (``decode``). The VAE runs in its
config's dtype; its GroupNorm+SiLU and mid-block attention go through the
op seams (the CUDA kernels on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .layers import Downsample, GroupNorm, ResnetBlock, Upsample


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


class Encoder(nn.Module):
    """conv_in, per level ``layers_per_block`` resnets and (but on the last
    level) a stride-2 Downsample padded bottom/right, the mid block (resnet,
    attention, resnet), GroupNorm+SiLU and conv_out to 2 x latent channels
    (the mean and log-variance)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        dt = cfg.dtype
        chans = cfg.block_out_channels
        resnet = lambda cin, cout: ResnetBlock(cin, cout, None, cfg.norm_groups, eps=1e-6,
                                               dtype=dt)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1, dtype=dt)
        self.down_blocks = nn.ModuleList()
        h_ch = chans[0]
        for level, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(resnet(h_ch, ch))
                h_ch = ch
            if level < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, dtype=dt, asymmetric=True)])
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([resnet(chans[-1], chans[-1]),
                                                resnet(chans[-1], chans[-1])])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(chans[-1], cfg.norm_groups, dt)])
        self.conv_norm_out = GroupNorm(chans[-1], cfg.norm_groups, eps=1e-6, act="silu",
                                       dtype=dt)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1, dtype=dt)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(self.conv_norm_out(h))


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
    """The SDXL VAE: ``encode`` images to latent moments, ``decode`` scaled
    latents to images."""

    def __init__(self, config: VAEConfig, device="cuda"):
        super().__init__()
        self.config = config
        lat = config.latent_channels
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(config)
            self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1, dtype=config.dtype)
            self.decoder = Decoder(config)
            self.post_quant_conv = nn.Conv2d(lat, lat, 1, dtype=config.dtype)

    def encode(self, x):
        """Image (B, 3, H, W) in [-1, 1] -> (mean, logvar), each
        (B, 4, H/8, W/8) fp32, the log-variance clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(x.to(self.config.dtype))).float()
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def sample_latents(self, x, generator=None, noise=None):
        """Encode and draw z = mean + exp(logvar / 2) * n, times the scaling
        factor; ``n`` is ``noise`` where given, else drawn from
        ``generator``."""
        mean, logvar = self.encode(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.config.scaling_factor

    def decode(self, z):
        """Scaled latents (B, 4, h, w) -> image (B, 3, H, W) in [-1, 1]."""
        z = (z.float() / self.config.scaling_factor).to(self.config.dtype)
        return self.decoder(self.post_quant_conv(z))
