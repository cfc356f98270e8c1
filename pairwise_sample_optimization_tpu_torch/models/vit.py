"""Pre-LN ViT returning every token (the BLIP image encoder of ImageReward).

Counterpart of the JAX package's ``models/vit.py``. Unlike the CLIP vision
tower, which pools the class token through a projection, BLIP hands every
patch token to the text encoder's cross-attention, so this tower returns
the whole (B, 1 + P, W) sequence. Its ``state_dict`` keys are the timm
``VisionTransformer`` keys of the released checkpoint's
``blip.visual_encoder`` (``patch_embed.proj``, ``cls_token`` (1, 1, W),
``pos_embed`` (1, 1 + P, W), ``blocks.{i}.(norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2)``, ``norm``), so it loads without a name map.
LayerNorm eps is 1e-6 (BLIP's and flax's default); GELU is exact in fp32
and tanh in bf16, the JAX package's rule. Self-attention is not causal: it
takes the flash-attention kernel (at 224^2, 197 tokens at head dim 64).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .layers import gelu_approximate


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def blip_large(dtype=torch.bfloat16) -> "ViTConfig":
        return ViTConfig(dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, width=32, layers=2, heads=4, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = nn.Linear(cfg.width, 3 * cfg.width, dtype=cfg.dtype)
        self.proj = nn.Linear(cfg.width, cfg.width, dtype=cfg.dtype)

    def forward(self, x):
        b, s, w = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.heads, w // self.heads)  # rows [q | k | v]
        o = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(o.reshape(b, s, w))


class _MLP(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.width, cfg.width * cfg.mlp_ratio, dtype=cfg.dtype)
        self.fc2 = nn.Linear(cfg.width * cfg.mlp_ratio, cfg.width, dtype=cfg.dtype)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(F.gelu(h, approximate=gelu_approximate(h.dtype)))


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=1e-6, dtype=cfg.dtype)
        self.attn = _Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=1e-6, dtype=cfg.dtype)
        self.mlp = _MLP(cfg)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                              dtype=cfg.dtype)


class ViT(nn.Module):
    def __init__(self, config: ViTConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        with torch.device(resolve_device(device)):
            self.patch_embed = _PatchEmbed(cfg)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width, dtype=cfg.dtype))
            self.pos_embed = nn.Parameter(torch.zeros(1, tokens, cfg.width, dtype=cfg.dtype))
            self.blocks = nn.ModuleList([_Block(cfg) for _ in range(cfg.layers)])
            self.norm = nn.LayerNorm(cfg.width, eps=1e-6, dtype=cfg.dtype)

    @torch.no_grad()
    def init_extra_(self, generator):
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixels):
        """pixels (B, 3, H, W), CLIP-normalized -> tokens (B, 1 + P, W)."""
        x = self.patch_embed.proj(pixels.to(self.cls_token.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, P, W), row-major patch order
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
