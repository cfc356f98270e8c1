"""CLIP text and vision towers in PyTorch with HF ``CLIPModel`` keys.

Counterpart of the JAX package's ``models/clip.py``. One implementation
serves SDXL text encoder 1 (CLIP-L text, quick-gelu), text encoder 2 (bigG
text, gelu, projected pooled output), the CLIP-H dual encoder of PickScore,
CLIP score and HPS, and the aesthetic scorer's CLIP-L image tower.

Text towers are causal (plain attention path); the vision tower is not
(flash-attention kernel). Pooling follows HF: the final-LN state at each
sequence's argmax token (EOS has the highest id), and the vision class
token through the post layer norm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .layers import LoRALinear, gelu_approximate


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_positions: int = 77
    act: str = "quick_gelu"  # or "gelu"
    norm_eps: float = 1e-5
    projection_dim: Optional[int] = None  # None = no text_projection
    # LoRA (and DoRA) on every layer's q/k/v/out projections: the DreamBooth
    # text-encoder training (--train_text_encoder)
    lora_rank: int = 0
    lora_use_dora: bool = False
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sdxl_te1(dtype=torch.bfloat16) -> "CLIPTextConfig":
        return CLIPTextConfig(dtype=dtype)

    @staticmethod
    def sdxl_te2(dtype=torch.bfloat16) -> "CLIPTextConfig":
        return CLIPTextConfig(width=1280, layers=32, heads=20, act="gelu", projection_dim=1280,
                              dtype=dtype)

    @staticmethod
    def vit_h14(dtype=torch.bfloat16) -> "CLIPTextConfig":
        """Text tower of laion CLIP-H (PickScore backbone)."""
        return CLIPTextConfig(width=1024, layers=24, heads=16, act="gelu", projection_dim=1024,
                              dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=4, max_positions=77,
                              projection_dim=16, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    act: str = "gelu"
    norm_eps: float = 1e-5
    projection_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def vit_h14(dtype=torch.bfloat16) -> "CLIPVisionConfig":
        return CLIPVisionConfig(dtype=dtype)

    @staticmethod
    def vit_l14(dtype=torch.bfloat16) -> "CLIPVisionConfig":
        """Image tower of OpenAI CLIP ViT-L/14 (the aesthetic scorer's)."""
        return CLIPVisionConfig(width=1024, layers=24, heads=16, act="quick_gelu",
                                projection_dim=768, dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=28, patch_size=7, width=32, layers=2, heads=4,
                                projection_dim=16, dtype=dtype)


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x, approximate=gelu_approximate(x.dtype))
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype, lora_rank: int = 0, use_dora: bool = False):
        super().__init__()
        self.heads = heads
        lin = lambda: LoRALinear(width, width, dtype=dtype, lora_rank=lora_rank, use_dora=use_dora)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = lin(), lin(), lin(), lin()

    def forward(self, x, causal: bool):
        b, s, w = x.shape
        split = lambda t: t.view(b, s, self.heads, w // self.heads)
        o = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                  split(self.v_proj(x)), causal=causal)
        return self.out_proj(o.reshape(b, s, w))


class CLIPMLP(nn.Module):
    def __init__(self, width: int, act: str, dtype):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(width, 4 * width, dtype=dtype)
        self.fc2 = nn.Linear(4 * width, width, dtype=dtype)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, act: str, eps: float, dtype, lora_rank: int = 0,
                 use_dora: bool = False):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=eps, dtype=dtype)
        self.self_attn = CLIPAttention(width, heads, dtype, lora_rank, use_dora)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps, dtype=dtype)
        self.mlp = CLIPMLP(width, act, dtype)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, width, heads, act, eps, n_layers, dtype, lora_rank=0, use_dora=False):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(width, heads, act, eps, dtype, lora_rank,
                                                      use_dora) for _ in range(n_layers)])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, dtype=cfg.dtype)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.width, dtype=cfg.dtype)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[None, :s]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.width, cfg.heads, cfg.act, cfg.norm_eps, cfg.layers,
                                   cfg.dtype, cfg.lora_rank, cfg.lora_use_dora)
        self.final_layer_norm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps, dtype=cfg.dtype)

    def forward(self, input_ids):
        """-> (hidden states [embeddings, layer 1 .. L], final-LN output,
        pooled final-LN state at the EOS token)."""
        x = self.embeddings(input_ids)
        hiddens = [x]
        for layer in self.encoder.layers:
            x = layer(x, causal=True)
            hiddens.append(x)
        final = self.final_layer_norm(x)
        eos = input_ids.argmax(dim=-1)
        pooled = final[torch.arange(input_ids.shape[0], device=final.device), eos]
        return hiddens, final, pooled


class CLIPTextTower(nn.Module):
    """HF ``CLIPTextModel(WithProjection)``; returns a dict with
    ``hidden_states``, ``last_hidden_state``, ``penultimate`` (SDXL
    consumes ``hidden_states[-2]``), ``pooled`` and ``projected``."""

    def __init__(self, config: CLIPTextConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.text_model = CLIPTextTransformer(config)
            self.text_projection = (
                nn.Linear(config.width, config.projection_dim, bias=False, dtype=config.dtype)
                if config.projection_dim else None)

    def forward(self, input_ids):
        hiddens, final, pooled = self.text_model(input_ids)
        projected = self.text_projection(pooled) if self.text_projection is not None else None
        return {"hidden_states": hiddens, "last_hidden_state": final, "penultimate": hiddens[-2],
                "pooled": pooled, "projected": projected}


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width, dtype=cfg.dtype))
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, dtype=cfg.dtype)
        self.position_embedding = nn.Embedding(n_patches + 1, cfg.width, dtype=cfg.dtype)

    @torch.no_grad()
    def init_extra_(self, generator):
        self.class_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixels):
        x = self.patch_embedding(pixels.to(self.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, W), row-major patch order
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps, dtype=cfg.dtype)  # (sic)
        self.encoder = CLIPEncoder(cfg.width, cfg.heads, cfg.act, cfg.norm_eps, cfg.layers,
                                   cfg.dtype)
        self.post_layernorm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps, dtype=cfg.dtype)

    def forward(self, pixels):
        """pixels (B, 3, H, W), CLIP-normalized -> pooled class token (B, W)."""
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x, causal=False)
        return self.post_layernorm(x[:, 0])


class CLIPVisionTower(nn.Module):
    """HF ``CLIPVisionModelWithProjection``: pooled class-token projection."""

    def __init__(self, config: CLIPVisionConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.vision_model = CLIPVisionTransformer(config)
            self.visual_projection = nn.Linear(config.width, config.projection_dim, bias=False,
                                               dtype=config.dtype)

    def forward(self, pixels):
        return self.visual_projection(self.vision_model(pixels))


class CLIPDualEncoder(nn.Module):
    """Image + text dual encoder (PickScore shape), HF ``CLIPModel`` keys."""

    def __init__(self, text_config: CLIPTextConfig, vision_config: CLIPVisionConfig,
                 device="cuda"):
        super().__init__()
        self.text_config, self.vision_config = text_config, vision_config
        with torch.device(resolve_device(device)):
            self.text_model = CLIPTextTransformer(text_config)
            self.vision_model = CLIPVisionTransformer(vision_config)
            self.text_projection = nn.Linear(text_config.width, text_config.projection_dim,
                                             bias=False, dtype=text_config.dtype)
            self.visual_projection = nn.Linear(vision_config.width, vision_config.projection_dim,
                                               bias=False, dtype=vision_config.dtype)
            self.logit_scale = nn.Parameter(torch.tensor(4.6052))

    @torch.no_grad()
    def init_extra_(self, generator):
        self.logit_scale.fill_(4.6052)

    def text_features(self, input_ids):
        return self.text_projection(self.text_model(input_ids)[2])

    def image_features(self, pixels):
        """pixels (B, 3, H, W), CLIP-normalized."""
        return self.visual_projection(self.vision_model(pixels))
