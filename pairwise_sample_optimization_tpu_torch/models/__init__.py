"""SDXL UNet, VAE, CLIP towers and ImageReward's BLIP ViT and BERT
(NCHW, diffusers/HF/timm keys)."""

from .clip import (
    CLIPDualEncoder,
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
)
from .bert import BertConfig, BertEncoder
from .unet import SDXLUNet, UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .vit import ViT, ViTConfig
