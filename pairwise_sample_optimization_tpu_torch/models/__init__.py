"""SDXL UNet, VAE decoder and CLIP towers (NCHW, diffusers/HF keys)."""

from .clip import (
    CLIPDualEncoder,
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
)
from .unet import SDXLUNet, UNetConfig
from .vae import AutoencoderKL, VAEConfig
