"""LAION aesthetic predictor: CLIP-L image embedding -> 5-layer MLP.

Counterpart of the JAX package's ``rewards/aesthetic.py``: the MLP
768 -> 1024 -> 128 -> 64 -> 16 -> 1 (no activations) over the
L2-normalized CLIP ViT-L/14 image embedding. Its state-dict keys are the
released checkpoint's (``sac+logos+ava1-l14-linearMSE.pth``, an
``nn.Sequential`` with dropouts at 1, 3 and 5), so that file loads as it
is; the dropouts are inference no-ops and stand here as identities.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from ..device import resolve_device
from ..models.clip import CLIPVisionConfig, CLIPVisionTower
from ..models.layers import init_random_, init_weights_
from .preprocess import clip_preprocess


def packaged_mlp_path() -> str:
    """The released LAION aesthetic-MLP weights, the port's own copy."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "sac+logos+ava1-l14-linearMSE.pth")


class AestheticMLP(nn.Module):
    def __init__(self, in_features: int = 768, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            dims = (in_features, 1024, 128, 64, 16, 1)
            linears = [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
            # the released nn.Sequential's dropout slots (1, 3, 5) keep the indices
            self.layers = nn.Sequential(linears[0], nn.Identity(), linears[1], nn.Identity(),
                                        linears[2], nn.Identity(), linears[3], linears[4])

    def forward(self, x):
        return self.layers(x)[..., 0]


class AestheticScorer:
    def __init__(self, vision: CLIPVisionTower, mlp: AestheticMLP):
        self.vision = vision
        self.mlp = mlp

    @classmethod
    def random(cls, vision_config: Optional[CLIPVisionConfig] = None, seed: int = 0,
               mlp_path: Optional[str] = None, device="cuda",
               fast_init: bool = False) -> "AestheticScorer":
        """Random CLIP-L/14 tower (``vision_config`` otherwise) made from
        ``seed`` on ``device`` (zeros under ``fast_init``); the MLP random
        too, or loaded from ``mlp_path`` ("packaged" = :func:`packaged_mlp_path`)."""
        dev = resolve_device(device)
        vcfg = vision_config or CLIPVisionConfig.vit_l14()
        gen = torch.Generator(device=dev).manual_seed(seed)
        vision = CLIPVisionTower(vcfg, device="meta").to_empty(device=dev)
        mlp = AestheticMLP(vcfg.projection_dim, device="meta").to_empty(device=dev)
        init_weights_(vision, gen, fast_init)
        init_random_(mlp, gen)
        if mlp_path:
            from ..checkpoints.scorer_loaders import load_aesthetic_mlp

            load_aesthetic_mlp(packaged_mlp_path() if mlp_path == "packaged" else mlp_path, mlp)
        return cls(vision.eval(), mlp.eval())

    def score(self, images):
        """images (B, H, W, 3) in [-1, 1] -> aesthetic score (B,) fp32."""
        pixels = clip_preprocess(images, self.vision.config.image_size)
        embed = self.vision(pixels.permute(0, 3, 1, 2).contiguous()).float()
        embed = embed / torch.linalg.vector_norm(embed, dim=-1, keepdim=True)
        return self.mlp(embed)
