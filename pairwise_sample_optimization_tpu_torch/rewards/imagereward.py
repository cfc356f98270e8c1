"""ImageReward-v1.0: BLIP ViT-L/16 image tokens, cross-attended by a BERT
text encoder, the ``[CLS]`` output through an MLP head, standardized.

Counterpart of the JAX package's ``rewards/imagereward.py``: images are
CLIP-preprocessed to 224^2, the ViT returns all 197 tokens, BERT reads the
WordPiece prompt (``data.wordpiece``, 35 tokens) with cross-attention to
them, and the head maps the ``[CLS]`` state 768 -> 1024 -> 128 -> 64 -> 16
-> 1; the raw output is standardized by the released mean and std. The head
has the released ``mlp.layers.{0,2,4,6,7}`` layout, the aesthetic
predictor's (``rewards.aesthetic.AestheticMLP``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..models.bert import BertConfig, BertEncoder
from ..models.layers import init_random_
from ..models.vit import ViT, ViTConfig
from .aesthetic import AestheticMLP
from .preprocess import clip_preprocess

# the released normalization of the raw head output (ImageReward-v1.0)
IMAGEREWARD_MEAN = 0.16717362830052426
IMAGEREWARD_STD = 1.0333394966054072


class ImageRewardScorer:
    def __init__(self, vit: ViT, bert: BertEncoder, mlp: AestheticMLP,
                 mean: float = IMAGEREWARD_MEAN, std: float = IMAGEREWARD_STD):
        self.vit, self.bert, self.mlp = vit, bert, mlp
        self.mean, self.std = mean, std

    @classmethod
    def random(cls, vit_config: Optional[ViTConfig] = None,
               bert_config: Optional[BertConfig] = None, seed: int = 0,
               device="cuda") -> "ImageRewardScorer":
        """Architecture-true random weights (BLIP ViT-L/16 and the BLIP
        BERT-base by default) made from ``seed``, built on ``device``
        directly."""
        dev = resolve_device(device)
        bcfg = bert_config or BertConfig.blip_base()
        gen = torch.Generator(device=dev).manual_seed(seed)
        modules = (ViT(vit_config or ViTConfig.blip_large(), device="meta"),
                   BertEncoder(bcfg, device="meta"), AestheticMLP(bcfg.hidden, device="meta"))
        for module in modules:
            module.to_empty(device=dev)
            init_random_(module, gen)
            module.eval()
        return cls(*modules)

    def score(self, images, input_ids, attention_mask):
        """images (B, H, W, 3) in [-1, 1]; ``input_ids`` / ``attention_mask``
        (B, S) from ``data.wordpiece.WordPieceTokenizer`` -> (B,) fp32."""
        pixels = clip_preprocess(images, self.vit.config.image_size)
        tokens = self.vit(pixels.permute(0, 3, 1, 2).contiguous())
        text = self.bert(input_ids, attention_mask, tokens)
        raw = self.mlp(text[:, 0].float())
        return (raw - self.mean) / self.std
