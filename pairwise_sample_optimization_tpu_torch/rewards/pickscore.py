"""PickScore reward: CLIP-H dual encoder, cosine score.

Counterpart of the JAX package's ``rewards/pickscore.py``:
score = diag(norm(text) @ norm(image)^T), features normalized with a
1e-6 floor. Images stay on the device: resize and normalize run there.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..models.clip import CLIPDualEncoder, CLIPTextConfig, CLIPVisionConfig
from ..models.layers import init_weights_
from .preprocess import clip_preprocess, clip_preprocess_max_size

_PREPROCESS = {"resize": clip_preprocess, "max_size": clip_preprocess_max_size}


def _normalize(f):
    return f / torch.clamp(torch.linalg.vector_norm(f.float(), dim=-1, keepdim=True), min=1e-6)


class PickScoreScorer:
    def __init__(self, model: CLIPDualEncoder, preprocess: str = "resize"):
        """``preprocess``: "resize" (a square resize; the protocol's images
        are square) or "max_size" (open_clip's ``ResizeMaxSize``, longest
        side and pad, for non-square images)."""
        if preprocess not in _PREPROCESS:
            raise ValueError(f"preprocess must be one of {sorted(_PREPROCESS)}, "
                             f"got {preprocess!r}")
        self.model = model
        self.preprocess = preprocess

    @classmethod
    def random(cls, text_config: Optional[CLIPTextConfig] = None,
               vision_config: Optional[CLIPVisionConfig] = None, seed: int = 0,
               device="cuda", preprocess: str = "resize",
               fast_init: bool = False) -> "PickScoreScorer":
        """Architecture-true random weights (ViT-H/14 by default), built on
        ``device`` directly (meta first, no host copy); zeros under
        ``fast_init``."""
        dev = resolve_device(device)
        model = CLIPDualEncoder(text_config or CLIPTextConfig.vit_h14(),
                                vision_config or CLIPVisionConfig.vit_h14(), device="meta")
        model.to_empty(device=dev)
        init_weights_(model, torch.Generator(device=dev).manual_seed(seed), fast_init)
        return cls(model.eval(), preprocess)

    def text_features(self, input_ids):
        """(B, 77) token ids -> (B, P) unit-norm fp32 features."""
        return _normalize(self.model.text_features(input_ids))

    def image_features(self, images):
        """(B, H, W, 3) images in [-1, 1] -> (B, P) unit-norm fp32 features."""
        pixels = _PREPROCESS[self.preprocess](images, self.model.vision_config.image_size)
        return _normalize(self.model.image_features(pixels.permute(0, 3, 1, 2).contiguous()))

    def score(self, images, input_ids):
        """images (B, H, W, 3) in [-1, 1]; input_ids (B, 77) -> (B,)."""
        return self.score_with_text_features(images, self.text_features(input_ids))

    def score_with_text_features(self, images, text_features):
        """Scores against precomputed unit-norm text features (B, P)."""
        return torch.sum(text_features * self.image_features(images), dim=-1)
