"""CLIP score (an eval metric): laion2B CLIP-H cosine similarity.

Counterpart of the JAX package's ``rewards/clipscore.py``: PickScore's
computation, diag(norm(text) @ norm(image)^T), under the original laion2B
ViT-H-14 weights. The reference's eval transform is open_clip's
resize-longest-side (``preprocess="max_size"``), the same as a plain resize
for the square images the pipeline makes.
"""

from __future__ import annotations

from .pickscore import PickScoreScorer


class CLIPScorer(PickScoreScorer):
    """PickScore's architecture and score; only its weight set differs."""
