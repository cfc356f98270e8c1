"""HPSv2 scorer: the CLIP-H architecture under the HPS_v2 preference weights.

Counterpart of the JAX package's ``rewards/hps.py``: the dual-encoder
cosine score of CLIP score. The released ``HPS_v2_compressed.pt`` is an
open_clip state dict; ``checkpoints.clip_loader.load_clip_dual`` converts
and loads it.
"""

from __future__ import annotations

from .pickscore import PickScoreScorer


class HPSScorer(PickScoreScorer):
    """CLIP-H cosine scorer under the HPSv2 weight set."""
