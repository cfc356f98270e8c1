"""HPSv2 scorer: the CLIP-H architecture under the HPS_v2 preference weights.

Counterpart of the JAX package's ``rewards/hps.py``: the dual-encoder
cosine score of CLIP score. Loading the released ``HPS_v2_compressed.pt``
(open_clip format) is not ported yet; the scorer runs with the weights it
is given.
"""

from __future__ import annotations

from .pickscore import PickScoreScorer


class HPSScorer(PickScoreScorer):
    """CLIP-H cosine scorer under the HPSv2 weight set."""
