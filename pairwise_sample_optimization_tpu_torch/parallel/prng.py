"""Per-rank random streams.

Every draw that must agree across ranks (the global batch's noise, its
shuffle, the preference axes) comes from generators seeded the same on
every rank. What each rank must draw on its own takes its rank into the
seed, with rank 0 drawing what a one-process run draws:

- the prompt stream: ``host_fold(seed) = seed + data index`` (the rank
  without a mesh), as the JAX runner seeds its ``PromptLoader``: the model
  ranks of one data index read the same prompts;
- DreamBooth's picks and latent draws: :func:`rank_entropy` of the step's
  ``SeedSequence`` entropy.
"""

from __future__ import annotations

from typing import Sequence

from .mesh import data_index
from .multihost import rank as _rank


def host_fold(seed: int) -> int:
    """The seed of this rank's data stream: its data index's."""
    return seed + data_index()


def rank_entropy(entropy: Sequence[int]) -> list[int]:
    """``SeedSequence`` entropy of this rank's stream: ``entropy`` itself on
    rank 0, so one process draws as it always did; with the rank appended
    on the others."""
    r = _rank()
    return list(entropy) + ([r] if r else [])
