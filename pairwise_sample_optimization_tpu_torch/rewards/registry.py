"""Reward-closure registry.

Counterpart of the JAX package's ``rewards/registry.py``. Each factory
returns ``fn(images, prompt_ids, metadata) -> (scores, meta)``; the device
rewards (light, aesthetic, PickScore) run on the images' device. The two
JPEG (in)compressibility rewards need the PIL JPEG codec, which the port
does not depend on: they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict


def light_reward():
    def _fn(images, prompt_ids=None, metadata=None):
        return images.reshape(images.shape[0], -1).mean(dim=1), {}

    return _fn


def _jpeg_unported(name):
    def factory():
        raise NotImplementedError(f"{name} needs the PIL JPEG codec, which the port does not "
                                  "depend on; it is not ported yet")

    return factory


jpeg_incompressibility = _jpeg_unported("jpeg_incompressibility")
jpeg_compressibility = _jpeg_unported("jpeg_compressibility")


def aesthetic_score(scorer=None, device="cuda"):
    """``scorer``: an ``AestheticScorer``; a random CLIP-L tower with the
    packaged MLP on ``device`` when None."""
    from .aesthetic import AestheticScorer

    scorer = scorer or AestheticScorer.random(mlp_path="packaged", device=device)

    def _fn(images, prompt_ids=None, metadata=None):
        return scorer.score(images), {}

    return _fn


def pick_score(scorer=None, device="cuda"):
    """``scorer``: a ``PickScoreScorer``; random ViT-H/14 towers on
    ``device`` when None."""
    from .pickscore import PickScoreScorer

    scorer = scorer or PickScoreScorer.random(device=device)

    def _fn(images, prompt_ids, metadata=None):
        return scorer.score(images, prompt_ids), {}

    return _fn


REWARD_FNS: Dict[str, Callable] = {
    "light_reward": light_reward,
    "jpeg_incompressibility": jpeg_incompressibility,
    "jpeg_compressibility": jpeg_compressibility,
    "aesthetic_score": aesthetic_score,
    "pick_score": pick_score,
}


def get_reward_fn(name: str, **kwargs):
    if name not in REWARD_FNS:
        raise KeyError(f"unknown reward fn '{name}'; have {sorted(REWARD_FNS)}")
    return REWARD_FNS[name](**kwargs)
