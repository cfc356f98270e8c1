"""PickScore reward and CLIP preprocessing."""

from .pickscore import PickScoreScorer
from .preprocess import clip_preprocess
