"""Scorers (PickScore, CLIP score, HPS, aesthetic, ImageReward), CLIP
preprocessing and the reward registry."""

from .aesthetic import AestheticMLP, AestheticScorer, packaged_mlp_path
from .clipscore import CLIPScorer
from .hps import HPSScorer
from .imagereward import ImageRewardScorer
from .pickscore import PickScoreScorer
from .preprocess import clip_preprocess, clip_preprocess_max_size
from .registry import REWARD_FNS, get_reward_fn
