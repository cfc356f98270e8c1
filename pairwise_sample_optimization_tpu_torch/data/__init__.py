"""Prompts, tokenizers, DreamBooth instance images and per-prompt reward
statistics."""

from .dreambooth import DreamBoothDataset, to_model_range
from .prompt_dataset import (PromptDataset, PromptLoader, imagereward_prompts_path,
                             training_prompts_path)
from .prompts import PROMPT_FNS, get_prompt_fn
from .stat_tracking import PerPromptStatTracker
from .tokenizer import DEFAULT_BPE_PATH, CLIPTokenizer, HashTokenizer, make_clip_tokenizers
from .wordpiece import WordPieceTokenizer

__all__ = [
    "CLIPTokenizer",
    "DEFAULT_BPE_PATH",
    "DreamBoothDataset",
    "HashTokenizer",
    "PROMPT_FNS",
    "PerPromptStatTracker",
    "PromptDataset",
    "PromptLoader",
    "WordPieceTokenizer",
    "get_prompt_fn",
    "imagereward_prompts_path",
    "make_clip_tokenizers",
    "to_model_range",
    "training_prompts_path",
]
