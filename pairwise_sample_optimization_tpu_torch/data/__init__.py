"""Prompts, tokenizers and DreamBooth instance images."""

from .dreambooth import DreamBoothDataset, to_model_range
from .prompt_dataset import (PromptDataset, PromptLoader, imagereward_prompts_path,
                             training_prompts_path)
from .tokenizer import DEFAULT_BPE_PATH, CLIPTokenizer, HashTokenizer, make_clip_tokenizers
from .wordpiece import WordPieceTokenizer

__all__ = [
    "CLIPTokenizer",
    "DEFAULT_BPE_PATH",
    "DreamBoothDataset",
    "HashTokenizer",
    "PromptDataset",
    "PromptLoader",
    "WordPieceTokenizer",
    "imagereward_prompts_path",
    "make_clip_tokenizers",
    "to_model_range",
    "training_prompts_path",
]
