"""Prompts and tokenizers."""

from .prompt_dataset import (PromptDataset, PromptLoader, imagereward_prompts_path,
                             training_prompts_path)
from .tokenizer import DEFAULT_BPE_PATH, CLIPTokenizer, HashTokenizer, make_clip_tokenizers
from .wordpiece import WordPieceTokenizer

__all__ = [
    "CLIPTokenizer",
    "DEFAULT_BPE_PATH",
    "HashTokenizer",
    "PromptDataset",
    "PromptLoader",
    "WordPieceTokenizer",
    "imagereward_prompts_path",
    "make_clip_tokenizers",
    "training_prompts_path",
]
