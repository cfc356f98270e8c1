"""Prompts and tokenizers."""

from .prompt_dataset import PromptDataset, PromptLoader, training_prompts_path
from .tokenizer import DEFAULT_BPE_PATH, CLIPTokenizer, HashTokenizer, make_clip_tokenizers

__all__ = [
    "CLIPTokenizer",
    "DEFAULT_BPE_PATH",
    "HashTokenizer",
    "PromptDataset",
    "PromptLoader",
    "make_clip_tokenizers",
    "training_prompts_path",
]
