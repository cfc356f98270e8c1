"""BERT WordPiece tokenizer for the ImageReward text path.

Counterpart of the JAX package's ``data/wordpiece.py``: lower case, spaces
around punctuation, then greedy longest-match-first subwords over a BERT
vocabulary (one token a line; ``##`` marks a continuation piece; a word
with no match becomes ``[UNK]``). A prompt becomes ``[CLS] ... [SEP]``,
truncated to ``context_length`` (35 for ImageReward) and padded with
``[PAD]``. The vocabulary is data: pass a ``vocab.txt`` (bert-base-uncased's)
or a list.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np

_PUNCT = re.compile(r"([\.,!?;:()\[\]{}\"'`~@#$%^&*+=|\\/<>-])")


class WordPieceTokenizer:
    def __init__(self, vocab_path: str = "", vocab: Sequence[str] | None = None,
                 context_length: int = 35, lowercase: bool = True):
        if vocab is None:
            if not vocab_path or not os.path.exists(vocab_path):
                raise FileNotFoundError(f"WordPiece vocab not found: {vocab_path!r}")
            with open(vocab_path, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f]
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.context_length = context_length
        self.lowercase = lowercase
        for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if special not in self.vocab:
                raise ValueError(f"vocab missing {special}")
        self.pad, self.unk = self.vocab["[PAD]"], self.vocab["[UNK]"]
        self.cls, self.sep = self.vocab["[CLS]"], self.vocab["[SEP]"]
        self.vocab_size = len(self.vocab)

    def _split(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        return _PUNCT.sub(r" \1 ", text).split()

    def _wordpiece(self, word: str) -> List[int]:
        ids: List[int] = []
        start = 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return ids

    def encode(self, text: str) -> List[int]:
        return [i for word in self._split(text) for i in self._wordpiece(word)]

    def __call__(self, texts: str | Sequence[str]):
        """-> (input_ids, attention_mask), both (B, context_length) int32."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        ids = np.full((len(texts), n), self.pad, np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for i, text in enumerate(texts):
            row = [self.cls] + self.encode(text)[:n - 2] + [self.sep]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask
