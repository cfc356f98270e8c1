"""CLIP byte-level BPE tokenizer, and the hash tokenizer of random-weight runs.

The port's copy of the JAX package's ``data/tokenizer.py``, with its own
copy of the standard merge list (``assets/bpe_simple_vocab_16e6.txt.gz``)
and the pure-Python merge loop. Padding is an argument: SDXL tokenizer_1
and HF CLIP pad with <|endoftext|> (49407), SDXL tokenizer_2 and
open_clip pad with 0. Text cleaning is html-unescape + whitespace
collapse + lower case, as there.

The pre-tokenizer is written with the standard library's ``re``, which has
no ``\\p{L}`` / ``\\p{N}`` classes: letters are ``[^\\W\\d_]`` (Unicode
letters plus the numerics that are not decimal digits), numbers are
``\\d`` (decimal digits), and the punctuation class is every other
character that is not whitespace, ``_`` included. The one difference from
the ``regex`` pattern of the JAX package: numerics outside Unicode's
decimal-digit category (superscripts such as "²", vulgar fractions,
Roman-numeral letters) join the letter runs here, where the ``regex``
pattern splits them off one by one as numbers. ASCII text, accented
letters, digits, apostrophes and ``_`` tokenize identically.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import re
import zlib
from typing import Iterable, List, Sequence

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                                "bpe_simple_vocab_16e6.txt.gz")

_TOKEN_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: tuple) -> set:
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class HashTokenizer:
    """Vocab-free stand-in: deterministic ids from word hashes (crc32), for
    random-weight runs whose embedding tables are smaller than the CLIP
    vocabulary. Not a real tokenizer."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 pad_token_id: int | None = None):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1
        self.pad_token_id = self.eot if pad_token_id is None else pad_token_id

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            words = _clean(text).split()[: self.context_length - 2]
            ids = [zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2) for w in words]
            row = [self.sot] + ids + [self.eot]
            out[i, : len(row)] = row
        return out


class CLIPTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH, context_length: int = 77,
                 pad_token_id: int | None = None, merges: Sequence[str] | None = None):
        if merges is None:
            if not bpe_path or not os.path.exists(bpe_path):
                raise FileNotFoundError(f"CLIP BPE merge file not found: {bpe_path!r}")
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rb") as f:
                lines = f.read().decode("utf-8").split("\n")
            merges = lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]

        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        self.sot_text, self.eot_text = "<|startoftext|>", "<|endoftext|>"
        vocab.extend([self.sot_text, self.eot_text])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {self.sot_text: self.sot_text, self.eot_text: self.eot_text}
        self.context_length = context_length
        self.sot = self.encoder[self.sot_text]
        self.eot = self.encoder[self.eot_text]
        self.pad_token_id = self.eot if pad_token_id is None else pad_token_id
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Raw BPE ids without special tokens or padding."""
        ids = []
        for token in _TOKEN_PATTERN.findall(_clean(text)):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_bytes).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids]
        text = "".join(t for t in toks if t not in (self.sot_text, self.eot_text))
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        """(B, context_length) int32 with SOT/EOT and padding; long prompts
        are cut so EOT is always present."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_token_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def make_clip_tokenizers(bpe_path: str = "", vocab_size: int = 49408, with_reward: bool = False):
    """Dual CLIP tokenizers (the second pads with 0) from ``bpe_path``, the
    packaged vocabulary for full-size towers, else HashTokenizers (tiny
    random towers have fewer than the 49408 CLIP ids). Returns
    (tok1, tok2[, reward_tok])."""
    bpe = bpe_path or (DEFAULT_BPE_PATH if vocab_size == 49408 else "")
    if bpe and os.path.exists(bpe):
        toks = (CLIPTokenizer(bpe), CLIPTokenizer(bpe, pad_token_id=0))
        return toks + (CLIPTokenizer(bpe),) if with_reward else toks
    logging.getLogger("pso.data").warning(
        "no BPE vocab at %r -- using HashTokenizer (random-weight runs)", bpe)
    toks = (HashTokenizer(vocab_size=vocab_size), HashTokenizer(vocab_size=vocab_size,
                                                                pad_token_id=0))
    return toks + (HashTokenizer(vocab_size=vocab_size),) if with_reward else toks
