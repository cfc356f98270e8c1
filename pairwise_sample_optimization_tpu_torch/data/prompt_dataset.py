"""Prompt dataset and the shuffled, tokenized batch loader.

The port's copy of the JAX package's ``data/prompt_dataset.py``. A prompt
set is a JSON list of ``{caption: ...}`` records (or plain strings, or a
dict of splits), a newline-delimited ``.txt``, ``"4k"`` for the packaged
4000 PickaPic training captions (``assets/4k_training_prompts.json``),
``"imagereward"`` for the packaged ImageReward benchmark prompts
(``assets/imagereward_prompt.txt``), or nothing for the built-in 16-prompt
set. The loader draws each epoch's
order from ``numpy.random.default_rng(seed)``, as there, so both packages
give the same batches for the same seed.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np

_BUILTIN_PROMPTS = [
    "a photo of a corgi wearing sunglasses on a beach",
    "an oil painting of a lighthouse in a storm",
    "a futuristic city skyline at sunset, digital art",
    "a macro photograph of a dew-covered spider web",
    "a watercolor sketch of a red fox in the snow",
    "an astronaut riding a horse in photorealistic style",
    "a bowl of ramen with chopsticks, studio lighting",
    "a medieval castle on a cliff above the ocean",
    "a robot playing chess in a dimly lit room",
    "a field of sunflowers under a thunderstorm",
    "a portrait of an old sailor with a pipe, rembrandt lighting",
    "a glass terrarium containing a tiny rainforest",
    "a steam locomotive crossing a stone viaduct",
    "a neon-lit alley in tokyo at night in the rain",
    "a stack of pancakes with maple syrup and berries",
    "a hot air balloon festival over mountain valleys",
]


def training_prompts_path() -> str:
    """The packaged 4k PickaPic training prompts."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "4k_training_prompts.json")


def imagereward_prompts_path() -> str:
    """The packaged ImageReward benchmark prompts (one per line)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "imagereward_prompt.txt")


_PACKAGED = {"4k": training_prompts_path, "imagereward": imagereward_prompts_path}


class PromptDataset:
    def __init__(self, json_path: Optional[str] = None, caption_key: str = "caption",
                 split: Optional[str] = None, hf_dataset: Optional[str] = None):
        """``split`` picks a named split when the JSON is a dict of splits;
        a HuggingFace ``datasets`` source is not ported."""
        if hf_dataset:
            raise NotImplementedError("HuggingFace datasets sources are not ported yet; pass a "
                                      "prompts JSON or .txt path")
        if json_path in _PACKAGED:
            json_path = _PACKAGED[json_path]()
        if json_path and not os.path.exists(json_path):
            raise FileNotFoundError(f"prompt json not found: {json_path!r}")
        if json_path and json_path.endswith(".txt"):
            with open(json_path) as f:
                self.prompts = [ln.strip() for ln in f if ln.strip()]
        elif json_path:
            with open(json_path) as f:
                meta = json.load(f)
            if isinstance(meta, dict):
                if split is None or split not in meta:
                    raise KeyError(f"{json_path} is a dict of splits {list(meta)}; "
                                   f"requested split={split!r}")
                meta = meta[split]
            self.prompts = [m[caption_key] if isinstance(m, dict) else str(m) for m in meta]
        else:
            self.prompts = list(_BUILTIN_PROMPTS)

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx: int) -> str:
        return self.prompts[idx]


class PromptLoader:
    """Shuffled epoch iterator of tokenized batches: the raw prompts plus
    (B, 77) int32 ids from each tokenizer given."""

    def __init__(self, dataset: PromptDataset, batch_size: int, tokenizer_one,
                 tokenizer_two=None, reward_tokenizer=None, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tok1, self.tok2, self.tok_r = tokenizer_one, tokenizer_two, reward_tokenizer
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def epoch(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.dataset))
        stop = len(order) - self.batch_size + 1 if self.drop_last else len(order)
        for start in range(0, max(stop, 0), self.batch_size):
            prompts = [self.dataset[int(i)] for i in order[start: start + self.batch_size]]
            batch = {"prompts": prompts, "input_ids_one": self.tok1(prompts)}
            if self.tok2 is not None:
                batch["input_ids_two"] = self.tok2(prompts)
            if self.tok_r is not None:
                batch["reward_input_ids"] = self.tok_r(prompts)
            yield batch

    def __iter__(self):
        return self.epoch()
