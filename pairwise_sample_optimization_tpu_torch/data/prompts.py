"""Random-prompt closures: the port's copy of the JAX package's
``data/prompts.py`` (the reference's legacy ``prompts.py``).

Each function returns ``(prompt, metadata)``; ``get_prompt_fn`` picks one by
name (``config.prompt_fn``). Line-list files are data, read from the given
path or, where it does not exist, from ``PSO_PROMPT_ASSETS`` (read when
this module is imported). The picks come from the module-level ``random``,
so the same ``random.seed`` gives the JAX package's picks. The current
trainers draw from the PickaPic prompt JSON instead.
"""

from __future__ import annotations

import functools
import os
import random
from typing import Callable, Dict, Optional, Tuple

ASSETS_DIR = os.environ.get("PSO_PROMPT_ASSETS", "")

_SIMPLE_ANIMALS = [
    "cat", "dog", "horse", "monkey", "rabbit", "zebra", "spider", "bird",
    "sheep", "deer", "cow", "goat", "lion", "tiger", "bear", "raccoon",
    "fox", "wolf", "lizard", "beetle", "ant", "butterfly", "fish", "shark",
    "whale", "dolphin", "squirrel", "mouse", "rat", "snake", "turtle",
    "frog", "chicken", "duck", "goose", "bee", "pig", "turkey", "fly",
    "llama", "camel", "bat", "gorilla", "hedgehog", "kangaroo",
]


@functools.cache
def _load_lines(path: str) -> tuple:
    if not os.path.exists(path) and ASSETS_DIR:
        path = os.path.join(ASSETS_DIR, path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"prompt asset not found: {path}")
    with open(path) as f:
        return tuple(line.strip() for line in f if line.strip())


def from_file(path: str, low: Optional[int] = None, high: Optional[int] = None):
    return random.choice(_load_lines(path)[low:high]), {}


def simple_animals() -> Tuple[str, dict]:
    return random.choice(_SIMPLE_ANIMALS), {}


def imagenet_all():
    return from_file("imagenet_classes.txt")


def imagenet_animals():
    return from_file("imagenet_classes.txt", 0, 398)


def imagenet_dogs():
    return from_file("imagenet_classes.txt", 151, 269)


def anything_prompt():
    return from_file("anything_prompt.txt")


PROMPT_FNS: Dict[str, Callable] = {
    "simple_animals": simple_animals,
    "imagenet_all": imagenet_all,
    "imagenet_animals": imagenet_animals,
    "imagenet_dogs": imagenet_dogs,
    "anything_prompt": anything_prompt,
    "from_file": from_file,
}


def get_prompt_fn(name: str) -> Callable:
    if name not in PROMPT_FNS:
        raise KeyError(f"unknown prompt fn '{name}'; have {sorted(PROMPT_FNS)}")
    return PROMPT_FNS[name]
