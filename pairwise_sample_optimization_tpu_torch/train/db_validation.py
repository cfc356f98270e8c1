"""DreamBooth validation: the fixed suite of 25 prompts.

Counterpart of the JAX package's ``train/db_validation.py``: 25 prompts
built from the unique token and the class name (the object list or the
live-subject list), ``num_images_per_prompt`` 4-step images each with the
live adapter, written as ``<output_dir>/gen_<step>/p_{i:03d}/img_{j:02d}.png``
(i from 1, j from 1) by the port's PNG writer. The images of prompt i come
from one ``torch.Generator`` seeded from (seed, i).
"""

from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch

from ..utils.png import save_pngs

_SHARED = [
    "a {0} {1} in the jungle",
    "a {0} {1} in the snow",
    "a {0} {1} on the beach",
    "a {0} {1} on a cobblestone street",
    "a {0} {1} on top of pink fabric",
    "a {0} {1} on top of a wooden floor",
    "a {0} {1} with a city in the background",
    "a {0} {1} with a mountain in the background",
    "a {0} {1} with a blue house in the background",
    "a {0} {1} on top of a purple rug in a forest",
]
_OBJECT_ONLY = [
    "a {0} {1} with a wheat field in the background",
    "a {0} {1} with a tree and autumn leaves in the background",
    "a {0} {1} with the Eiffel Tower in the background",
    "a {0} {1} floating on top of water",
    "a {0} {1} floating in an ocean of milk",
    "a {0} {1} on top of green grass with sunflowers around it",
    "a {0} {1} on top of a mirror",
    "a {0} {1} on top of the sidewalk in a crowded street",
    "a {0} {1} on top of a dirt road",
    "a {0} {1} on top of a white rug",
]
_SUBJECT_ONLY = [
    "a {0} {1} wearing a red hat",
    "a {0} {1} wearing a santa hat",
    "a {0} {1} wearing a rainbow scarf",
    "a {0} {1} wearing a black top hat and a monocle",
    "a {0} {1} in a chef outfit",
    "a {0} {1} in a firefighter outfit",
    "a {0} {1} in a police outfit",
    "a {0} {1} wearing pink glasses",
    "a {0} {1} wearing a yellow shirt",
    "a {0} {1} in a purple wizard outfit",
]
_TAIL = [
    "a red {0} {1}",
    "a purple {0} {1}",
    "a shiny {0} {1}",
    "a wet {0} {1}",
    "a cube shaped {0} {1}",
]


def dreambooth_validation_prompts(unique_token: str, class_name: str,
                                  is_object: bool) -> List[str]:
    """The 25 fixed validation prompts: 10 shared, 10 of the object or the
    live-subject list, 5 more."""
    mid = _OBJECT_ONLY if is_object else _SUBJECT_ONLY
    return [t.format(unique_token, class_name) for t in _SHARED + mid + _TAIL]


def prompt_seed(seed: int, prompt_index: int) -> int:
    """The seed of prompt ``prompt_index``'s generator."""
    return int(np.random.SeedSequence([seed, prompt_index]).generate_state(1)[0])


@torch.no_grad()
def run_dreambooth_validation(generate_fn: Callable[[str, torch.Generator, int], torch.Tensor],
                              prompts: List[str], output_dir: str, global_step: int,
                              num_images_per_prompt: int = 4, seed: int = 0,
                              device="cpu") -> str:
    """Generate and save the validation images; returns ``gen_<step>``.
    ``generate_fn(prompt, generator, n)`` -> (n, H, W, 3) images in [-1, 1]."""
    root = os.path.join(output_dir, f"gen_{global_step}")
    os.makedirs(root, exist_ok=True)
    for p_idx, prompt in enumerate(prompts, start=1):
        gen = torch.Generator(device=device).manual_seed(prompt_seed(seed, p_idx))
        images = generate_fn(prompt, gen, num_images_per_prompt)
        save_pngs(images, os.path.join(root, f"p_{p_idx:03d}"), name="img_{i:02d}.png", first=1)
    return root
