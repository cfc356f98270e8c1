"""SDXL dual text encoding.

Each encoder contributes its penultimate hidden state, concatenated on the
feature axis (768 + 1280 = 2048); the pooled vector is the second
encoder's projected pooled output (1280). ``compute_time_ids`` packs
(original_size, crop_top_left, target_size) into the six SDXL
micro-conditioning ids; ``time_ids_from_records`` makes them per image from
a dataset's recorded sizes and crops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .clip import CLIPTextTower


def encode_sdxl_prompt(
    te1: CLIPTextTower,
    te2: CLIPTextTower,
    input_ids_one: torch.Tensor,
    input_ids_two: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (prompt_embeds (B, 77, 2048), pooled_prompt_embeds (B, 1280))."""
    out1 = te1(input_ids_one)
    out2 = te2(input_ids_two)
    if out2["projected"] is None:
        raise ValueError("text encoder 2 must have a projection head")
    return torch.cat([out1["penultimate"], out2["penultimate"]], dim=-1), out2["projected"]


def compute_time_ids(batch: int, original_size: int = 512, crops_coords_top_left: int = 0,
                     target_size: int | None = None, device="cpu") -> torch.Tensor:
    """(B, 6) add_time_ids = (orig_h, orig_w, crop_top, crop_left, tgt_h, tgt_w)."""
    target_size = target_size if target_size is not None else original_size
    row = torch.tensor([original_size, original_size, crops_coords_top_left,
                        crops_coords_top_left, target_size, target_size],
                       dtype=torch.float32, device=device)
    return row[None].repeat(batch, 1)


def time_ids_from_records(original_sizes, crop_top_lefts, target_size: int,
                          device="cpu") -> torch.Tensor:
    """(N, 6) fp32 add_time_ids, one row per image from a dataset's records:
    (orig_h, orig_w, crop_top, crop_left, target_size, target_size).
    ``original_sizes`` / ``crop_top_lefts`` are sequences of (h, w) /
    (top, left), the micro-conditioning a DreamBooth dataset records per
    augmentation view."""
    rows = [(oh, ow, ct, cl, target_size, target_size)
            for (oh, ow), (ct, cl) in zip(original_sizes, crop_top_lefts)]
    return torch.tensor(rows, dtype=torch.float32, device=device).reshape(-1, 6)
