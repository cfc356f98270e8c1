"""Carry weights from the JAX package's param trees into the port.

``state_dict_from_jax`` takes a flax param tree as nested dicts of numpy
arrays (optionally with its ``lora`` collection) and returns the port's
``state_dict`` for one tower, through the port's own copy of the name maps.
Layout changes: a linear kernel (in, out) becomes a weight (out, in); a
conv kernel (kh, kw, in, out) becomes (out, in, kh, kw). LoRA leaves
``a`` (in, r) and ``b`` (r, out) become ``<site>.lora.down.weight`` (r, in)
and ``<site>.lora.up.weight`` (out, r), the diffusers LoRA layout.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .torch_names import (
    clip_text_param_map,
    clip_vision_param_map,
    sequential_mlp_param_map,
    unet_param_map,
    vae_param_map,
)

_LORA_SUFFIX = {"a": "lora.down.weight", "b": "lora.up.weight"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _to_torch(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "?":
        kind = "conv" if arr.ndim == 4 else "linear"
    if kind == "linear":
        return arr.T
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    return arr


def _name_map(which: str, n_levels: int | None):
    if which == "unet":
        return functools.partial(unet_param_map, n_levels=n_levels or 3)
    if which == "vae":
        return vae_param_map
    if which == "clip_text":
        return clip_text_param_map
    if which == "clip_vision":
        return clip_vision_param_map
    if which == "aesthetic_mlp":
        return sequential_mlp_param_map
    raise ValueError("which must be unet|vae|clip_text|clip_vision|clip_dual|aesthetic_mlp, "
                     f"got {which!r}")


def state_dict_from_jax(params: Mapping, which: str, n_levels: int | None = None,
                        lora: Mapping | None = None) -> Dict[str, torch.Tensor]:
    """flax params (+ ``lora`` collection) -> the port's state dict (fp32 as
    given). ``params`` may also be a variables dict holding ``params`` and
    ``lora``. For ``which="vae"`` only the decoder and ``post_quant_conv``
    are carried (the port has no encoder yet). ``n_levels`` is the UNet's
    number of resolution levels (3 for SDXL). ``which`` names the tower:
    ``clip_vision`` serves any ``CLIPVisionTower`` (the aesthetic scorer's
    CLIP-L/14 too), ``clip_dual`` a ``CLIPDualEncoder`` (PickScore, CLIP
    score, HPS: its ``text`` and ``vision`` subtrees and ``logit_scale``),
    ``aesthetic_mlp`` the ``AestheticMLP``."""
    if "params" in params:
        lora = params.get("lora", lora)
        params = params["params"]
    if which == "clip_dual":
        return {**state_dict_from_jax(params["text"], "clip_text"),
                **state_dict_from_jax(params["vision"], "clip_vision"),
                "logit_scale": torch.tensor(np.asarray(params["logit_scale"]))}
    name_map = _name_map(which, n_levels)
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        if which == "vae" and path[0] in ("encoder", "quant_conv"):
            continue
        key, kind = name_map(path)
        out[key] = torch.from_numpy(np.array(_to_torch(arr, kind), order="C"))
    for path, arr in _leaves(lora or {}):
        site, leaf = path[:-1], path[-1]
        key, _ = name_map(site + ("kernel",))
        key = key[: -len("weight")] + _LORA_SUFFIX[leaf]
        out[key] = torch.from_numpy(np.array(arr.T, order="C"))
    return out
