"""Carry weights into the port: from released torch checkpoints, and from
the JAX package's param trees.

``load_torch_state_dict`` reads a ``.safetensors`` (through the port's own
reader), ``.bin`` or ``.pt`` file, or an HF snapshot directory, into torch
tensors; ``load_weights`` puts such a state dict into a module whose keys it
names (the port's modules carry the diffusers/HF keys, so no name map).

``state_dict_from_jax`` takes a flax param tree as nested dicts of numpy
arrays (optionally with its ``lora`` collection) and returns the port's
``state_dict`` for one tower, through the port's own copy of the name maps.
Layout changes: a linear kernel (in, out) becomes a weight (out, in); a
conv kernel (kh, kw, in, out) becomes (out, in, kh, kw). LoRA leaves
``a`` (in, r) and ``b`` (r, out) become ``<site>.lora.down.weight`` (r, in)
and ``<site>.lora.up.weight`` (out, r), the diffusers LoRA layout, and a DoRA
``magnitude`` (out,) becomes ``<site>.lora.magnitude``; the UNet's and the
CLIP text towers' adapters alike.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .safetensors_io import load_file
from .torch_names import (
    clip_text_param_map,
    clip_vision_param_map,
    sequential_mlp_param_map,
    unet_param_map,
    vae_param_map,
)

_LORA_SUFFIX = {"a": "lora.down.weight", "b": "lora.up.weight", "magnitude": "lora.magnitude"}
_WEIGHT_FILES = (".safetensors", ".bin", ".pt")


def load_torch_state_dict(path: str, device=None) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` or torch ``.bin`` / ``.pt`` file -> {key: tensor}
    in its stored dtype (bf16 included), on ``device`` (default the CPU).

    A directory (an HF snapshot) gives its ``model.safetensors``, else its
    ``pytorch_model.bin``, else its first weight file in name order. A
    ``.bin`` / ``.pt`` file is read with ``torch.load(weights_only=True)``
    and a ``state_dict`` entry unwrapped."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        for preferred in ("model.safetensors", "pytorch_model.bin"):
            if preferred in names:
                path = os.path.join(path, preferred)
                break
        else:
            found = [n for n in names if n.endswith(_WEIGHT_FILES)]
            if not found:
                raise FileNotFoundError(f"no weight files in {path}")
            path = os.path.join(path, found[0])
    if path.endswith(".safetensors"):
        return load_file(path, device)
    sd = torch.load(path, map_location=device or "cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def tower_weight_file(path: str):
    """The weight file of a diffusers tower folder: its first ``.safetensors``
    or ``.bin`` file in name order (a diffusers ``fp16`` variant sorts before
    the full-precision file), None when there is none; a file path is
    returned as it is."""
    if not os.path.isdir(path):
        return path if os.path.isfile(path) else None
    found = [n for n in sorted(os.listdir(path)) if n.endswith((".safetensors", ".bin"))]
    return os.path.join(path, found[0]) if found else None


def load_weights(module: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> List[str]:
    """Copy ``sd`` into ``module`` (cast to each parameter's dtype and
    device), strictly: every key of the module but its LoRA adapter's must
    be in ``sd`` with its shape. The adapter (LoRA and DoRA magnitudes) keeps
    its values. Returns the
    keys of ``sd`` the module has no place for (read past, as the JAX
    package's ``torch_to_flax`` reports them)."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and ".lora." not in k]
    if missing:
        raise KeyError(f"{len(missing)} weights missing from the checkpoint, e.g. {missing[:5]}")
    module.load_state_dict({k: sd[k] if ".lora." not in k else v for k, v in own.items()},
                           strict=True)
    return sorted(k for k in sd if k not in own)


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
    ``lora``. ``n_levels`` is the UNet's number of resolution levels (3 for
    SDXL). ``which`` names the tower:
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
        key, kind = name_map(path)
        out[key] = torch.from_numpy(np.array(_to_torch(arr, kind), order="C"))
    for path, arr in _leaves(lora or {}):
        site, leaf = path[:-1], path[-1]
        key, _ = name_map(site + ("kernel",))
        key = key[: -len("weight")] + _LORA_SUFFIX[leaf]
        out[key] = torch.from_numpy(np.array(arr.T, order="C"))
    return out
