"""Flax param path -> diffusers/HF state-dict key, for the port's towers.

The port's own copy of the name maps of the JAX package's
``checkpoints/torch_names.py`` (UNet, VAE, CLIP text, CLIP vision, the
aesthetic scorer's sequential MLP). Each map returns (key, kind); kind is
``"?"`` for a flax ``kernel`` (linear or conv, resolved by rank) or
``"direct"``.
"""

from __future__ import annotations

import re
from typing import Tuple


def _unet_module(path0: str, n_levels: int) -> str:
    m = re.fullmatch(r"down_(\d+)_resnet_(\d+)", path0)
    if m:
        return f"down_blocks.{m.group(1)}.resnets.{m.group(2)}"
    m = re.fullmatch(r"down_(\d+)_attn_(\d+)", path0)
    if m:
        return f"down_blocks.{m.group(1)}.attentions.{m.group(2)}"
    m = re.fullmatch(r"down_(\d+)_downsample", path0)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0"
    m = re.fullmatch(r"up_(\d+)_resnet_(\d+)", path0)
    if m:
        return f"up_blocks.{n_levels - 1 - int(m.group(1))}.resnets.{m.group(2)}"
    m = re.fullmatch(r"up_(\d+)_attn_(\d+)", path0)
    if m:
        return f"up_blocks.{n_levels - 1 - int(m.group(1))}.attentions.{m.group(2)}"
    m = re.fullmatch(r"up_(\d+)_upsample", path0)
    if m:
        return f"up_blocks.{n_levels - 1 - int(m.group(1))}.upsamplers.0"
    m = re.fullmatch(r"mid_resnet_(\d+)", path0)
    if m:
        return f"mid_block.resnets.{m.group(1)}"
    if path0 == "mid_attn":
        return "mid_block.attentions.0"
    return path0  # conv_in / conv_out / conv_norm_out / time_embedding / add_embedding


def _leaf(leaf: str, parent: str) -> Tuple[str, str]:
    if leaf == "kernel":
        return "weight", "?"
    if leaf in ("scale", "embedding"):
        return "weight", "direct"
    if leaf == "bias":
        return "bias", "direct"
    raise KeyError(f"unknown leaf {leaf!r} under {parent!r}")


def _inner(parts: Tuple[str, ...]) -> str:
    out = []
    for p in parts:
        m = re.fullmatch(r"block_(\d+)", p)
        if m:
            out.append(f"transformer_blocks.{m.group(1)}")
        elif p == "to_out":
            out.append("to_out.0")
        else:
            out.append(p)
    s = ".".join(out)
    return s.replace("ff.proj_in", "ff.net.0.proj").replace("ff.proj_out", "ff.net.2")


def unet_param_map(path: Tuple[str, ...], n_levels: int = 3) -> Tuple[str, str]:
    *mods, leaf = path
    head = _unet_module(mods[0], n_levels)
    rest = _inner(tuple(mods[1:]))
    suffix, kind = _leaf(leaf, path[-2] if len(path) > 1 else "")
    return ".".join(x for x in (head, rest) if x) + "." + suffix, kind


def _vae_block(path0: str) -> str:
    m = re.fullmatch(r"down_(\d+)_resnet_(\d+)", path0)
    if m:
        return f"down_blocks.{m.group(1)}.resnets.{m.group(2)}"
    m = re.fullmatch(r"down_(\d+)_downsample", path0)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0"
    m = re.fullmatch(r"up_(\d+)_resnet_(\d+)", path0)
    if m:
        return f"up_blocks.{m.group(1)}.resnets.{m.group(2)}"
    m = re.fullmatch(r"up_(\d+)_upsample", path0)
    if m:
        return f"up_blocks.{m.group(1)}.upsamplers.0"
    m = re.fullmatch(r"mid_resnet_(\d+)", path0)
    if m:
        return f"mid_block.resnets.{m.group(1)}"
    if path0 == "mid_attn":
        return "mid_block.attentions.0"
    return path0


def vae_param_map(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Encoder, quant_conv, post_quant_conv and decoder paths."""
    *mods, leaf = path
    if mods[0] in ("quant_conv", "post_quant_conv"):
        head, rest = mods[0], _inner(tuple(mods[1:]))
    elif mods[0] in ("encoder", "decoder"):
        head, rest = mods[0] + "." + _vae_block(mods[1]), _inner(tuple(mods[2:]))
    else:
        raise KeyError(f"VAE module {mods[0]!r} is not part of the port")
    suffix, kind = _leaf(leaf, path[-2] if len(path) > 1 else "")
    return ".".join(x for x in (head, rest) if x) + "." + suffix, kind


_CLIP_LAYER = {
    "norm1": "layer_norm1",
    "norm2": "layer_norm2",
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "out_proj": "self_attn.out_proj",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}
_CLIP_TEXT = {
    "token_embedding": "text_model.embeddings.token_embedding",
    "final_norm": "text_model.final_layer_norm",
    "text_projection": "text_projection",
}
_CLIP_VISION = {
    "patch_embedding": "vision_model.embeddings.patch_embedding",
    "pre_norm": "vision_model.pre_layrnorm",  # (sic) HF key
    "post_norm": "vision_model.post_layernorm",
    "visual_projection": "visual_projection",
}


def clip_text_param_map(path: Tuple[str, ...]) -> Tuple[str, str]:
    if path == ("position_embedding",):
        return "text_model.embeddings.position_embedding.weight", "direct"
    *mods, leaf = path
    m = re.fullmatch(r"layer_(\d+)", mods[0])
    if m:
        head = f"text_model.encoder.layers.{m.group(1)}." + _CLIP_LAYER[mods[1]]
    else:
        head = _CLIP_TEXT[mods[0]]
    suffix, kind = _leaf(leaf, mods[-1])
    return head + "." + suffix, kind


def clip_vision_param_map(path: Tuple[str, ...]) -> Tuple[str, str]:
    if path == ("class_embedding",):
        return "vision_model.embeddings.class_embedding", "direct"
    if path == ("position_embedding",):
        return "vision_model.embeddings.position_embedding.weight", "direct"
    *mods, leaf = path
    m = re.fullmatch(r"layer_(\d+)", mods[0])
    if m:
        head = f"vision_model.encoder.layers.{m.group(1)}." + _CLIP_LAYER[mods[1]]
    else:
        head = _CLIP_VISION[mods[0]]
    suffix, kind = _leaf(leaf, mods[-1])
    return head + "." + suffix, kind


def sequential_mlp_param_map(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax ``fc{i}`` of the 5-layer aesthetic MLP -> ``layers.{0,2,4,6,7}``,
    the released ``nn.Sequential``'s Linear slots (dropouts between)."""
    mod, leaf = path
    m = re.fullmatch(r"fc(\d)", mod)
    if not m:
        raise KeyError(f"unexpected MLP module {mod!r}")
    suffix, kind = _leaf(leaf, mod)
    return f"layers.{(0, 2, 4, 6, 7)[int(m.group(1))]}.{suffix}", kind
