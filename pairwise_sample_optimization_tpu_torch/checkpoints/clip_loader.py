"""CLIP dual-encoder checkpoints (PickScore, CLIP score, HPS) into the port's
``CLIPDualEncoder``.

Counterpart of the JAX package's ``checkpoints/clip_loader.py``. Two
layouts reach the CLIP-H scorers:

- HF ``CLIPModel`` state dicts (``text_model.*``, ``vision_model.*``,
  ``text_projection``, ``visual_projection``, ``logit_scale``): PickScore_v1
  and laion CLIP-H ship this way, and they are the port's own keys;
- open_clip state dicts (``visual.*``, ``transformer.resblocks.*``,
  ``token_embedding``, ``positional_embedding``, ``ln_final``, a fused
  ``attn.in_proj_*``, raw ``x @ P`` projection matrices, usually under a
  ``state_dict`` entry): ``HPS_v2_compressed.pt`` ships this way.

``load_clip_dual`` detects the layout, converts open_clip to HF (the fused
q/k/v split, the raw projections transposed into Linear layout) and loads
strictly; keys the model has no place for (the ``position_ids`` buffers some
HF files carry) are read past.
"""

from __future__ import annotations

import re
from typing import Mapping, Union

import torch

from .convert import load_torch_state_dict, load_weights


def _convert_block(sd, out, src: str, dst: str) -> None:
    """One transformer resblock: open_clip -> HF ``CLIPEncoderLayer`` keys."""
    for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                 ("attn.out_proj", "self_attn.out_proj"), ("mlp.c_fc", "mlp.fc1"),
                 ("mlp.c_proj", "mlp.fc2")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{b}.{leaf}"] = sd[f"{src}.{a}.{leaf}"]
    # the fused projection's rows are [q | k | v]
    w, b = sd[f"{src}.attn.in_proj_weight"], sd[f"{src}.attn.in_proj_bias"]
    d = w.shape[0] // 3
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{dst}.self_attn.{name}.weight"] = w[i * d:(i + 1) * d]
        out[f"{dst}.self_attn.{name}.bias"] = b[i * d:(i + 1) * d]


def is_openclip_format(sd: Mapping) -> bool:
    return "visual.conv1.weight" in sd or "visual.class_embedding" in sd


def openclip_to_hf_clip(sd: Mapping[str, torch.Tensor]) -> dict:
    """open_clip CLIP state dict -> HF ``CLIPModel`` layout: the raw
    projections (used as ``x @ P``) become Linear weights ``P.T``, the fused
    ``in_proj`` splits into q / k / v, the rest is renamed one to one."""
    out = {
        "logit_scale": sd["logit_scale"],
        "text_model.embeddings.token_embedding.weight": sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight": sd["positional_embedding"],
        "text_model.final_layer_norm.weight": sd["ln_final.weight"],
        "text_model.final_layer_norm.bias": sd["ln_final.bias"],
        "text_projection.weight": sd["text_projection"].T.contiguous(),
        "vision_model.embeddings.patch_embedding.weight": sd["visual.conv1.weight"],
        "vision_model.embeddings.class_embedding": sd["visual.class_embedding"],
        "vision_model.embeddings.position_embedding.weight": sd["visual.positional_embedding"],
        "vision_model.pre_layrnorm.weight": sd["visual.ln_pre.weight"],
        "vision_model.pre_layrnorm.bias": sd["visual.ln_pre.bias"],
        "vision_model.post_layernorm.weight": sd["visual.ln_post.weight"],
        "vision_model.post_layernorm.bias": sd["visual.ln_post.bias"],
        "visual_projection.weight": sd["visual.proj"].T.contiguous(),
    }
    for key in sd:
        m = re.fullmatch(r"(visual\.)?transformer\.resblocks\.(\d+)\.ln_1\.weight", key)
        if m:
            tower = "vision_model" if m.group(1) else "text_model"
            _convert_block(sd, out, key[:-len(".ln_1.weight")],
                           f"{tower}.encoder.layers.{m.group(2)}")
    return out


def load_clip_dual(path_or_sd: Union[str, Mapping[str, torch.Tensor]], model):
    """Load an HF ``CLIPModel`` or open_clip state dict (a weight file, an HF
    snapshot directory or a dict) into ``model`` (``models.clip.
    CLIPDualEncoder``), strictly; returns ``model``."""
    sd = (load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else dict(path_or_sd))
    if is_openclip_format(sd):
        sd = openclip_to_hf_clip(sd)
    load_weights(model, sd)
    return model
