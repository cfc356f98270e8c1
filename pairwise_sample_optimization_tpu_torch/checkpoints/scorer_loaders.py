"""Released weights of the non-PickScore scorers.

Counterpart of the JAX package's ``checkpoints/scorer_loaders.py``:

- the LAION aesthetic predictor's MLP (``sac+logos+ava1-l14-linearMSE.pth``,
  a bare ``nn.Sequential`` state dict, ``layers.{0,2,4,6,7}.{weight,bias}``)
  and its image tower, the vision half of an HF ``CLIPModel``
  (openai/clip-vit-large-patch14);
- ImageReward-v1.0 (one ``.pt``): ``blip.visual_encoder.*`` (a timm
  ViT-L/16), ``blip.text_encoder.*`` (BLIP's BERT, with or without a
  ``bert.`` level) and ``mlp.layers.*``.

The port's modules carry these keys, so each loads without a name map
(``convert.load_weights``: strict on the module's keys, the checkpoint's
other keys read past). HPS is an open_clip CLIP dict:
``clip_loader.load_clip_dual``.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

from .convert import load_torch_state_dict, load_weights

StateDict = Mapping[str, torch.Tensor]


def _state_dict(path_or_sd: Union[str, StateDict]) -> dict:
    return load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)


def load_aesthetic_mlp(path_or_sd: Union[str, StateDict], mlp):
    """Load the released aesthetic-MLP weights (a ``.pth`` path, read with
    ``torch.load(weights_only=True)``, or a state dict) into ``mlp``
    (``rewards.aesthetic.AestheticMLP``), strictly; returns ``mlp``."""
    sd = (torch.load(path_or_sd, map_location="cpu", weights_only=True)
          if isinstance(path_or_sd, str) else path_or_sd)
    mlp.load_state_dict(sd, strict=True)
    return mlp


def load_clip_vision(path_or_sd: Union[str, StateDict], tower):
    """An HF ``CLIPModel`` or ``CLIPVisionModelWithProjection`` state dict (a
    file, an HF snapshot directory or a dict) -> ``tower``
    (``models.clip.CLIPVisionTower``: ``vision_model.*`` and
    ``visual_projection``); the text half is read past. Returns ``tower``."""
    load_weights(tower, _state_dict(path_or_sd))
    return tower


def _subdict(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_imagereward(path_or_sd: Union[str, StateDict], scorer):
    """ImageReward-v1.0 checkpoint -> ``scorer``'s ViT, BERT and MLP
    (``rewards.imagereward.ImageRewardScorer``); returns ``scorer``.

    Row 0 of ``token_type_embeddings`` is folded into the position
    embeddings: text token types are all 0, and the sum is LayerNormed, so
    this is exact."""
    sd = _state_dict(path_or_sd)
    bert_sd = _subdict(sd, "blip.text_encoder.")
    if not any(k.startswith("embeddings.") for k in bert_sd):  # BLIP's ``bert.`` level
        bert_sd = _subdict(bert_sd, "bert.")
    token_type = bert_sd.pop("embeddings.token_type_embeddings.weight")
    pos = bert_sd["embeddings.position_embeddings.weight"]
    bert_sd["embeddings.position_embeddings.weight"] = pos + token_type[0][None, :].to(pos.dtype)
    load_weights(scorer.vit, _subdict(sd, "blip.visual_encoder."))
    load_weights(scorer.bert, bert_sd)
    load_weights(scorer.mlp, _subdict(sd, "mlp."))
    return scorer
