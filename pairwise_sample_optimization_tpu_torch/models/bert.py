"""BERT encoder with cross-attention to image tokens (the BLIP "med" text
encoder of ImageReward).

Counterpart of the JAX package's ``models/bert.py``: post-LN layers of
self-attention, cross-attention to the image tokens and a GELU FFN,
LayerNorm eps 1e-12; only the encoder path ImageReward uses. Its
``state_dict`` keys are HF ``BertModel``'s with BLIP's per-layer
``crossattention`` (``embeddings.word_embeddings``,
``embeddings.position_embeddings``, ``embeddings.LayerNorm``,
``encoder.layer.{i}.(attention|crossattention).self.(query|key|value)``,
``...output.dense``, ``...output.LayerNorm``, ``intermediate.dense``,
``output.dense``, ``output.LayerNorm``). The released
``token_type_embeddings`` have no place here: text token types are all 0,
so ``checkpoints.scorer_loaders.load_imagereward`` folds row 0 into the
position embeddings (exact: the sum is LayerNormed).

Self-attention with a padding mask is the plain matmul-softmax-matmul with
an fp32 softmax, as in the JAX package (no Pallas kernel there either);
attention without a mask, the cross-attention to the image tokens, takes
the flash-attention kernel. GELU is exact in fp32 and tanh in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .layers import gelu_approximate


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524  # bert-base and BLIP's special tokens
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    cross_attention: bool = True
    encoder_width: int = 1024  # width of the image tokens the cross-attention reads
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def blip_base(dtype=torch.bfloat16) -> "BertConfig":
        return BertConfig(dtype=dtype)

    @staticmethod
    def tiny(dtype=torch.float32) -> "BertConfig":
        return BertConfig(vocab_size=1000, hidden=32, layers=2, heads=4, intermediate=64,
                          max_positions=64, encoder_width=32, dtype=dtype)


def masked_attention(q, k, v, mask):
    """(B, S, H, D) attention over the keys where ``mask`` (B, S_kv) is true;
    logits in the input dtype, fp32 softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = logits + torch.where(mask[:, None, None, :], 0.0, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class _SelfOrCross(nn.Module):
    def __init__(self, cfg: BertConfig, kv_width: int):
        super().__init__()
        self.query = nn.Linear(cfg.hidden, cfg.hidden, dtype=cfg.dtype)
        self.key = nn.Linear(kv_width, cfg.hidden, dtype=cfg.dtype)
        self.value = nn.Linear(kv_width, cfg.hidden, dtype=cfg.dtype)


class _Output(nn.Module):
    def __init__(self, cfg: BertConfig, in_width: int):
        super().__init__()
        self.dense = nn.Linear(in_width, cfg.hidden, dtype=cfg.dtype)
        self.LayerNorm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps, dtype=cfg.dtype)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    """Post-LN attention block: LayerNorm(x + out(attention(x, context)))."""

    def __init__(self, cfg: BertConfig, kv_width: int):
        super().__init__()
        self.heads = cfg.heads
        self.self = _SelfOrCross(cfg, kv_width)
        self.output = _Output(cfg, cfg.hidden)

    def forward(self, x, context=None, mask=None):
        kv = x if context is None else context
        b, sq, w = x.shape
        split = lambda t: t.view(b, t.shape[1], self.heads, w // self.heads)
        q, k, v = split(self.self.query(x)), split(self.self.key(kv)), split(self.self.value(kv))
        o = dot_product_attention(q, k, v) if mask is None else masked_attention(q, k, v, mask)
        return self.output(o.reshape(b, sq, w), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden, cfg.intermediate, dtype=cfg.dtype)

    def forward(self, x):
        h = self.dense(x)
        return F.gelu(h, approximate=gelu_approximate(h.dtype))


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg, cfg.hidden)
        if cfg.cross_attention:
            self.crossattention = _Attention(cfg, cfg.encoder_width)
        self.intermediate = _Intermediate(cfg)
        self.output = _Output(cfg, cfg.intermediate)

    def forward(self, x, context=None, mask=None):
        x = self.attention(x, mask=mask)
        if context is not None and hasattr(self, "crossattention"):
            x = self.crossattention(x, context=context)
        return self.output(self.intermediate(x), x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden, dtype=cfg.dtype)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.hidden, dtype=cfg.dtype)
        self.LayerNorm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps, dtype=cfg.dtype)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        return self.LayerNorm(self.word_embeddings(input_ids)
                              + self.position_embeddings.weight[None, :s])


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([_Layer(cfg) for _ in range(cfg.layers)])


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.embeddings = _Embeddings(config)
            self.encoder = _Encoder(config)

    def forward(self, input_ids, attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None):
        """input_ids (B, S); attention_mask (B, S), nonzero where a token is
        real; encoder_hidden_states (B, S_img, encoder_width) -> (B, S, hidden)."""
        x = self.embeddings(input_ids)
        mask = attention_mask.bool() if attention_mask is not None else None
        context = (encoder_hidden_states.to(x.dtype) if encoder_hidden_states is not None
                   else None)
        for layer in self.encoder.layer:
            x = layer(x, context, mask)
        return x
