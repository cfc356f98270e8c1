"""Attention dispatch. All shapes are (B, S, H, D).

Non-causal attention goes through ``flash_attention`` (the CUDA kernel on a
CUDA tensor, its plain version on a CPU one). Causal attention (the CLIP
text towers, 77 tokens) has no TPU kernel to port: it runs the plain
matmul-softmax-matmul with an fp32 softmax, the JAX package's ``naive``
path.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def causal_attention(q, k, v):
    """(B, S, H, D) causal attention; logits in the input dtype, fp32 softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s_q, s_k = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, *, causal: bool = False):
    """(B, S, H, D) attention; fp32 softmax accumulation."""
    if causal:
        return causal_attention(q, k, v)
    return flash_attention(q, k, v)
