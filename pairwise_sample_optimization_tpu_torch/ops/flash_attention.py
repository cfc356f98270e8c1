"""Flash-attention forward: the CUDA kernel ``csrc/flash_attn_fwd.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/flash_attention.py`` forward
(``_fwd_kernel``). Layout (B, S, H, D) at the public function, as there;
the kernel reads the caller's strides directly, so no fold, transpose or
padding to 128 happens on the host, and keys past the kv length are masked
in the kernel.

A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor takes the
kernel or raises. The backward kernels (JAX ``_bwd_dkv_kernel``,
``_bwd_dq_kernel``) are not ported yet, so the CUDA path refuses inputs
that need a gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernel_lib

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attn_fwd": [_I, _I, _P, _P, _P, _P, _P] + [_LL] * 12 + [_I, _I, _I, _I, _F, _P],
}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 80, 512)


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """(B, Sq, H, D), (B, Skv, H, D) -> (o (B, Sq, H, D) in q's dtype,
    lse (B, H, Sq) fp32), computed in fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _check(q, k, v):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q/k/v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attn_fwd takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash-attention backward kernels are not ported yet")


def flash_attention_fwd(q, k, v, scale: Optional[float] = None):
    """Non-causal attention -> (o (B, Sq, H, D), lse (B, H, Sq) fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = kernel_lib.load("flash_attn_fwd", _SIGNATURES)
    strides = [s for t in (q, k, v, o) for s in (t.stride(0), t.stride(1), t.stride(2))]
    rc = lib.flash_attn_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *strides, b, h, sq, skv, float(scale),
        kernel_lib.stream_ptr(q.device),
    )
    kernel_lib.check(lib, rc, "flash_attn_fwd")
    kernel_lib.launch_counts["flash_attn_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """(B, S, H, D) non-causal attention; the output only."""
    return flash_attention_fwd(q, k, v, scale)[0]
