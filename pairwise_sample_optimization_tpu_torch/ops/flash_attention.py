"""Flash attention: the CUDA kernels ``csrc/flash_attn_fwd.cu`` (forward)
and ``csrc/flash_attn_bwd.cu`` (backward), their plain PyTorch versions,
and the autograd Function that joins them.

Counterpart of the JAX package's ``ops/flash_attention.py``: the forward
``_fwd_kernel`` (K1) and the two backward kernels ``_bwd_dkv_kernel`` (K2)
and ``_bwd_dq_kernel`` (K3), which recompute the probabilities from the
forward's fp32 logsumexp. Layout (B, S, H, D) at the public functions, as
there; the kernels read the caller's strides directly, so no fold,
transpose or padding to 128 happens on the host, and keys past the kv
length are masked in the kernels.

A CPU tensor takes the plain versions; a CUDA tensor takes the kernels or
raises. :class:`FlashAttentionFunction` runs the forward (K1) and saves
q, k, v, o and the logsumexp; its backward computes Di = rowsum(O * dO)
with torch ops, as the JAX package does outside Pallas, then runs K2 and
K3 (head dim 64 only, the UNet's).
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
_BWD_SIGNATURES = {
    "flash_attn_bwd_dkv": [_I, _I] + [_P] * 8 + [_LL] * 18 + [_I, _I, _I, _I, _F, _P],
    "flash_attn_bwd_dq": [_I, _I] + [_P] * 7 + [_LL] * 15 + [_I, _I, _I, _I, _F, _P],
}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 80, 512)
BWD_HEAD_DIMS = (64,)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """(B, Sq, H, D), (B, Skv, H, D) -> (o (B, Sq, H, D) in q's dtype,
    lse (B, H, Sq) fp32), computed in fp32."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def attention_di(o, do):
    """Di = rowsum(O * dO) in fp32, (B, Sq, H, D) -> (B, H, Sq) contiguous."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: Optional[float] = None):
    """K2 and K3's plain version: the same recompute-from-LSE backward, step
    by step in fp32 -> (dq, dk, dv) in the dtypes of q, k, v."""
    scale = _scale(q, scale)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_di(o, do)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, head_dims=HEAD_DIMS, what="flash_attn_fwd"):
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what} takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} of q {tuple(q.shape)} not in {head_dims}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q/k/v must share one CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _takes_layout(t):
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows, "
                             f"got strides {t.stride()}")


def _takes_layout(t) -> bool:
    """A (B, S, H, D) view the kernels read as it is: contiguous last dim,
    16-byte aligned rows."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _strides(*tensors):
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention_fwd(q, k, v, scale: Optional[float] = None):
    """Non-causal attention -> (o (B, Sq, H, D), lse (B, H, Sq) fp32)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = kernel_lib.load("flash_attn_fwd", _SIGNATURES)
    rc = lib.flash_attn_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_strides(q, k, v, o), b, h, sq, skv, float(scale),
        kernel_lib.stream_ptr(q.device),
    )
    kernel_lib.check(lib, rc, "flash_attn_fwd")
    kernel_lib.launch_counts["flash_attn_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, di):
    _check(q, k, v, BWD_HEAD_DIMS, "flash_attn_bwd")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or (
            not _takes_layout(do)):
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} strides {do.stride()} does not fit "
                         f"q {tuple(q.shape)} {q.dtype}")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != rows or t.dtype != torch.float32 or not t.is_contiguous() or (
                t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (B, H, Sq) = {rows}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_args(q, k, v, do, lse, di, outs, scale):
    b, sq, h, d = q.shape
    return (_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), *[t.data_ptr() for t in outs],
            *_strides(q, k, v, do, *outs), b, h, sq, k.shape[1], float(scale),
            kernel_lib.stream_ptr(q.device))


def flash_attention_bwd_dkv(q, k, v, do, lse, di, scale: Optional[float] = None):
    """K2 on CUDA tensors: (dk, dv) from the forward's ``lse`` and
    ``di = attention_di(o, do)``."""
    _check_bwd(q, k, v, do, lse, di)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), torch.empty_like(
        v, memory_format=torch.contiguous_format)
    lib = kernel_lib.load("flash_attn_bwd", _BWD_SIGNATURES)
    rc = lib.flash_attn_bwd_dkv(*_bwd_args(q, k, v, do, lse, di, (dk, dv), _scale(q, scale)))
    kernel_lib.check(lib, rc, "flash_attn_bwd_dkv")
    kernel_lib.launch_counts["flash_attn_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, scale: Optional[float] = None):
    """K3 on CUDA tensors: dq from the forward's ``lse`` and ``di``."""
    _check_bwd(q, k, v, do, lse, di)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = kernel_lib.load("flash_attn_bwd", _BWD_SIGNATURES)
    rc = lib.flash_attn_bwd_dq(*_bwd_args(q, k, v, do, lse, di, (dq,), _scale(q, scale)))
    kernel_lib.check(lib, rc, "flash_attn_bwd_dq")
    kernel_lib.launch_counts["flash_attn_bwd_dq"] += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of the attention output ``o`` for the
    upstream gradient ``do``, from the forward's ``lse``: Di, then K2 (dK,
    dV) and K3 (dQ) on a CUDA tensor; :func:`flash_attention_bwd_plain` on
    a CPU one. A ``do`` view the kernels cannot read is copied to a
    contiguous tensor first."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if not _takes_layout(do):
        do = do.contiguous()
    di = attention_di(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)
    return flash_attention_bwd_dq(q, k, v, do, lse, di, scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v, scale) -> (o, lse); ``lse`` is not differentiable.

    Forward: :func:`flash_attention_fwd` (K1). Backward:
    :func:`flash_attention_bwd` (K2, K3). On CPU tensors both take their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """(B, S, H, D) non-causal attention; the output only, differentiable
    in q, k and v."""
    return FlashAttentionFunction.apply(q, k, v, _scale(q, scale))[0]
