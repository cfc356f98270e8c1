"""Flash attention: the CUDA kernels ``csrc/flash_attn_fwd.cu`` (forward),
``csrc/flash_attn_bwd.cu`` and ``csrc/flash_attn_bwd_fma.cu`` (backward),
their plain PyTorch versions, and the autograd Function that joins them.

Counterpart of the JAX package's ``ops/flash_attention.py``: the forward
``_fwd_kernel`` (K1) and the two backward kernels ``_bwd_dkv_kernel`` (K2)
and ``_bwd_dq_kernel`` (K3), which recompute the probabilities from the
forward's fp32 logsumexp. Layout (B, S, H, D) at the public functions, as
there; the kernels read the caller's strides directly, so no fold,
transpose or padding to 128 happens on the host, and keys past the kv
length are masked in the kernels.

A CPU tensor takes the plain versions; a CUDA tensor takes the kernels or
raises. The forward takes head dims ``HEAD_DIMS``: 64 (the SDXL UNet), 80
(the ViT-H/14 scorers), 512 (the VAE mid-block), 40 and 160 (the SD1.5
UNet's 8 fixed heads over 320 and 1280 channels; 80 over 640).
:class:`FlashAttentionFunction` runs the forward (K1) and saves q, k, v, o
and the logsumexp; its backward takes head dims ``BWD_HEAD_DIMS``. In bf16
it takes three launches: the pre kernel (Di = rowsum(O * dO), the fp32
accumulators zeroed), one kernel that computes dQ, dK and dV (in place of
K2 and K3; dQ summed over blocks of kv rows into an fp32 accumulator) and
the post kernel (the accumulators to bf16). fp32 runs the pre kernel and
the two-kernel path (K2 then K3 as the TPU has them, fp32 arithmetic).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import kernel_lib

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attn_fwd": [_I, _I, _P, _P, _P, _P, _P] + [_LL] * 12 + [_I, _I, _I, _I, _F, _P],
}
_BWD_SIGNATURES = {
    "flash_attn_bwd_pre": [_I, _I] + [_P] * 4 + [_LL] * 7 + [_I, _I, _I, _P],
    "flash_attn_bwd": [_I, _I] + [_P] * 10 + [_LL] * 21 + [_I] * 5 + [_F, _P],
    "flash_attn_bwd_post": [_I] + [_P] * 4 + [_LL] * 9 + [_I] * 6 + [_P],
}
# the two-kernel backward's library: an entry of the same name and signature
_BWD_FMA_SIGNATURES = {"flash_attn_bwd": _BWD_SIGNATURES["flash_attn_bwd"]}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (40, 64, 80, 160, 512)
BWD_HEAD_DIMS = (40, 64, 80, 160)
TILE = 64  # the backward kernels' q and kv tile
# kv rows a block of the bf16 backward kernel by head dim: two warpgroups of 64
# rows, or at 160 two that share 64 rows and split the columns
BWD_KV_ROWS = {40: 128, 64: 128, 80: 128, 160: 64}
BWD_BLOCKS_PER_SM = 1  # its blocks an SM (115-219 KB of shared memory, 256 threads)


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
    """The backward's plain version: the same recompute-from-LSE backward,
    step by step in fp32 -> (dq, dk, dv) in the dtypes of q, k, v."""
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


def _count(name, d):
    kernel_lib.launch_counts[name] += 1
    kernel_lib.head_dim_launches[(name, d)] += 1


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
    _count("flash_attn_fwd", d)
    return o, lse


def _check_bwd(q, k, v, o, do, lse):
    _check(q, k, v, BWD_HEAD_DIMS, "flash_attn_bwd")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or (
                not _takes_layout(t)):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} strides {t.stride()} does not "
                             f"fit q {tuple(q.shape)} {q.dtype}")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    if lse.shape != rows or lse.dtype != torch.float32 or not lse.is_contiguous() or (
            lse.device != q.device):
        raise ValueError(f"lse must be contiguous fp32 (B, H, Sq) = {rows}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_plan(batch_heads: int, sq: int, skv: int, sms: int, d: int = 64) -> tuple[int, int, int]:
    """How the bf16 backward runs at these lengths and head dim ``d`` on a
    card of ``sms`` SMs: (q tiles of ``TILE`` rows a block walks, rows of
    d fp32 values per batch*head of dQ's accumulator, of dK's and of dV's).

    One block runs per (``BWD_KV_ROWS[d]`` kv rows, chunk of q tiles,
    batch*head). A block walks all the q tiles, unless one block per (kv
    rows, batch*head) would leave the card under one wave (the 77-key
    cross-attention has one block of kv rows): then chunks sized for about
    two waves, none empty. dQ is summed over blocks of kv rows in its
    accumulator unless one block holds every key (then written as it is);
    dK and dV have accumulators only where the q loop is split. The post
    kernel runs where any accumulator does."""
    n_q, n_kv = -(-sq // TILE), -(-skv // TILE)
    kv_rows = BWD_KV_ROWS[d]
    blocks, wave = -(-skv // kv_rows) * batch_heads, BWD_BLOCKS_PER_SM * sms
    q_chunk = n_q if blocks >= wave else -(-n_q // min(n_q, -(-2 * wave // blocks)))
    dq_rows = n_q * TILE if skv > kv_rows else 0
    return q_chunk, dq_rows, n_kv * TILE if q_chunk < n_q else 0


def acc_tile_index(d: int):
    """(TILE, d) long: where each element of a 64-row accumulator tile of d
    fp32 columns is stored, as an index into the tile's flat floats
    (``acc_off`` in the source): the tile's 64-column blocks first, each 64
    rows of 256 bytes with 8-column group j of row r at group j ^ (r % 8),
    then its remaining 8-column groups, each 64 rows of 32 bytes."""
    r = torch.arange(TILE)[:, None]
    j, e = torch.arange(d)[None, :] // 8, torch.arange(d)[None, :] % 8
    full = d // 64
    in_block = (j // 8) * TILE * 64 + r * 64 + ((j % 8) ^ (r % 8)) * 8 + e
    in_groups = full * TILE * 64 + (j - 8 * full) * TILE * 8 + r * 8 + e
    return torch.where(j < 8 * full, in_block, in_groups)


def bwd_post_plain(acc, dq, dk, dv, with_q: bool, with_kv: bool):
    """The post kernel's plain version: the fp32 accumulator tiles (64 rows
    of d values, stored as :func:`acc_tile_index` says) written into ``dq``
    (``with_q``) and ``dk``, ``dv`` (``with_kv``), (B, S, H, d) in their
    dtype."""
    b, sq, h, d = dq.shape
    skv = dk.shape[1]
    n_q, n_kv = -(-sq // TILE), -(-skv // TILE)
    place = acc_tile_index(d).to(acc.device).reshape(-1)  # where element (r, c) of a tile is

    def decode(flat, tiles, n, out):
        t = flat.view(b * h, tiles, TILE * d)[:, :, place]
        rows = t.reshape(b, h, tiles * TILE, d)[:, :, :n]
        out.copy_(rows.transpose(1, 2))

    q_part = b * h * n_q * TILE * d if with_q else 0
    if with_q:
        decode(acc[:q_part], n_q, sq, dq)
    if with_kv:
        kv = acc[q_part:].view(2, -1)
        decode(kv[0], n_kv, skv, dk)
        decode(kv[1], n_kv, skv, dv)


def flash_attention_bwd_pre(o, do, acc):
    """Kernel: Di = rowsum(O * dO) in fp32 (B, H, Sq), and ``acc`` (the
    backward's fp32 accumulator, flat) set to zero."""
    b, sq, h, d = o.shape
    di = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    lib = kernel_lib.load("flash_attn_bwd", _BWD_SIGNATURES)
    rc = lib.flash_attn_bwd_pre(_DTYPES[o.dtype], d, o.data_ptr(), do.data_ptr(), di.data_ptr(),
                                acc.data_ptr(), acc.numel(), *_strides(o, do), b, h, sq,
                                kernel_lib.stream_ptr(o.device))
    kernel_lib.check(lib, rc, "flash_attn_bwd_pre")
    kernel_lib.launch_counts["flash_attn_bwd_pre"] += 1
    return di


def flash_attention_bwd_main(q, k, v, do, lse, di, acc, q_chunk: int, scale):
    """Kernel: the backward from Di -> (dq, dk, dv). bf16: as
    :func:`bwd_plan` says, dQ is added into ``acc`` (and dq left for the
    post kernel) or written, and dK and dV are added into ``acc`` where
    ``q_chunk`` splits the q loop, else written. fp32: all three written
    (the two-kernel path; ``acc`` and ``q_chunk`` unused)."""
    b, sq, h, d = q.shape
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    lib = (kernel_lib.load("flash_attn_bwd", _BWD_SIGNATURES) if q.dtype == torch.bfloat16
           else kernel_lib.load("flash_attn_bwd_fma", _BWD_FMA_SIGNATURES))
    rc = lib.flash_attn_bwd(
        _DTYPES[q.dtype], d, *[t.data_ptr() for t in (q, k, v, do, lse, di, dq, dk, dv, acc)],
        *_strides(q, k, v, do, dq, dk, dv), b, h, sq, k.shape[1], q_chunk, float(scale),
        kernel_lib.stream_ptr(q.device))
    kernel_lib.check(lib, rc, "flash_attn_bwd")
    _count("flash_attn_bwd", d)
    return dq, dk, dv


def flash_attention_bwd_post(acc, dq, dk, dv, with_q: bool, with_kv: bool):
    """Kernel (bf16): :func:`bwd_post_plain` on the card."""
    b, sq, h, d = dq.shape
    lib = kernel_lib.load("flash_attn_bwd", _BWD_SIGNATURES)
    rc = lib.flash_attn_bwd_post(d, acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 *_strides(dq, dk, dv), b, h, sq, dk.shape[1], int(with_q),
                                 int(with_kv), kernel_lib.stream_ptr(dq.device))
    kernel_lib.check(lib, rc, "flash_attn_bwd_post")
    kernel_lib.launch_counts["flash_attn_bwd_post"] += 1


def flash_attention_bwd(q, k, v, o, lse, do, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of the attention output ``o`` for the
    upstream gradient ``do``, from the forward's ``lse``.
    :func:`flash_attention_bwd_plain` on a CPU tensor; on a CUDA one the
    pre kernel (Di, the accumulators zeroed), the backward kernel and, in
    bf16 where :func:`bwd_plan` gives an accumulator, the post kernel (the
    fp32 accumulators to bf16). A ``do`` view the kernels cannot read is
    copied to a contiguous tensor first."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if not _takes_layout(do):
        do = do.contiguous()
    _check_bwd(q, k, v, o, do, lse)
    b, sq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        q_chunk, dq_rows, kv_rows = bwd_plan(b * h, sq, k.shape[1],
                                             _sm_count(q.device.index or 0), d)
    else:
        q_chunk, dq_rows, kv_rows = -(-sq // TILE), 0, 0
    acc = torch.empty((b * h * (dq_rows + 2 * kv_rows) * d,), dtype=torch.float32,
                      device=q.device)
    di = flash_attention_bwd_pre(o, do, acc)
    dq, dk, dv = flash_attention_bwd_main(q, k, v, do, lse, di, acc, q_chunk, _scale(q, scale))
    if dq_rows or kv_rows:
        flash_attention_bwd_post(acc, dq, dk, dv, bool(dq_rows), bool(kv_rows))
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v, scale) -> (o, lse); ``lse`` is not differentiable.

    Forward: :func:`flash_attention_fwd` (K1). Backward:
    :func:`flash_attention_bwd`. On CPU tensors both take their plain
    versions."""

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
