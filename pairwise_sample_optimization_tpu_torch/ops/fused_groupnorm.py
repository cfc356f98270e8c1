"""Fused GroupNorm+SiLU: the CUDA kernels ``csrc/group_norm_silu.cu`` and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/fused_groupnorm.py``, on NCHW
activations, as two kernels with a wrapper each:

- ``group_stats`` (K4, JAX ``_stats_kernel``): per-(batch, group) partial
  fp32 sums and sums of squares, (B*G, splits, 2);
- ``group_norm_silu_from_stats`` (K5, JAX ``_norm_kernel``):
  silu((x - mean) * rsqrt(var + eps) * weight + bias) in x's dtype, with
  var = E[x^2] - E[x]^2 clamped at 0.

``fused_groupnorm_silu`` runs both through :class:`FusedGroupNormSiLU`.
A CPU tensor takes the plain version (``ops.group_norm.group_norm_plain``
with ``act="silu"``); a CUDA tensor takes the kernels or raises. The JAX
package has no backward kernel here: its VJP recomputes through the jnp
reference (``_fgs_bwd``). So does the port's: the Function's backward is
autograd through ``group_norm_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_lib

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "gn_stats": [_I, _P, _P, _I, _I, _LL, _LL, _P],
    "gn_silu_norm": [_I, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _F, _P],
}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_TARGET_BLOCKS = 1024  # ~8 blocks of 256 threads on each of 132 SMs
_MIN_CHUNK = 2048


def _splits(slabs: int, slab_len: int) -> tuple[int, int]:
    """(splits, chunk_len): blocks per slab and elements per block, the
    chunk a multiple of 8 so 16-byte vectors never cross it."""
    want = max(1, -(-_TARGET_BLOCKS // slabs))
    splits = max(1, min(want, slab_len // _MIN_CHUNK))
    chunk = -(-slab_len // splits)
    chunk = -(-chunk // 8) * 8
    return -(-slab_len // chunk), chunk


def _geometry(x, num_groups):
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    slabs, slab_len = b * num_groups, (c // num_groups) * hw
    return hw, slabs, slab_len, _splits(slabs, slab_len)


def fused_groupnorm_silu_plain(x, weight, bias, num_groups: int, eps: float = 1e-5):
    from .group_norm import group_norm_plain

    return group_norm_plain(x, weight, bias, num_groups, eps, act="silu")


def group_stats_plain(x, num_groups: int):
    """K4's plain version: the same (B*G, splits, 2) partial sums, in fp32."""
    _, slabs, slab_len, (splits, chunk) = _geometry(x, num_groups)
    xf = x.reshape(slabs, slab_len).float()
    xf = torch.nn.functional.pad(xf, (0, splits * chunk - slab_len)).reshape(slabs, splits, chunk)
    return torch.stack([xf.sum(-1), xf.square().sum(-1)], dim=-1)


def stats_from_partial(partial, x, num_groups: int):
    """(mean, var) per (batch, group), (B*G,) each, var clamped at 0."""
    n = x.numel() // (x.shape[0] * num_groups)
    tot = partial.sum(dim=1)
    mean = tot[:, 0] / n
    return mean, torch.clamp(tot[:, 1] / n - mean.square(), min=0.0)


def group_norm_silu_from_stats_plain(x, partial, weight, bias, num_groups: int,
                                     eps: float = 1e-5):
    """K5's plain version, from the same partial sums, in fp32."""
    b, c = x.shape[:2]
    mean, var = stats_from_partial(partial, x, num_groups)
    xf = x.reshape(b, num_groups, -1).float()
    normed = ((xf - mean.view(b, num_groups, 1)) * torch.rsqrt(var.view(b, num_groups, 1) + eps))
    affine = (c,) + (1,) * (x.ndim - 2)
    y = normed.reshape(x.shape) * weight.float().reshape(affine) + bias.float().reshape(affine)
    return torch.nn.functional.silu(y).to(x.dtype)


def _check(x, num_groups, weight=None, bias=None):
    params = [t for t in (weight, bias) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in params):
        raise ValueError(f"x/weight/bias must share one CUDA device, got {x.device}, "
                         f"{[t.device for t in params]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"GroupNorm+SiLU kernels take bf16 or fp32, got {x.dtype}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (B, C, *spatial), got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    c = x.shape[1]
    if c % num_groups or any(t.shape != (c,) for t in params):
        raise ValueError(f"C={c}, groups={num_groups}, weight/bias "
                         f"{[tuple(t.shape) for t in params]}")
    if (x.numel() // (x.shape[0] * c)) % 8 or x.data_ptr() % 16:
        raise ValueError(f"spatial size of {tuple(x.shape)} must be a multiple of 8")


def group_stats(x, num_groups: int):
    """K4: x (B, C, *spatial) on CUDA -> partial sums (B*G, splits, 2) fp32."""
    _check(x, num_groups)
    _, slabs, slab_len, (splits, chunk) = _geometry(x, num_groups)
    partial = torch.empty((slabs, splits, 2), dtype=torch.float32, device=x.device)
    lib = kernel_lib.load("group_norm_silu", _SIGNATURES)
    rc = lib.gn_stats(_DTYPES[x.dtype], x.data_ptr(), partial.data_ptr(), slabs, splits,
                      slab_len, chunk, kernel_lib.stream_ptr(x.device))
    kernel_lib.check(lib, rc, "gn_stats")
    kernel_lib.launch_counts["gn_stats"] += 1
    return partial


def group_norm_silu_from_stats(x, partial, weight, bias, num_groups: int, eps: float = 1e-5):
    """K5: normalize + affine + SiLU of x (on CUDA) from K4's partial sums."""
    _check(x, num_groups, weight, bias)
    hw, slabs, slab_len, (splits, chunk) = _geometry(x, num_groups)
    if partial.shape != (slabs, splits, 2) or partial.dtype != torch.float32 or (
            partial.device != x.device or not partial.is_contiguous()):
        raise ValueError(f"partial sums {tuple(partial.shape)} {partial.dtype} do not fit x "
                         f"{tuple(x.shape)}")
    gamma = weight.to(x.dtype).contiguous()
    beta = bias.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    lib = kernel_lib.load("group_norm_silu", _SIGNATURES)
    rc = lib.gn_silu_norm(
        _DTYPES[x.dtype], x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        y.data_ptr(), slabs, splits, slab_len, chunk, hw, x.shape[1] // num_groups, num_groups,
        float(eps), kernel_lib.stream_ptr(x.device),
    )
    kernel_lib.check(lib, rc, "gn_silu_norm")
    kernel_lib.launch_counts["gn_silu_norm"] += 1
    return y


class FusedGroupNormSiLU(torch.autograd.Function):
    """silu(groupnorm(x) * weight + bias). Forward: K4 + K5 on CUDA, the
    plain version on the CPU. Backward: autograd through
    ``group_norm_plain(..., act="silu")`` recomputed from the saved x,
    weight and bias (the counterpart of the JAX package's ``_fgs_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        if x.device.type == "cpu":
            return fused_groupnorm_silu_plain(x, weight, bias, num_groups, eps)
        return group_norm_silu_from_stats(x, group_stats(x, num_groups), weight, bias,
                                          num_groups, eps)

    @staticmethod
    def backward(ctx, gy):
        from .group_norm import group_norm_plain

        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            y = group_norm_plain(*inputs, ctx.num_groups, ctx.eps, act="silu")
            grads = torch.autograd.grad(y, [inputs[i] for i in wanted], gy)
        out = [None] * 3
        for i, g in zip(wanted, grads):
            out[i] = g
        return (*out, None, None)


def fused_groupnorm_silu(x, weight, bias, num_groups: int, eps: float = 1e-5):
    """x (B, C, *spatial) -> silu(groupnorm(x) * weight + bias) in x's
    dtype, differentiable in x, weight and bias."""
    return FusedGroupNormSiLU.apply(x, weight, bias, num_groups, eps)
