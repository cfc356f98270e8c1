"""Dynamic int8: the JAX package's ``ops/qconv.py`` on the CUDA kernels of
``csrc/int8_conv.cu`` and their plain PyTorch versions.

Three opt-in uses, each grad-free, as in the JAX package:

- the VAE decoder's 3x3 convs (``set_use_int8_decode``, the
  ``kernels.int8_vae_decode`` knob), optionally with SmoothQuant's outlier
  migration (``set_int8_smooth_alpha``, ``kernels.int8_smooth_alpha``);
- the UNet's weight products and resnet convs inside the
  :func:`int8_ref_pass` scope, around the DPO update's frozen reference
  forward (``train.int8_ref_pass``);
- the MLPs of the CLIP vision towers of the scorers
  (``set_use_int8_scorer``, or ``CLIPVisionConfig.int8_mlp``).

The knobs are process-wide, as the JAX package's trace-time globals: a run
sets them when it starts, and the scope is read when a layer runs.

Quantization is symmetric: activations per token (:func:`int8_matmul`) or
per sample over (C, H, W) (:func:`int8_conv2d`), weights per output
channel, ``s = max(absmax, 1e-8) / 127`` and ``q = clip(round(x / s),
-127, 127)`` (true division, round half to even), int32 accumulation, and
the dequantize ``acc * (s_x * s_w) (+ bias)`` in fp32 before the cast. The
integers and scales are the JAX package's, bit for bit.

A CPU tensor takes the plain versions, whose integer products are exact
(``torch._int_mm``; the conv in float64, exact below 2**53 where fp32
stops at 2**24). A CUDA tensor takes the kernels or raises:

- ``int8_absmax`` and ``int8_quantize`` (Q1): the absmax of each row,
  sample or channel, then the quantize (rows in place, an NCHW tensor into
  NHWC for the conv);
- ``int8_conv3x3`` (Q2): the 3x3 stride-1 pad-1 conv as an implicit GEMM
  (PyTorch has no int8 convolution on CUDA);
- ``int8_dequant`` (Q3): the epilogue of the matmul, whose int32 product
  is ``torch._int_mm``, as the JAX package leaves it to ``lax.dot_general``.

No gradient goes through int8: a call that would record one raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import kernel_lib

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "q8_absmax": [_I, _P, _P, _P, _LL, _LL, _I, _LL, _LL, _I, _LL, _P],
    "q8_quantize_rows": [_I, _P, _P, _P, _P, _LL, _LL, _P],
    "q8_quantize_nhwc": [_I, _P, _P, _P, _P, _P, _I, _I, _LL, _P],
    "q8_conv3x3": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "q8_dequant": [_I, _P, _P, _P, _P, _P, _LL, _LL, _P],
}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_TARGET_BLOCKS = 1024  # absmax blocks to spread over 132 SMs
_MIN_CHUNK = 4096  # elements a block reads at the least

_USE_INT8_DECODE = False
_USE_INT8_SCORER = False
_SMOOTH_ALPHA = None
_REF_PASS_INT8 = False


def set_use_int8_decode(flag: bool) -> None:
    """The VAE decoder's 3x3 convs in int8 (``allow_int8`` sites only)."""
    global _USE_INT8_DECODE
    _USE_INT8_DECODE = bool(flag)


def use_int8_decode() -> bool:
    return _USE_INT8_DECODE


def set_use_int8_scorer(flag: bool) -> None:
    """The MLPs of every CLIP vision tower in int8 (the scorers' image
    towers; text towers never quantize)."""
    global _USE_INT8_SCORER
    _USE_INT8_SCORER = bool(flag)


def use_int8_scorer() -> bool:
    return _USE_INT8_SCORER


def set_int8_smooth_alpha(alpha) -> None:
    """SmoothQuant's migration strength for the int8 decode (None: off)."""
    global _SMOOTH_ALPHA
    _SMOOTH_ALPHA = None if alpha is None else float(alpha)


@contextlib.contextmanager
def int8_ref_pass(enabled: bool = True):
    """While active, the UNet's weight products (attention projections,
    transformer and GEGLU projections) and its resnet and upsample 3x3
    convs run in int8: for the grad-free frozen reference forward of the
    DPO update only."""
    global _REF_PASS_INT8
    prev, _REF_PASS_INT8 = _REF_PASS_INT8, bool(enabled)
    try:
        yield
    finally:
        _REF_PASS_INT8 = prev


def in_int8_ref_pass() -> bool:
    return _REF_PASS_INT8


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #


def scale_of(absmax):
    """fp32 absmax -> the quantization step ``max(absmax, 1e-8) / 127``, a
    true division (on CUDA, dividing by a Python number multiplies by its
    rounded reciprocal, an ulp off)."""
    a = torch.clamp(absmax, min=1e-8)
    return a / torch.full_like(a, 127.0)


def quantize_plain(xf, s):
    """fp32 ``xf`` on the grid ``s`` (broadcast) -> int8."""
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)


def _divided(x, div):
    xf = x.float()
    return xf if div is None else xf / div.view(1, -1, *([1] * (x.ndim - 2)))


def absmax_plain(x, mode: str, div=None):
    """Q1a's plain version: fp32 absmax per row of (M, K) (``"rows"``), per
    sample (``"samples"``, of ``x / div`` per channel where ``div`` is given)
    or per channel (``"channels"``) of (B, C, H, W)."""
    if mode == "rows":
        return x.float().abs().amax(dim=-1)
    if mode == "samples":
        return _divided(x, div).abs().amax(dim=(1, 2, 3))
    return x.float().abs().amax(dim=(0, 2, 3))


def quantize_rows_plain(x, absmax):
    """Q1b's plain version: (M, K) -> (int8 (M, K), scale (M,))."""
    s = scale_of(absmax)
    return quantize_plain(x.float(), s[:, None]), s


def quantize_nhwc_plain(x, absmax, div=None):
    """Q1c's plain version: (B, C, H, W) -> (int8 (B, H, W, C), scale (B,))."""
    s = scale_of(absmax)
    q = quantize_plain(_divided(x, div), s.view(-1, 1, 1, 1))
    return q.permute(0, 2, 3, 1).contiguous(), s


def _epilogue_plain(acc, scale, bias, dtype):
    y = acc.float() * scale
    return (y if bias is None else y + bias).to(dtype)


def conv3x3_plain(xq, wq, sx, sw, bias=None, dtype=torch.float32):
    """Q2's plain version: int8 NHWC (B, H, W, C) x int8 (O, 3, 3, C) ->
    (B, O, H, W) in ``dtype``; the integer conv exact in float64."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                   padding=1).to(torch.int32)
    scale = sx.view(-1, 1, 1, 1) * sw.view(1, -1, 1, 1)
    return _epilogue_plain(acc, scale, None if bias is None else bias.view(1, -1, 1, 1), dtype)


def dequant_plain(acc, sx, sw, bias=None, dtype=torch.float32):
    """Q3's plain version: int32 (M, N) -> (M, N) in ``dtype``."""
    return _epilogue_plain(acc, sx[:, None] * sw[None, :], bias, dtype)


# ---------------------------------------------------------------------- #
# kernel wrappers (CPU tensors: the plain versions)
# ---------------------------------------------------------------------- #


def _on_cuda(*tensors, what):
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors must share one CUDA device (or be on the CPU), got "
                         f"{[None if t is None else t.device for t in tensors]}")
    return True


def _check_input(x, what):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be contiguous")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(fn, *args, name):
    lib = kernel_lib.load("int8_conv", _SIGNATURES)
    kernel_lib.check(lib, getattr(lib, fn)(*args), fn)
    kernel_lib.launch_counts[name] += 1


def _splits(rows_segs: int, seg_len: int):
    """(splits, chunk): blocks per segment and elements per block."""
    want = max(1, -(-_TARGET_BLOCKS // max(rows_segs, 1)))
    splits = max(1, min(want, seg_len // _MIN_CHUNK))
    chunk = -(-seg_len // splits)
    return -(-seg_len // chunk), chunk


def absmax(x, mode: str, div=None):
    """Q1a: fp32 absmax (rows,) of ``x``; see :func:`absmax_plain`."""
    if not _on_cuda(x, div, what="int8_absmax"):
        return absmax_plain(x, mode, div)
    _check_input(x, "int8_absmax")
    if mode == "rows":
        rows, k = x.shape
        geometry = (rows, k, 1, k, 0)  # rows, row stride, segments, segment length, its stride
    else:
        b, c = x.shape[:2]
        hw = x.numel() // (b * c)
        geometry = ((b, c * hw, c, hw, hw) if mode == "samples" else (c, hw, b, hw, c * hw))
    if div is not None and (mode != "samples" or div.dtype != torch.float32
                            or div.shape != (x.shape[1],)):
        raise ValueError(f"a divisor takes sample mode and fp32 (C,), got {mode}, "
                         f"{tuple(div.shape)} {div.dtype}")
    rows, row_stride, n_seg, seg_len, seg_stride = geometry
    splits, chunk = _splits(rows * n_seg, seg_len)
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    _launch("q8_absmax", _DTYPES[x.dtype], x.data_ptr(), _ptr(div), out.data_ptr(), rows,
            row_stride, n_seg, seg_len, seg_stride, splits, chunk,
            kernel_lib.stream_ptr(x.device), name="int8_absmax")
    return out


def quantize_rows(x, absmax_):
    """Q1b: (M, K) -> (int8 (M, K), fp32 scale (M,)) from the rows' absmax."""
    if not _on_cuda(x, absmax_, what="int8_quantize"):
        return quantize_rows_plain(x, absmax_)
    _check_input(x, "int8_quantize")
    rows, k = x.shape
    q = torch.empty((rows, k), dtype=torch.int8, device=x.device)
    s = torch.empty(rows, dtype=torch.float32, device=x.device)
    _launch("q8_quantize_rows", _DTYPES[x.dtype], x.data_ptr(), absmax_.contiguous().data_ptr(),
            q.data_ptr(), s.data_ptr(), rows, k, kernel_lib.stream_ptr(x.device),
            name="int8_quantize")
    return q, s


def quantize_nhwc(x, absmax_, div=None):
    """Q1c: (B, C, H, W) -> (int8 (B, H, W, C), fp32 scale (B,)) from the
    samples' absmax, of ``x / div`` per channel where ``div`` is given."""
    if not _on_cuda(x, absmax_, div, what="int8_quantize"):
        return quantize_nhwc_plain(x, absmax_, div)
    _check_input(x, "int8_quantize")
    b, c, h, w = x.shape
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    s = torch.empty(b, dtype=torch.float32, device=x.device)
    _launch("q8_quantize_nhwc", _DTYPES[x.dtype], x.data_ptr(), _ptr(div),
            absmax_.contiguous().data_ptr(), q.data_ptr(), s.data_ptr(), b, c, h * w,
            kernel_lib.stream_ptr(x.device), name="int8_quantize")
    return q, s


def conv3x3(xq, wq, sx, sw, bias=None, dtype=torch.float32):
    """Q2: int8 (B, H, W, C) x int8 (O, 3, 3, C) -> (B, O, H, W) ``dtype``,
    ``acc * (sx[b] * sw[o]) (+ bias[o])``."""
    if not _on_cuda(xq, wq, sx, sw, bias, what="int8_conv3x3"):
        return conv3x3_plain(xq, wq, sx, sw, bias, dtype)
    b, h, w, c = xq.shape
    o = wq.shape[0]
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape != (o, 3, 3, c)
            or not (xq.is_contiguous() and wq.is_contiguous()) or dtype not in _DTYPES):
        raise ValueError(f"int8_conv3x3 takes contiguous int8 (B, H, W, C) and (O, 3, 3, C), "
                         f"got {tuple(xq.shape)} {xq.dtype}, {tuple(wq.shape)} {wq.dtype}")
    if c % 16:
        raise ValueError(f"int8_conv3x3 takes channels in multiples of 16, got {c}")
    out = torch.empty((b, o, h, w), dtype=dtype, device=xq.device)
    _launch("q8_conv3x3", _DTYPES[dtype], xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
            sw.data_ptr(), _ptr(bias), out.data_ptr(), b, h, w, c, o,
            kernel_lib.stream_ptr(xq.device), name="int8_conv3x3")
    return out


def dequant(acc, sx, sw, bias=None, dtype=torch.float32):
    """Q3: int32 (M, N) -> (M, N) ``dtype``, ``acc * (sx[m] * sw[n]) (+ bias[n])``."""
    if not _on_cuda(acc, sx, sw, bias, what="int8_dequant"):
        return dequant_plain(acc, sx, sw, bias, dtype)
    if acc.dtype != torch.int32 or not acc.is_contiguous() or dtype not in _DTYPES:
        raise ValueError(f"int8_dequant takes contiguous int32, got {acc.dtype}")
    rows, cols = acc.shape
    out = torch.empty((rows, cols), dtype=dtype, device=acc.device)
    _launch("q8_dequant", _DTYPES[dtype], acc.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            _ptr(bias), out.data_ptr(), rows, cols, kernel_lib.stream_ptr(acc.device),
            name="int8_dequant")
    return out


def int_mm(xq, wq, what: str = "int8_matmul"):
    """Exact int32 (M, N) = int8 (M, K) @ int8 (N, K)^T through
    ``torch._int_mm``, whose CUDA path takes M > 16 and K, N multiples of 8:
    another shape off the CPU raises, naming ``what``."""
    (m, k), n = xq.shape, wq.shape[0]
    if xq.device.type != "cpu" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"{what}: torch._int_mm on CUDA takes M > 16 and K, N multiples of 8; "
                         f"got M={m}, K={k}, N={n}")
    return torch._int_mm(xq, wq.t())


# ---------------------------------------------------------------------- #
# the JAX package's functions, in torch layouts
# ---------------------------------------------------------------------- #


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("dynamic int8 has no gradient: run it under torch.no_grad() "
                           "(the frozen reference pass, the decode after sampling, a scorer)")


def int8_matmul(x, weight, bias=None, group=None, out_dtype=None, what: str = "int8_matmul"):
    """JAX ``int8_matmul`` with a torch ``Linear`` weight: x (..., C) @
    weight (O, C)^T (+ bias (O,), added in fp32), in ``out_dtype`` (default
    x's). Per-token activation scales, per-output-row weight scales.

    ``group``: the model group of a row-parallel layer, whose contracted dim
    is sharded. Both absmaxes are then reduced with max over it before the
    quantize (the grids of one process), and the caller sums the partial
    products over the group; pass ``out_dtype=torch.float32`` and the bias
    after that sum."""
    _refuse_grad(x, weight, bias)
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    w = weight.contiguous()
    ax, aw = absmax(x2, "rows"), absmax(w, "rows")
    if group is not None:
        import torch.distributed as dist

        from ..parallel.collectives import all_reduce_sum_

        all_reduce_sum_([ax, aw], group, op=dist.ReduceOp.MAX)
    xq, sx = quantize_rows(x2, ax)
    wq, sw = quantize_rows(w, aw)
    acc = int_mm(xq, wq, what)
    b = None if bias is None else bias.float().contiguous()
    y = dequant(acc, sx, sw, b, out_dtype or x.dtype)
    return y.reshape(*lead, w.shape[0])


def smooth_divisor(x, weight, alpha: float):
    """SmoothQuant's per-input-channel m = a_c^alpha * w_c^(alpha - 1)
    (1 where the activations never use the channel), a_c the absmax of x
    over (B, H, W), w_c the weight's over (O, 3, 3): JAX ``int8_conv2d``'s
    migration."""
    a_c = absmax(x, "channels")
    w_c = weight.float().abs().amax(dim=(0, 2, 3))
    m = (torch.pow(torch.clamp(a_c, min=1e-8), alpha)
         * torch.pow(torch.clamp(w_c, min=1e-8), alpha - 1.0))
    return torch.where(a_c > 0, m, torch.ones_like(m))


def int8_conv2d(x, weight, bias=None, smooth_alpha=None):
    """JAX ``int8_conv2d`` in NCHW: x (B, C, H, W), weight (O, C, 3, 3),
    stride 1, pad 1 -> (B, O, H, W) in x's dtype. Per-sample activation
    scales over (C, H, W), per-output-channel weight scales, the bias added
    in fp32; ``smooth_alpha`` (None: off) migrates each input channel's
    range into the weights first."""
    _refuse_grad(x, weight, bias)
    if weight.shape[2:] != (3, 3):
        raise ValueError(f"int8_conv2d takes 3x3 kernels, got {tuple(weight.shape)}")
    x = x.contiguous()
    o = weight.shape[0]
    m = None if smooth_alpha is None else smooth_divisor(x, weight, smooth_alpha)
    wf = weight if m is None else weight.float() * m.view(1, -1, 1, 1)
    w_rows = wf.permute(0, 2, 3, 1).reshape(o, -1).contiguous()  # (O, 3*3*C): taps, then C
    wq, sw = quantize_rows(w_rows, absmax(w_rows, "rows"))
    xq, sx = quantize_nhwc(x, absmax(x, "samples", m), m)
    b = None if bias is None else bias.float().contiguous()
    return conv3x3(xq, wq.view(o, 3, 3, -1), sx, sw, b, x.dtype)


def decoder_conv2d(x, weight, bias=None, allow_int8: bool = False):
    """The resnet / upsample 3x3 conv dispatch: int8 where the decode knob
    is on and the site allows it (with the smoothing alpha), or inside an
    :func:`int8_ref_pass` scope (no smoothing); the plain conv otherwise."""
    if allow_int8 and _USE_INT8_DECODE:
        return int8_conv2d(x, weight, bias, smooth_alpha=_SMOOTH_ALPHA)
    if _REF_PASS_INT8:
        return int8_conv2d(x, weight, bias)
    return F.conv2d(x, weight, bias, padding=1)
