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
  on ``wgmma`` s8 fed by TMA, laid out by :func:`conv3x3_plan` (PyTorch has
  no int8 convolution on CUDA);
- ``int8_matmul`` (Q3): the int8 product on ``wgmma`` s8 fed by TMA with
  the dequantize as its epilogue, laid out by :func:`matmul_plan` (the JAX
  package leaves the product to ``lax.dot_general``; its int32 result never
  reaches device memory here). ``torch._int_mm`` is only the plain
  version's.

No gradient goes through int8: a call that would record one raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import kernel_lib

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "q8_absmax": [_I, _P, _P, _P, _P, _LL, _LL, _I, _I, _LL, _I, _I, _I, _P],
    "q8_quantize_rows": [_I, _P, _P, _P, _P, _LL, _LL, _LL, _I, _P],
    "q8_quantize_nhwc": [_I, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _P],
    "q8_conv3x3": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P],
    "q8_matmul": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# Q1a's plan (``absmax_plan``)
ABSMAX_THREADS = 256  # threads a block (kThreads in csrc/int8_conv.cu)
ABSMAX_LOADS = 8  # loads of 8 elements a thread of a row at most, before the row takes more threads
ABSMAX_BLOCKS_PER_SM = 8  # blocks an SM holds at once: one wave
ABSMAX_TWO_WAVES = 2**28  # elements above which the split rows take two waves
ABSMAX_MIN_CHUNK = 32768  # elements a block of a split row reads at the least
# Q1b's plan (``quantize_rows_plan``): groups of 8 elements (one 16-byte load of
# bf16) a thread of a row at most, before the row takes more threads; and the
# threads an SM is given before a row's threads stop doubling (both measured
# on the H100 at the paths' row shapes)
QUANT_GROUPS = 8
QUANT_SM_THREADS = 1536
# Q1c's tile (``QC`` x ``QP`` in csrc/int8_conv.cu): channels x pixels a block,
# 128 pixels where that gives each SM ``NHWC_MIN_BLOCKS`` blocks, else 32
NHWC_TILE_C, NHWC_TILE_PS = 64, (128, 32)
NHWC_MIN_BLOCKS = 4
# Q2's plan (``conv3x3_plan``; csrc/int8_conv.cu namespace q2)
CONV_BK = 128  # channels of one tap a k-step
CONV_CONSUMERS = 256  # consumer threads a block (two warpgroups)
CONV_ACC = 128  # int32 accumulators a consumer thread (mi * bn / 2)
CONV_MIN_SPLIT_STEPS = 4  # k-steps a split takes at the least
# a split unit's cost in k-steps on the H100: writing its int32 slab, and
# the last unit's adding of each other slab (measured with the card's SMs
# all writing at once)
CONV_SLAB_WRITE_STEPS, CONV_SLAB_READ_STEPS = 10, 6
# Q3's plan (``matmul_plan``; csrc/int8_conv.cu namespace q8mm)
MATMUL_BM, MATMUL_BK = 128, 128  # rows a tile (64 a consumer warpgroup); bytes of K a k-step
MATMUL_MIN_SPLIT_STEPS = 4  # k-steps a split takes at the least
# a split unit's cost in k-steps of 128-column tiles on the H100: writing its
# int32 slab, and the last unit's adding of each other slab (fitted to every
# split of 5 and 20 tiles over K = 5120, scripts/time_port_int8.py
# --split-sweep)
MATMUL_SLAB_WRITE_STEPS, MATMUL_SLAB_READ_STEPS = 8, 2.5

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
    """The dequantize of an int32 product: (M, N) -> (M, N) in ``dtype``."""
    return _epilogue_plain(acc, sx[:, None] * sw[None, :], bias, dtype)


def matmul_plain(xq, wq, sx, sw, bias=None, dtype=torch.float32):
    """Q3's plain version: the exact int32 product of ``torch._int_mm``, then
    :func:`dequant_plain`. On CUDA ``torch._int_mm`` takes M > 16 only: fewer
    rows are padded with zero rows, which it then drops."""
    m = xq.shape[0]
    pad = max(0, 17 - m) if xq.device.type == "cuda" else 0
    acc = torch._int_mm(F.pad(xq, (0, 0, 0, pad)).contiguous(), wq.contiguous().t())[:m]
    return dequant_plain(acc, sx, sw, bias, dtype)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(fn, *args, name):
    lib = kernel_lib.load("int8_conv", _SIGNATURES)
    kernel_lib.check(lib, getattr(lib, fn)(*args), fn)
    kernel_lib.launch_counts[name] += 1


def absmax_plan(rows: int, row_len: int, sms: int) -> tuple[int, int, int]:
    """How Q1a's one launch covers ``rows`` rows of ``row_len`` elements on
    a card of ``sms`` SMs: (threads a row, splits, chunk). A row takes the
    fewest threads (32, 64, 128 or 256) that read it in at most
    ``ABSMAX_LOADS`` loads of 8 elements each (16 bytes of bf16). Rows that
    take a whole block and give fewer than two blocks an SM are each split
    into ``splits`` blocks of ``chunk`` elements (a multiple of 8, so a
    16-byte aligned row keeps its chunks aligned): as many as fill the card
    once (``ABSMAX_BLOCKS_PER_SM`` blocks an SM over all rows; twice above
    ``ABSMAX_TWO_WAVES`` elements, which streamed faster so on the H100),
    none under ``ABSMAX_MIN_CHUNK`` elements, none empty."""
    vecs, tpr = -(-row_len // 8), 32
    while tpr < ABSMAX_THREADS and vecs > ABSMAX_LOADS * tpr:
        tpr *= 2
    if tpr < ABSMAX_THREADS or rows >= 2 * sms:
        return tpr, 1, row_len
    waves = 2 if rows * row_len > ABSMAX_TWO_WAVES else 1
    want = -(-sms * ABSMAX_BLOCKS_PER_SM * waves // rows)
    splits = max(1, min(want, row_len // ABSMAX_MIN_CHUNK))
    chunk = -(-row_len // splits)
    chunk = -(-chunk // 8) * 8
    return tpr, -(-row_len // chunk), chunk


def quantize_rows_plan(rows: int, k: int, sms: int) -> tuple[int, int]:
    """How Q1b covers ``rows`` rows of ``k`` elements on a card of ``sms``
    SMs: (threads a row, blocks). A row takes the fewest threads (32, 64,
    128 or 256) that quantize it in at most ``QUANT_GROUPS`` groups of 8
    elements each, as ``absmax_plan`` does for Q1a, and twice as many while
    that keeps the launch within ``QUANT_SM_THREADS`` threads an SM and a
    thread has more than one group; a block of ``ABSMAX_THREADS`` threads
    holds ``ABSMAX_THREADS / tpr`` rows."""
    groups, tpr = -(-k // 8), 32
    while tpr < ABSMAX_THREADS and (groups > QUANT_GROUPS * tpr or (
            rows * 2 * tpr <= sms * QUANT_SM_THREADS and groups > tpr)):
        tpr *= 2
    return tpr, -(-rows // (ABSMAX_THREADS // tpr))


def quantize_nhwc_plan(batch: int, channels: int, hw: int,
                       sms: int) -> tuple[int, tuple[int, int, int]]:
    """Q1c's tile and grid: a block a tile of ``NHWC_TILE_C`` channels x
    ``tile_p`` pixels of one sample (128, or 32 where the 128-pixel tiles
    would give the card's ``sms`` SMs fewer than ``NHWC_MIN_BLOCKS`` blocks
    each): (tile_p, (pixel tiles, channel tiles, samples))."""
    for tile_p in NHWC_TILE_PS:
        grid = (-(-hw // tile_p), -(-channels // NHWC_TILE_C), batch)
        if math.prod(grid) >= NHWC_MIN_BLOCKS * sms:
            break
    return tile_p, grid


def _split_k(k_steps: int, tiles: int, sms: int, min_steps: int, write_steps: int,
             read_steps: int) -> tuple[int, int]:
    """(splits, chunk) of ``k_steps`` k-steps over blocks for ``tiles``
    output tiles on ``sms`` SMs (Q2 and Q3). Only where the tiles leave half
    the SMs or more idle, all units in one wave: among the splits of at
    least ``min_steps`` k-steps each, the one whose last unit takes the
    fewest k-steps (its chunk, ``write_steps`` to write its int32 slab and
    ``read_steps`` for each other slab it adds), if that beats K whole;
    ties to the fewest splits."""
    best = (k_steps, 1)
    if tiles <= sms // 2:
        for s in range(2, min(k_steps // min_steps, sms // tiles) + 1):
            chunk = -(-k_steps // s)
            if -(-k_steps // chunk) != s:
                continue
            best = min(best, (chunk + write_steps + (s - 1) * read_steps, s))
    return best[1], -(-k_steps // best[1])


@dataclasses.dataclass(frozen=True)
class Conv3x3Plan:
    """Q2's layout of one conv (``conv3x3_plan``): tiles of ``patch_h`` x
    ``pw`` pixels of one image by ``bn`` output channels, each
    warpgroup issuing ``mi`` 64-row products a k-step; ``k_steps`` k-steps
    of ``CONV_BK`` channels of one tap, split into ``splits`` ranges of
    ``chunk``; ``units`` = tiles x splits walked by ``grid`` persistent
    blocks."""

    mi: int
    bn: int
    pw: int
    patch_h: int
    tiles_h: int
    tiles_w: int
    tiles_n: int
    tiles: int
    cslices: int
    k_steps: int
    splits: int
    chunk: int
    units: int
    grid: int


def conv3x3_plan(batch: int, height: int, width: int, channels: int, outc: int, sms: int,
                 bf16_out: bool = True) -> Conv3x3Plan:
    """How Q2 covers a (B, H, W, C) x (O, 3, 3, C) conv on a card of ``sms``
    SMs. N tiles of 256 channels where O is a multiple of 256 (one 64-row
    product a warpgroup), else of 128 (two), so a thread holds ``CONV_ACC``
    accumulators either way; patches 64 pixels wide (an m-block an image
    row, written by a TMA store) for a bf16 output at least 64 wide with
    rows on 16 bytes, else 16 wide. K is split by :func:`_split_k` with
    ``CONV_MIN_SPLIT_STEPS``, ``CONV_SLAB_WRITE_STEPS`` and
    ``CONV_SLAB_READ_STEPS``. One block an SM, walking units u, u + grid,
    ... (tile u // splits: N tiles fastest, then patches along w, h and
    images; k-steps [split * chunk, split * chunk + chunk))."""
    mi, bn = (1, 256) if outc % 256 == 0 else (2, 128)
    pw = 64 if bf16_out and width >= 64 and width % 8 == 0 else 16
    patch_h = 2 * mi * 64 // pw
    tiles_h, tiles_w, tiles_n = -(-height // patch_h), -(-width // pw), -(-outc // bn)
    tiles = batch * tiles_h * tiles_w * tiles_n
    cslices = -(-channels // CONV_BK)
    k_steps = 9 * cslices
    splits, chunk = _split_k(k_steps, tiles, sms, CONV_MIN_SPLIT_STEPS, CONV_SLAB_WRITE_STEPS,
                             CONV_SLAB_READ_STEPS)
    units = tiles * splits
    return Conv3x3Plan(mi, bn, pw, patch_h, tiles_h, tiles_w, tiles_n, tiles, cslices, k_steps,
                       splits, chunk, units, min(units, sms))


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """Q3's layout of one product (``matmul_plan``): tiles of ``MATMUL_BM``
    rows by ``bn`` columns (``tiles_m`` x ``tiles_n``); ``k_steps`` k-steps of
    ``MATMUL_BK`` bytes of K, split into ``splits`` ranges of ``chunk``;
    ``units`` = tiles x splits walked by ``grid`` persistent blocks."""

    bn: int
    tiles_m: int
    tiles_n: int
    tiles: int
    k_steps: int
    splits: int
    chunk: int
    units: int
    grid: int


def matmul_plan(m: int, k: int, n: int, sms: int) -> MatmulPlan:
    """How Q3 covers int8 (M, K) x (N, K)^T on a card of ``sms`` SMs. N
    tiles of 128 columns (a ring of 6 stages), or of 256 (4 stages, a
    k-step's products per byte 4/3 as many) where N is a multiple of 256 and
    the 128-column tiles would take the card more than once while the
    256-column ones fit it once: on the H100 the wider tile was slower
    wherever the narrower ones gave each SM more tiles, or fewer than one
    (scripts/time_port_int8.py --split-sweep). M tiles of ``MATMUL_BM``
    rows, the last cut by M (TMA's zero fill and clipping), so any M from 1
    is one launch. K is split by
    :func:`_split_k` with ``MATMUL_MIN_SPLIT_STEPS``,
    ``MATMUL_SLAB_WRITE_STEPS`` and ``MATMUL_SLAB_READ_STEPS``. One block an
    SM, walking units u, u + grid, ... (tile u // splits: N tiles fastest,
    then M tiles; k-steps [split * chunk, split * chunk + chunk)). The
    kernel sizes its ring of stages to the bn it is given (its ``Cfg``)."""
    tiles_m = -(-m // MATMUL_BM)
    bn = 256 if n % 256 == 0 and tiles_m * -(-n // 128) > sms >= tiles_m * (n // 256) else 128
    tiles_n = -(-n // bn)
    tiles = tiles_m * tiles_n
    k_steps = -(-k // MATMUL_BK)
    splits, chunk = _split_k(k_steps, tiles, sms, MATMUL_MIN_SPLIT_STEPS,
                             MATMUL_SLAB_WRITE_STEPS, MATMUL_SLAB_READ_STEPS)
    units = tiles * splits
    return MatmulPlan(bn, tiles_m, tiles_n, tiles, k_steps, splits, chunk, units,
                      min(units, sms))


def absmax_geometry(shape, mode: str, divided: bool = False):
    """Q1a's rows of ``x`` (contiguous, ``shape``) for ``mode``: (rows, row
    stride, segments a row, segment length, segment stride), in elements. A
    row is its segments one after the other: a token of (M, K) is one
    segment; a sample of (B, C, H, W) is C segments of H*W (one contiguous
    one unless ``divided``: each channel has its own divisor); a channel is
    B segments of H*W, C*H*W apart."""
    if mode == "rows":
        rows, k = shape
        return rows, k, 1, k, 0
    b, c = shape[:2]
    hw = math.prod(shape) // (b * c)
    if mode == "samples":
        return (b, c * hw, c, hw, hw) if divided else (b, c * hw, 1, c * hw, 0)
    return c, hw, b, hw, c * hw


def absmax(x, mode: str, div=None):
    """Q1a: fp32 absmax (rows,) of ``x``; see :func:`absmax_plain`. One
    launch; ``absmax_plan`` lays out its grid."""
    if not _on_cuda(x, div, what="int8_absmax"):
        return absmax_plain(x, mode, div)
    _check_input(x, "int8_absmax")
    if div is not None and (mode != "samples" or div.dtype != torch.float32
                            or div.shape != (x.shape[1],)):
        raise ValueError(f"a divisor takes sample mode and fp32 (C,), got {mode}, "
                         f"{tuple(div.shape)} {div.dtype}")
    rows, row_stride, n_seg, seg_len, seg_stride = absmax_geometry(x.shape, mode,
                                                                   div is not None)
    if n_seg * seg_len >= 2**31:
        raise ValueError(f"int8_absmax takes rows of fewer than 2**31 elements, got "
                         f"{n_seg * seg_len} ({tuple(x.shape)}, {mode})")
    tpr, splits, chunk = absmax_plan(rows, n_seg * seg_len, _sm_count(x.device.index or 0))
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    partial = (torch.empty(rows * splits, dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    _launch("q8_absmax", _DTYPES[x.dtype], x.data_ptr(), _ptr(div), out.data_ptr(),
            _ptr(partial), rows, row_stride, n_seg, seg_len, seg_stride, tpr, splits, chunk,
            kernel_lib.stream_ptr(x.device), name="int8_absmax")
    return out


def quantize_rows(x, absmax_):
    """Q1b: (M, K) -> (int8 (M, K), fp32 scale (M,)) from the rows' absmax.
    On the card the int8 rows start a multiple of 16 bytes apart, as
    :func:`matmul`'s tensor maps need: where K is not a multiple of 16, the
    result is the first K columns of rows padded past K (the pad unwritten,
    never read)."""
    if not _on_cuda(x, absmax_, what="int8_quantize"):
        return quantize_rows_plain(x, absmax_)
    _check_input(x, "int8_quantize")
    rows, k = x.shape
    q = torch.empty((rows, -(-k // 16) * 16), dtype=torch.int8, device=x.device)[:, :k]
    s = torch.empty(rows, dtype=torch.float32, device=x.device)
    tpr, _ = quantize_rows_plan(rows, k, _sm_count(x.device.index or 0))
    _launch("q8_quantize_rows", _DTYPES[x.dtype], x.data_ptr(), absmax_.contiguous().data_ptr(),
            q.data_ptr(), s.data_ptr(), rows, k, q.stride(0), tpr,
            kernel_lib.stream_ptr(x.device), name="int8_quantize")
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
    tile_p, _ = quantize_nhwc_plan(b, c, h * w, _sm_count(x.device.index or 0))
    _launch("q8_quantize_nhwc", _DTYPES[x.dtype], x.data_ptr(), _ptr(div),
            absmax_.contiguous().data_ptr(), q.data_ptr(), s.data_ptr(), b, c, h * w, tile_p,
            kernel_lib.stream_ptr(x.device), name="int8_quantize")
    return q, s


def conv3x3(xq, wq, sx, sw, bias=None, dtype=torch.float32):
    """Q2: int8 (B, H, W, C) x int8 (O, 3, 3, C) -> (B, O, H, W) ``dtype``,
    ``acc * (sx[b] * sw[o]) (+ bias[o])``."""
    if not _on_cuda(xq, wq, sx, sw, bias, what="int8_conv3x3"):
        return conv3x3_plain(xq, wq, sx, sw, bias, dtype)
    b, h, w, c = xq.shape
    o = wq.shape[0]
    if c % 16:
        raise ValueError(f"int8_conv3x3 takes channels in multiples of 16, got {c}")
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape != (o, 3, 3, c)
            or not (xq.is_contiguous() and wq.is_contiguous()) or dtype not in _DTYPES):
        raise ValueError(f"int8_conv3x3 takes contiguous int8 (B, H, W, C) and (O, 3, 3, C), "
                         f"got {tuple(xq.shape)} {xq.dtype}, {tuple(wq.shape)} {wq.dtype}")
    out = torch.empty((b, o, h, w), dtype=dtype, device=xq.device)
    plan = conv3x3_plan(b, h, w, c, o, _sm_count(xq.device.index or 0), dtype == torch.bfloat16)
    ws = (torch.empty((plan.units, CONV_CONSUMERS * CONV_ACC), dtype=torch.int32,
                      device=xq.device) if plan.splits > 1 else None)
    _launch("q8_conv3x3", _DTYPES[dtype], xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
            sw.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(ws), b, h, w, c, o, plan.mi,
            plan.bn, plan.pw, plan.splits, plan.chunk, plan.grid, kernel_lib.stream_ptr(xq.device),
            name="int8_conv3x3")
    return out


def _matmul_shape(m: int, k: int, n: int, what: str) -> None:
    """The int8 matmul's shapes on the card: any M, K and N multiples of 8
    (the output's rows on 16 bytes for its TMA store); another raises,
    naming ``what``."""
    if k % 8 or n % 8:
        raise ValueError(f"{what}: the int8 matmul on CUDA takes K and N multiples of 8; "
                         f"got M={m}, K={k}, N={n}")


def matmul(xq, wq, sx, sw, bias=None, dtype=torch.float32):
    """Q3: int8 (M, K) x int8 (N, K)^T -> (M, N) ``dtype``, ``acc * (sx[m] *
    sw[n]) (+ bias[n])``: the product and its dequantize in one kernel, laid
    out by :func:`matmul_plan`. On the card each operand's rows lie a
    multiple of 16 bytes apart (as :func:`quantize_rows` writes them)."""
    if not _on_cuda(xq, wq, sx, sw, bias, what="int8_matmul"):
        return matmul_plain(xq, wq, sx, sw, bias, dtype)
    (m, k), n = xq.shape, wq.shape[0]
    _matmul_shape(m, k, n, "int8_matmul")
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape[1] != k
            or dtype not in _DTYPES or any(t.stride(1) != 1 or t.stride(0) % 16 for t in (xq, wq))):
        raise ValueError(f"int8_matmul takes int8 (M, K) and (N, K) rows 16-byte "
                         f"multiples apart, got {tuple(xq.shape)} {xq.dtype} {xq.stride()}, "
                         f"{tuple(wq.shape)} {wq.dtype} {wq.stride()}")
    if any(t is not None and (t.dtype != torch.float32 or t.shape != (r,))
           for t, r in ((sx, m), (sw, n), (bias, n))):
        got = [None if t is None else (tuple(t.shape), t.dtype) for t in (sx, sw, bias)]
        raise ValueError(f"int8_matmul takes fp32 scales ({m},), ({n},) and bias ({n},), "
                         f"got {got}")
    out = torch.empty((m, n), dtype=dtype, device=xq.device)
    plan = matmul_plan(m, k, n, _sm_count(xq.device.index or 0))
    ws = (torch.empty((plan.units, CONV_CONSUMERS * plan.bn // 2), dtype=torch.int32,
                      device=xq.device) if plan.splits > 1 else None)
    _launch("q8_matmul", _DTYPES[dtype], xq.data_ptr(), wq.data_ptr(), sx.contiguous().data_ptr(),
            sw.contiguous().data_ptr(), _ptr(bias), out.data_ptr(), _ptr(ws), m, n, k,
            xq.stride(0), wq.stride(0), plan.bn, plan.splits, plan.chunk, plan.grid,
            kernel_lib.stream_ptr(xq.device), name="int8_matmul")
    return out


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
    if x.device.type != "cpu":
        _matmul_shape(x2.shape[0], c, w.shape[0], what)
    ax, aw = absmax(x2, "rows"), absmax(w, "rows")
    if group is not None:
        import torch.distributed as dist

        from ..parallel.collectives import all_reduce_sum_

        all_reduce_sum_([ax, aw], group, op=dist.ReduceOp.MAX)
    xq, sx = quantize_rows(x2, ax)
    wq, sw = quantize_rows(w, aw)
    b = None if bias is None else bias.float().contiguous()
    y = matmul(xq, wq, sx, sw, b, out_dtype or x.dtype)
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
