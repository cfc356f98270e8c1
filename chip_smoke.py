#!/usr/bin/env python3
"""Drive the PyTorch port of online PSO (serving, updates, eval) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with one CUDA card, ``nvcc`` and
PyTorch. In order:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the hand-written kernels from ``pairwise_sample_optimization_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build seconds;
3. small reference: a small fp32 pipeline whose attention head dims the
   kernel takes (64) runs on the card through the kernels and on the CPU
   through the plain versions, with the same weights and noise; latents,
   log-probs, images and scores must agree to 2e-3;
4. the slice at the full width of SDXL-Turbo (UNet 320/640/1280 with 70
   transformer blocks, CLIP-L + bigG text encoders, VAE 128/256/512/512,
   PickScore ViT-H/14), bf16 weights and compute, fp32 LoRA rank 32 with a
   non-zero B, 4 prompts -> 8 trajectories of 4 Euler-ancestral steps at
   512^2, random weights and token ids from ``--seed``. Every launch counter
   is set to 0 just before each run and read just after; the counts must
   equal the ones the configuration implies. Log-probs, images and scores
   must be finite, each winner 0 or 1. Prints per-phase ms, pairs/s and
   peak memory. The serving pipeline is freed afterwards;
5. the online-PSO loop at full width through its entry point,
   ``cli.online_runner.run_online_pso`` with the config's defaults
   (``configs/sdxl_turbo_dpo.py``): 4 pair batches of 4 prompts = 16 pairs,
   then 2 optimizer updates of 2 x 3 microbatches (policy pass at batch 8,
   remat "full", bf16 towers, fp32 LoRA rank 32). Launch counters are set
   to 0 just before and read just after; the counts must equal the ones
   the configuration implies. Every loss and grad_norm must be finite, the
   first update's loss log 2 within 1e-3 (a fresh adapter: policy =
   reference), the LoRA changed and the frozen UNet weights not (against a
   rebuild from the seed), the checkpoint written at step 1 must
   restore, and the adapter exported beside it
   (``lora-1/pytorch_lora_weights.safetensors``, read back with the port's
   ``load_file``) must equal the LoRA that checkpoint restores. Prints
   sample / update / microbatch ms, pairs/s of the loop and peak memory;
6. the same for SDXL-DMD2 (``run_online_pso(sampler="dmd")``,
   ``configs/sdxl_dmd_dpo.py``): 1024^2, 4 pair batches of 2 prompts = 8
   pairs, 2 updates of 4 x 3 microbatches (policy pass at batch 2, remat
   "full", a grad-free reference pass), LoRA rank 16, the transition noise
   shared within each trajectory side; the same checks (first loss log 2);
7. the PickaPic eval protocol, ``cli.evaluate_sdxl_dmd2`` at full width and
   1024^2: the first 8 packaged ImageReward prompts at batch 2, scored by
   PickScore, CLIP score, HPS (ViT-H/14 towers) and the aesthetic scorer
   (CLIP-L/14, the released MLP); launch counts as implied, scores finite,
   and the first two prompts run again at batch 1 must score the same
   within ``TOL["eval_batch"]``. Prints prompts/min and peak memory;
8. one phase per kernel at every shape steps 5-7 gave it (recorded during
   those runs) in bf16, plus one fp32 case and, for the attention kernels,
   the bf16 ragged lengths of ``RAGGED`` (and, for the forward, of
   ``RAGGED_FWD`` at head dims 80 and 512; 0 launches): the kernel against
   its plain version on the same inputs (|diff| <= atol + rtol*|plain|,
   atol = rtol unless stated: attention forward 2e-3 fp32 and in bf16 rtol
   1e-2 with an atol of 5% of the plain O's rms, see ``fwd_tolerance``,
   its fp32 logsumexp atol 2e-3; attention backward 1e-4 fp32 and in bf16
   rtol 1e-2 with an atol of 5% of the plain gradient's rms, see
   ``bwd_tolerance`` and ``grad_tolerance``, its Di 1e-4 / 1e-5, its post
   kernel bit for bit; GroupNorm+SiLU 3e-2 / 2e-4),
   and CUDA-event device times of
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (timed here only; the port never calls it):
   SDPA forward for K1, autograd of SDPA (dQ, dK, dV in one backward) for
   the backward kernel; for the backward also the whole backward (its three
   kernels) beside the function's bound, and the backward twice at
   ``RUN_TO_RUN`` with the max|diff| between the two runs (its sums over
   blocks come in another order each run). Back-to-back calls on one
   input: an input under the 50 MB L2 stays there, as a GroupNorm input
   just written by a conv does. Also the
   autograd Function's gradients against autograd of the plain forward:
   at one UNet shape in fp32, and in bf16 at the update's 1024-token
   self- and cross-attention shapes, with the upstream gradient handed
   over contiguous (as the UNet's reshape and output projection give it),
   as a strided view and with a strided last dim (copied first), and in
   bf16 at the ``RAGGED`` shapes. The plain attention forward runs over
   slices of the batch where its logits would pass 1 GiB (the VAE's 16384
   tokens). GroupNorm rows report the share of the limit used;
9. prints the card line again, the ``{"kernels": [...]}`` line (launches:
   the sum over the runs of steps 5-7), then, last, the device line.

Any failure raises, and the script exits non-zero. It also exits non-zero,
printing no result, where CUDA or the port's package is missing. The full
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "chip_smoke_runs"  # the training run's checkpoints (git-ignored, removed)

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense): device memory
# rate, bf16 tensor-core rate, fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
GN_STATS_OPS, GN_NORM_OPS = 3, 8  # fp32 operations per element of K4, K5
# (atol, rtol); in bf16 see fwd_tolerance and bwd_tolerance
TOL = {"attention": {"bf16": (5e-2, 1e-2), "fp32": (2e-3, 2e-3)},
       "attention_lse": (2e-3, 0.0),  # the fp32 logsumexp of either dtype
       "attention_bwd": {"bf16": (5e-2, 1e-2), "fp32": (1e-4, 1e-4)},
       # the pre kernel's Di against attention_di: fp32 sums of 64 products in
       # another order (each within ~64 ulps of the sum of their magnitudes)
       "attention_di": (1e-4, 1e-5),
       "gn": {"bf16": (3e-2, 3e-2), "fp32": (2e-4, 2e-4)},
       # an eval score at batch 2 against the same prompt's at batch 1 (bf16):
       # the noise is the same, the kernels cuBLAS and cuDNN pick may not be
       "eval_batch": (1e-2, 1e-2)}
EVAL_PROMPTS = 8  # packaged ImageReward prompts in the eval phase
# the plain attention forward runs over slices of the batch of at most this
# many fp32 logits (1 GiB): 16384 VAE tokens at batch 4 would be 4.3 GB at once
PLAIN_LOGITS = 2**28
# bf16 head-dim-64 attention cases off the main path (0 launches): (q shape, kv
# length). Every main-path length but kv 77 is a multiple of 64, so only these
# reach the zero-filled and masked edges of the q and kv tiles.
RAGGED = (((2, 1000, 3, 64), 77), ((1, 200, 5, 64), 1000), ((1, 1, 2, 64), 1))
# The same for the forward's own tilings at PickScore's and the VAE's head
# dims (forward only: the backward takes d = 64).
RAGGED_FWD = (((2, 1000, 3, 80), 77), ((1, 1, 2, 80), 1), ((1, 1000, 1, 512), 77),
              ((2, 200, 1, 512), 1000))
_BWD_SRC = "pairwise_sample_optimization_tpu_torch/csrc/flash_attn_bwd.cu"
_JAX_ATTN = "pairwise_sample_optimization_tpu/ops/flash_attention.py"
KERNELS = {
    "flash_attn_fwd": ("pairwise_sample_optimization_tpu_torch/csrc/flash_attn_fwd.cu",
                       f"{_JAX_ATTN}:99"),
    # the backward: Di (jnp in _bwd) and the zeroed accumulators; dQ, dK and dV
    # in one kernel (K2 and K3); the fp32 accumulators to bf16 (the kernels' casts)
    "flash_attn_bwd_pre": (_BWD_SRC, f"{_JAX_ATTN}:287"),
    "flash_attn_bwd": (_BWD_SRC, f"{_JAX_ATTN}:193, {_JAX_ATTN}:244"),
    "flash_attn_bwd_post": (_BWD_SRC, f"{_JAX_ATTN}:277"),
    "gn_stats": ("pairwise_sample_optimization_tpu_torch/csrc/group_norm_silu.cu",
                 "pairwise_sample_optimization_tpu/ops/fused_groupnorm.py:55"),
    "gn_silu_norm": ("pairwise_sample_optimization_tpu_torch/csrc/group_norm_silu.cu",
                     "pairwise_sample_optimization_tpu/ops/fused_groupnorm.py:78"),
}


def log(msg):
    print(msg, flush=True)


def dtype_name(dt):
    import torch

    return {torch.bfloat16: "bf16", torch.float32: "fp32"}[dt]


def check_close(name, got, want, tol):
    """Fail unless |got - want| <= atol + rtol*|want| everywhere, ``tol`` =
    (atol, rtol); returns max|diff|."""
    import torch

    atol, rtol = tol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = atol + rtol * want.abs()
    bad = diff > limit
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max|diff| {diff.max().item():.3e}, largest |diff|/limit "
                             f"{(diff / limit).max().item():.3f}, mean|want| "
                             f"{want.abs().mean().item():.3e}: over atol {atol} rtol {rtol} "
                             f"({int(bad.sum())} elements)")
    return diff.max().item()


def fwd_tolerance(want):
    """(atol, rtol) of the attention forward's O against the plain O
    ``want``. In bf16 the atol is a share (5%) of want's rms: O is a
    softmax-weighted mean of V over 77 to 1024 keys, so for unit-normal V
    |O| is about 0.04-0.14, and a fixed atol would be as large as O itself.
    The kernel rounds P to bf16 before P.V and O to bf16 at the end, an
    error that follows O's scale. In ``tests/test_torch_port_fwd_tolerance.py``
    a forward rounded that way stays within half this limit, and one with O
    off by 5%, a kv tile left out, pad keys counted in the row sum or the
    running-max rescale skipped exceeds it. The fp32 logsumexp is held at
    ``TOL["attention_lse"]`` (it differs from the plain one only by the
    order of sums and ``__expf``/``logf``); an LSE 0.05 off fails it."""
    atol, rtol = TOL["attention"][dtype_name(want.dtype)]
    if dtype_name(want.dtype) == "bf16":
        atol *= want.float().pow(2).mean().sqrt().item()
    return atol, rtol


def bwd_tolerance(want):
    """(atol, rtol) of the attention backward against the plain gradient
    ``want``. In bf16 the atol is a share (5%) of want's rms: P and dS are
    rounded to bf16 before sums over up to 1024 rows, as in the TPU
    kernels, and that error follows the gradient's scale, not each
    element's. In ``tests/test_torch_port_smoke_tolerance.py`` a backward
    rounded that way stays within half this limit, and one with a 5% error
    in P or dS, or with a tile left out of a kernel's loop, exceeds it."""
    atol, rtol = TOL["attention_bwd"][dtype_name(want.dtype)]
    if dtype_name(want.dtype) == "bf16":
        atol *= want.float().pow(2).mean().sqrt().item()
    return atol, rtol


def grad_tolerance(name, want, skv):
    """``bwd_tolerance`` of gradient ``name`` ("dq", "dk" or "dv"), except
    where it is 0 in exact arithmetic: over one key (kv 1) the softmax is 1
    whatever S is, so dS = P (dP - Di) = 0 and dQ = dK = 0. The plain
    version's are then rounding noise (~1e-8, so 5% of their rms is no
    limit at all) and both are held at an absolute 1e-5."""
    if skv == 1 and name in ("dq", "dk"):
        return 1e-5, 0.0
    return bwd_tolerance(want)


def tolerance_used(got, want, tol):
    """The largest |got - want| / (atol + rtol*|want|): 1 is the limit."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def timed_ms(fn, reps=10, inner=10):
    """Median over ``reps`` of CUDA-event device time per call for ``inner``
    calls in a row, after 3 warm-up calls. Each rep first queues a device
    sleep of at least ~2 ms and of about twice the host's time to enqueue
    ``inner`` calls (measured once; an autograd backward takes the host
    longer than its kernels take the card), so the host has enqueued the
    calls before the start event runs: the time is the device's, not the
    host's launch rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_cycles = int(max(4e6, 4e6 * host_ms))  # ~2 GHz: 2e6 cycles per ms, twice host_ms
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(bytes_moved, ops, kind):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------- #
# small reference: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------- #


def small_reference(seed):
    import torch

    from pairwise_sample_optimization_tpu_torch.models import (
        AutoencoderKL, CLIPDualEncoder, CLIPTextConfig, CLIPTextTower, CLIPVisionConfig,
        SDXLUNet, UNetConfig, VAEConfig)
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.rewards import PickScoreScorer

    f32 = torch.float32
    ucfg = UNetConfig(block_out_channels=(64, 128), transformer_layers=(0, 1),
                      layers_per_block=1, head_dim=64, cross_attention_dim=64,
                      addition_time_embed_dim=8, pooled_embed_dim=32, lora_rank=4, dtype=f32)
    vcfg = VAEConfig(block_out_channels=(64, 64), layers_per_block=1, dtype=f32)
    tcfg = CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2, projection_dim=32,
                          dtype=f32)
    pt = CLIPTextConfig(vocab_size=1000, width=64, layers=2, heads=2, projection_dim=16, dtype=f32)
    pv = CLIPVisionConfig(image_size=56, patch_size=7, width=128, layers=2, heads=2,
                          projection_dim=16, dtype=f32)
    gen = torch.Generator().manual_seed(seed)
    mods = [SDXLUNet(ucfg, device="cpu"), AutoencoderKL(vcfg, device="cpu"),
            CLIPTextTower(tcfg, device="cpu"), CLIPTextTower(tcfg, device="cpu"),
            CLIPDualEncoder(pt, pv, device="cpu")]
    for m in mods:
        init_random_(m, gen, lora_b_std=0.05)
        m.eval()
    cpu = SDXLPipeline(*mods[:4], scorer=PickScoreScorer(mods[4]), resolution=64)
    gpu = SDXLPipeline(*[copy.deepcopy(m).cuda() for m in mods[:4]],
                       scorer=PickScoreScorer(copy.deepcopy(mods[4]).cuda()), resolution=64)
    b = 2
    ids = [torch.randint(1, 998, (b, 77), generator=gen) for _ in range(3)]
    for t in ids:
        t[:, 20] = 999
    init = torch.randn((2 * b, 32, 32, 4), generator=gen)
    noise = torch.randn((4, 2 * b, 32, 32, 4), generator=gen)
    outs = []
    kernel_lib.reset_launch_counts()
    for pipe, dev in ((cpu, "cpu"), (gpu, "cuda")):
        cond = pipe.encode_prompt(*[t.to(dev) for t in ids])
        outs.append(pipe.sample_pairs(cond, init_noise=init.to(dev), step_noise=noise.to(dev)))
    torch.cuda.synchronize()
    counts = dict(kernel_lib.launch_counts)
    if min(v for k, v in counts.items() if "bwd" not in k) == 0:
        raise AssertionError(f"small reference did not reach every forward kernel: {counts}")
    want, got = outs
    tol = TOL["attention"]["fp32"]
    errs = {
        "latents": check_close("small latents", got.trajectory.latents.cpu(),
                               want.trajectory.latents, tol),
        "log_probs": check_close("small log_probs", got.trajectory.log_probs.cpu(),
                                 want.trajectory.log_probs, tol),
        "images": check_close("small images", got.images.cpu(), want.images, tol),
        "scores": check_close("small scores", got.scores.cpu(), want.scores, tol),
    }
    if not torch.equal(got.winner.cpu(), want.winner):
        raise AssertionError(f"small winners differ: {got.winner.tolist()} vs "
                             f"{want.winner.tolist()}")
    log(f"small reference (fp32, kernels on the card vs plain on the CPU): max|diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f"; launches {counts}")
    return {"max_abs_diff": errs, "launches": counts}


# ---------------------------------------------------------------------- #
# the slice at full width
# ---------------------------------------------------------------------- #


def _unet_counts(ucfg):
    """(attention calls, GroupNorm+SiLU calls, ResnetBlocks, ResnetBlocks
    that run before the first attention) of one UNet forward."""
    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    blocks = sum(d * (2 * lpb + 1) for d in depths) + depths[-1]
    resnets = n * (2 * lpb + 1) + 2
    first = next(i for i, d in enumerate(depths) if d)
    return 2 * blocks, 2 * resnets + 1, resnets, first * lpb + 1


def _generation_launches(ucfg, vcfg, steps, vision_layers):
    """Launches of ``steps`` UNet forwards (Turbo's steps, or DMD2's S - 1
    transitions and the final x0 prediction), one VAE decode (its
    mid-block attention) and vision towers of ``vision_layers`` layers."""
    attn, gn_unet, _, _ = _unet_counts(ucfg)
    vae_resnets = 2 + len(vcfg.block_out_channels) * (vcfg.layers_per_block + 1)
    k1 = steps * attn + 1 + sum(vision_layers)
    gn = steps * gn_unet + 2 * vae_resnets + 1
    return {"flash_attn_fwd": k1, "flash_attn_bwd_pre": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_post": 0, "gn_stats": gn, "gn_silu_norm": gn}


def expected_launches(pipe, steps):
    """Launches of one ``sample_pairs`` call (either sampler): ``steps`` UNet
    forwards, the VAE decode and the PickScore vision tower."""
    return _generation_launches(pipe.unet.config, pipe.vae.config, steps,
                                [pipe.scorer.model.vision_config.layers])


def expected_eval_launches(ucfg, vcfg, steps, batches, vision_layers):
    """Launches of an eval run of ``batches`` batches: per batch one DMD2
    generation (``steps`` UNet forwards, one VAE decode) and the scorers'
    vision towers (``vision_layers``: one entry per scorer). The scorers'
    text towers are causal and take no kernel."""
    return {k: batches * v for k, v in
            _generation_launches(ucfg, vcfg, steps, vision_layers).items()}


def attention_shapes(ucfg, batch, latent_hw, text_len=77):
    """(q shape (B, S, H, D), kv length) of each attention call of one UNet
    forward at ``batch`` and a ``latent_hw`` x ``latent_hw`` latent: per
    transformer block a self-attention over the level's tokens and a
    cross-attention to the ``text_len`` text tokens."""
    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    shapes = []
    for i, (ch, d) in enumerate(zip(ucfg.block_out_channels, depths)):
        blocks = d * (2 * lpb + 1) + (depths[-1] if i == n - 1 else 0)
        tokens = (latent_hw // 2 ** i) ** 2
        q = (batch, tokens, ch // ucfg.head_dim, ucfg.head_dim)
        shapes += [(q, tokens), (q, text_len)] * blocks
    return shapes


def bwd_needs_post(q_shape, skv, sms=132):
    """Whether the bf16 backward at these lengths runs the post kernel (has
    an fp32 accumulator; ``ops.flash_attention.bwd_plan``)."""
    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    b, sq, h, _ = q_shape
    _, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms)
    return bool(dq_rows or kv_rows)


def expected_update_launches(ucfg, n_micro, fuse_ref_pass, batch, latent_hw, sms=132):
    """Launches of one optimizer update of ``n_micro`` microbatches with a
    policy pass at ``batch``. Per microbatch: the policy forward (with
    grad), its recompute under remat "full" and, unless fused into the
    policy call (one call at twice the batch), the reference forward (no
    grad); per attention call in the backward the pre kernel and the
    backward kernel, and the post kernel where that call's lengths give an
    accumulator (``bwd_needs_post`` on a card of ``sms`` SMs). Under remat
    the ResnetBlocks that run before the first attention are not
    recomputed: nothing in them depends on the LoRA, so they save nothing
    for the backward. The GroupNorm+SiLU backward is the plain version."""
    attn, gn, resnets, grad_free = _unet_counts(ucfg)
    shapes = attention_shapes(ucfg, batch * (2 if fuse_ref_pass else 1), latent_hw)
    assert len(shapes) == attn, (len(shapes), attn)
    remat = ucfg.remat == "full"
    passes = 1 + (0 if fuse_ref_pass else 1)
    k1 = attn * (passes + remat)
    k45 = gn * passes + (2 * (resnets - grad_free) if remat else 0)
    post = sum(bwd_needs_post(q, skv, sms) for q, skv in shapes)
    return {"flash_attn_fwd": n_micro * k1, "flash_attn_bwd_pre": n_micro * attn,
            "flash_attn_bwd": n_micro * attn, "flash_attn_bwd_post": n_micro * post,
            "gn_stats": n_micro * k45, "gn_silu_norm": n_micro * k45}


class ShapeRecorder:
    """Records the shapes the main path hands each kernel wrapper, by
    wrapping the module functions the models reach (observation only)."""

    def __init__(self):
        from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
        from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg

        self.mods, self.attention, self.attention_bwd, self.gn = (tfa, tfg), {}, {}, {}
        self.orig = (tfa.flash_attention_fwd, tfa.flash_attention_bwd, tfg.fused_groupnorm_silu)

    def __enter__(self):
        tfa, tfg = self.mods
        fwd, bwd, gn = self.orig

        def count(table, key):
            table[key] = table.get(key, 0) + 1

        def rec_fwd(q, k, v, scale=None):
            count(self.attention, (tuple(q.shape), tuple(k.shape), q.dtype))
            return fwd(q, k, v, scale)

        def rec_bwd(q, k, v, o, lse, do, scale=None):
            count(self.attention_bwd, (tuple(q.shape), tuple(k.shape), q.dtype))
            return bwd(q, k, v, o, lse, do, scale)

        def rec_gn(x, weight, bias, num_groups, eps=1e-5):
            count(self.gn, (tuple(x.shape), num_groups, eps, x.dtype, weight.dtype))
            return gn(x, weight, bias, num_groups, eps)

        tfa.flash_attention_fwd, tfa.flash_attention_bwd, tfg.fused_groupnorm_silu = (
            rec_fwd, rec_bwd, rec_gn)
        return self

    def __exit__(self, *exc):
        tfa, tfg = self.mods
        tfa.flash_attention_fwd, tfa.flash_attention_bwd, tfg.fused_groupnorm_silu = self.orig


def full_slice(seed, prompts=4, steps=4, iters=5):
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

    t0 = time.perf_counter()
    pipe = SDXLPipeline.random(lora_rank=32, dtype=torch.bfloat16, resolution=512, seed=seed,
                               lora_b_std=1.0 / 32, device="cuda")
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", pipe.unet), ("vae", pipe.vae), ("te1", pipe.te1),
                                ("te2", pipe.te2), ("pickscore", pipe.scorer.model))}
    log(f"full-width pipeline built on the card in {time.perf_counter() - t0:.1f} s; "
        f"params {n_params}")
    want = expected_launches(pipe, steps)
    gen = torch.Generator().manual_seed(seed)
    ids = [torch.randint(1, 49407, (prompts, 77), generator=gen) for _ in range(3)]
    for t in ids:
        t[torch.arange(prompts), torch.randint(5, 77, (prompts,), generator=gen)] = 49407  # EOS
    ids = [t.cuda() for t in ids]
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)

    def run(timings):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cond = pipe.encode_prompt(*ids)
        torch.cuda.synchronize()
        timings["encode"] = (time.perf_counter() - t) * 1e3
        return pipe.sample_pairs(cond, cuda_gen, num_steps=steps, lora_scale=1.0,
                                 timings=timings)

    run({})  # warm-up: first-call setup of cuDNN and the kernels
    runs = []
    for i in range(iters):
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        out = run(timings)
        counts = dict(kernel_lib.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        if counts != want:
            raise AssertionError(f"launch counts {counts} != expected {want}")
        traj = out.trajectory
        assert traj.log_probs.shape == (steps - 1, 2 * prompts), traj.log_probs.shape
        assert out.images.shape == (2 * prompts, 512, 512, 3), out.images.shape
        assert out.scores.shape == (2 * prompts,) and out.winner.shape == (prompts,)
        for name, t in (("latents", traj.latents), ("log_probs", traj.log_probs),
                        ("images", out.images), ("scores", out.scores)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite {name}")
        if not set(out.winner.tolist()) <= {0, 1}:
            raise AssertionError(f"winner {out.winner.tolist()}")
        total = sum(timings.values())
        runs.append({"phase_ms": timings, "total_ms": total, "pairs_per_s": prompts / total * 1e3,
                     "launches": counts, "peak_bytes": peak})
        log(f"slice run {i}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in timings.items())
            + f"; {prompts / total * 1e3:.3f} pairs/s; peak {peak / 2**30:.2f} GiB; "
            f"launches {counts}; log_probs {traj.log_probs.float().mean(1).tolist()}; "
            f"scores {[round(s, 4) for s in out.scores.tolist()]}; winner {out.winner.tolist()}")
    med = lambda key: statistics.median(r[key] for r in runs)
    summary = {
        "prompts": prompts, "trajectories": 2 * prompts, "steps": steps, "resolution": 512,
        "params": n_params, "expected_launches": want, "runs": runs,
        "median_total_ms": med("total_ms"), "median_pairs_per_s": med("pairs_per_s"),
        "median_phase_ms": {k: statistics.median(r["phase_ms"][k] for r in runs)
                            for k in runs[0]["phase_ms"]},
    }
    log(f"slice median over {iters} runs: {summary['median_total_ms']:.1f} ms, "
        f"{summary['median_pairs_per_s']:.3f} pairs/s, phases {summary['median_phase_ms']}")
    del pipe, out
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------- #
# the online-PSO loop (sampling + update) at full width
# ---------------------------------------------------------------------- #


def _frozen_and_lora(unet):
    frozen = {k: v for k, v in unet.state_dict().items() if ".lora." not in k}
    lora = {k: v for k, v in unet.state_dict().items() if ".lora." in k}
    return frozen, lora


def train_slice(seed, sampler, recorder):
    """One epoch of ``run_online_pso`` with ``sampler``'s config defaults
    (Turbo: ``configs/sdxl_turbo_dpo.py``; DMD2: ``configs/sdxl_dmd_dpo.py``),
    the kernel wrappers' shapes recorded into ``recorder``."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE, latest_checkpoint,
                                                                    load_file,
                                                                    restore_train_state)
    from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_dir, run_online_pso
    from pairwise_sample_optimization_tpu_torch.configs import sdxl_dmd_dpo, sdxl_turbo_dpo
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                              make_optimizer)

    config = (sdxl_turbo_dpo if sampler == "turbo" else sdxl_dmd_dpo).get_config()
    config.seed = seed
    config.output_dir = str(RUN_DIR)
    config.run_name = f"online_{sampler}"
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t_cfg, s_cfg = config.train, config.sample
    pairs = s_cfg.batch_size * s_cfg.num_batches_per_epoch
    n_updates = pairs // (t_cfg.batch_size * t_cfg.gradient_accumulation_steps)
    n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with recorder:
        state, history, pipe = run_online_pso(config, sampler=sampler, num_epochs=1,
                                              device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(kernel_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    out_dir = Path(run_dir(config))

    want = {k: s_cfg.num_batches_per_epoch * v
            for k, v in expected_launches(pipe, s_cfg.num_steps).items()}
    upd = expected_update_launches(pipe.unet.config, n_micro, bool(t_cfg.fuse_ref_pass),
                                   2 * t_cfg.batch_size, pipe.latent_hw,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    want = {k: want[k] + n_updates * upd[k] for k in want}
    if counts != want:
        raise AssertionError(f"training-run launch counts {counts} != expected {want}")
    if len(history) != n_updates or state.step != n_updates:
        raise AssertionError(f"{len(history)} updates logged, state at step {state.step}; "
                             f"expected {n_updates}")
    for m in history:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm", "ratio_win")):
            raise AssertionError(f"non-finite update metrics {m}")
    first = history[0]["loss"]
    if abs(first - math.log(2.0)) > 1e-3:
        raise AssertionError(f"first update loss {first} != log 2 (fresh adapter)")

    # frozen UNet weights unchanged and LoRA moved, against a rebuild from
    # the seed (the UNet is the first tower SDXLPipeline.random draws)
    ref = SDXLUNet(pipe.unet.config, device="meta").to_empty(device="cuda")
    init_random_(ref, torch.Generator(device="cuda").manual_seed(seed))
    frozen, lora = _frozen_and_lora(pipe.unet)
    frozen0, lora0 = _frozen_and_lora(ref)
    checksum = lambda d: sum(float(v.double().sum()) for v in d.values())
    frozen_changed = [k for k in frozen if not torch.equal(frozen[k], frozen0[k])]
    if frozen_changed or set(lora) != set(lora0):
        raise AssertionError(f"frozen UNet weights changed: {frozen_changed[:5]}")
    lora_moved = max(float((lora[k].float() - lora0[k].float()).abs().max()) for k in lora)
    up_zero_before = all(float(v.abs().max()) == 0 for k, v in lora0.items() if ".up." in k)
    if not up_zero_before or lora_moved == 0:
        raise AssertionError(f"LoRA did not move (max|delta| {lora_moved})")
    checksums = {"frozen": checksum(frozen), "frozen_rebuilt": checksum(frozen0),
                 "lora": checksum(lora), "lora_before": checksum(lora0)}

    # the checkpoint written at step 1 restores into a fresh state (into the
    # rebuilt UNet's adapter, whose tensors lora0 shares)
    ckpt = latest_checkpoint(str(out_dir))
    lora_ref = lora_parameters(ref)
    restored = PSOTrainState.create(lora_ref, make_optimizer(lora_ref))
    extra = restore_train_state(ckpt, restored)
    if restored.step != state.step or extra.get("epoch") != 0 or any(
            not torch.equal(restored.lora[k], state.lora[k]) for k in state.lora):
        raise AssertionError(f"checkpoint {ckpt} did not restore the trained state")

    # the adapter for diffusers written beside checkpoint-1 equals the LoRA
    # that checkpoint restores
    lora_file = out_dir / "lora-1" / LORA_FILE
    exported = load_file(str(lora_file))
    want_lora = {"unet." + k: v.detach().float().cpu() for k, v in restored.lora.items()}
    if set(exported) != set(want_lora) or any(
            exported[k].dtype != torch.float32 or not torch.equal(exported[k], want_lora[k])
            for k in want_lora):
        raise AssertionError(f"{lora_file} does not hold the LoRA of {ckpt}")

    metrics_jsonl = (out_dir / "metrics.jsonl").read_text()
    metrics = [json.loads(line) for line in metrics_jsonl.splitlines()]
    times = next(m for m in metrics if "loss" in m)
    sample_ms, train_ms = times["time/sample_s"] * 1e3, times["time/train_s"] * 1e3
    summary = {
        "sampler": sampler, "resolution": s_cfg.resolution, "pairs": pairs,
        "updates": n_updates, "microbatches_per_update": n_micro,
        "policy_batch": 2 * t_cfg.batch_size, "remat": config.activation_checkpoint,
        "history": history, "launches": counts, "expected_launches": want,
        "sample_ms": sample_ms, "update_ms": train_ms / n_updates,
        "microbatch_ms": train_ms / n_updates / n_micro,
        "loop_pairs_per_s": pairs / (sample_ms + train_ms) * 1e3, "wall_s": wall_s,
        "peak_bytes": peak, "checkpoint": Path(ckpt).name, "lora_max_abs_delta": lora_moved,
        "checksums": checksums, "lora_export": {"file": str(lora_file.relative_to(out_dir)),
                                                "tensors": len(exported),
                                                "bytes": lora_file.stat().st_size},
    }
    log(f"online PSO loop, {sampler} at {s_cfg.resolution}^2 (1 epoch, {pairs} pairs, "
        f"{n_updates} updates x {n_micro} microbatches of policy batch {2 * t_cfg.batch_size}): "
        f"sample {sample_ms:.1f} ms, update {summary['update_ms']:.1f} ms, "
        f"microbatch {summary['microbatch_ms']:.1f} ms, {summary['loop_pairs_per_s']:.3f} "
        f"pairs/s of the loop, peak {peak / 2**30:.2f} GiB; losses "
        f"{[round(m['loss'], 6) for m in history]}, grad_norm "
        f"{[round(m['grad_norm'], 6) for m in history]}; launches {counts}; LoRA max|delta| "
        f"{lora_moved:.3e}, frozen unchanged; restored {summary['checkpoint']}; "
        f"lora-1/{LORA_FILE} ({len(exported)} tensors) equals its LoRA")
    del pipe, state, ref, restored, frozen, frozen0, lora, lora0, lora_ref
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary, metrics_jsonl


# ---------------------------------------------------------------------- #
# the PickaPic eval protocol (SDXL-DMD2 at 1024^2, four scorers)
# ---------------------------------------------------------------------- #


def eval_slice(seed, recorder, prompts=EVAL_PROMPTS):
    """``cli.evaluate_sdxl_dmd2`` at full width and 1024^2 on the first
    ``prompts`` packaged ImageReward prompts at batch 2 with PickScore,
    CLIP score, HPS and the aesthetic scorer (the released MLP), shapes
    recorded into ``recorder``; then the first two prompts again at batch 1,
    whose per-prompt scores must equal the batch-2 run's within
    ``TOL["eval_batch"]`` (each prompt's noise depends on its index only;
    what differs is bf16 rounding in kernels chosen by batch size)."""
    import contextlib

    import torch

    from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev
    from pairwise_sample_optimization_tpu_torch.models import (CLIPVisionConfig, UNetConfig,
                                                               VAEConfig)
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    layers = [CLIPVisionConfig.vit_h14().layers] * 3 + [CLIPVisionConfig.vit_l14().layers]

    def run(n, bs, rec):
        path = out / f"eval_b{bs}.json"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        t0 = time.perf_counter()
        with rec or contextlib.nullcontext():
            ev.main(["--device", "cuda", "--seed", str(seed), "--prompts_json", "imagereward",
                     "--max_prompts", str(n), "--batch_size", str(bs), "--scorers",
                     ",".join(ev.SCORERS), "--aesthetic_mlp_path", "packaged", "--timing",
                     "--output_json", str(path)])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, peak = dict(kernel_lib.launch_counts), torch.cuda.max_memory_allocated()
        want = expected_eval_launches(UNetConfig.sdxl(), VAEConfig.sdxl(), 4, -(-n // bs), layers)
        if counts != want:
            raise AssertionError(f"eval launch counts {counts} != expected {want}")
        result = json.loads(path.read_text())
        for name in ev.SCORERS:
            scores = result["per_prompt"][name]
            if len(scores) != n or not all(math.isfinite(x) for x in scores):
                raise AssertionError(f"eval {name} scores {scores}")
        return {"result": result, "launches": counts, "peak_bytes": peak, "wall_s": wall_s}

    main_run = run(prompts, 2, recorder)
    solo = run(2, 1, None)
    per_prompt, solo_scores = main_run["result"]["per_prompt"], solo["result"]["per_prompt"]
    errs, used = {}, {}
    for name in ev.SCORERS:
        got, want = torch.tensor(per_prompt[name][:2]), torch.tensor(solo_scores[name])
        errs[name] = check_close(f"eval {name} batch 2 vs batch 1", got, want, TOL["eval_batch"])
        used[name] = tolerance_used(got, want, TOL["eval_batch"])
    timing = main_run["result"]["timing"]
    summary = {
        "prompts": prompts, "batch_size": 2, "resolution": 1024, "scorers": list(ev.SCORERS),
        "means": {k: v for k, v in main_run["result"].items() if k.endswith("_mean")},
        "per_prompt": per_prompt, "batch1_scores": solo_scores, "batch1_max_abs_diff": errs,
        "batch1_tolerance_used": used, "timing": timing, "launches": main_run["launches"],
        "peak_bytes": main_run["peak_bytes"], "wall_s": main_run["wall_s"],
        "batch1_run": {k: solo[k] for k in ("launches", "peak_bytes", "wall_s")},
    }
    log(f"eval (DMD2 at 1024^2, {prompts} ImageReward prompts at batch 2, four scorers): "
        f"{timing['prompts_per_min']:.2f} prompts/min (steady batches {timing['steady_batch_s']:.3f} "
        f"s, generation {timing['gen_s']:.3f} s, scoring {timing['score_s']}), peak "
        f"{main_run['peak_bytes'] / 2**30:.2f} GiB; means {summary['means']}; launches "
        f"{main_run['launches']}; first two prompts at batch 1: max|diff| "
        + ", ".join(f"{k} {v:.2e} (share of limit {used[k]:.3f})" for k, v in errs.items()))
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------- #
# kernel phases
# ---------------------------------------------------------------------- #


def attention_plain(q, k, v):
    """``flash_attention_plain`` over slices of the batch, each with at most
    ``PLAIN_LOGITS`` logits (the same function: batch rows are independent)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    b, sq, h, _ = q.shape
    per = max(1, PLAIN_LOGITS // (sq * k.shape[1] * h))
    if per >= b:
        return tfa.flash_attention_plain(q, k, v)
    parts = [tfa.flash_attention_plain(q[i:i + per], k[i:i + per], v[i:i + per])
             for i in range(0, b, per)]
    return torch.cat([o for o, _ in parts]), torch.cat([lse for _, lse in parts])


def attention_phase(shapes, seed):
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(q, k, dt, n) for (q, k, dt), n in shapes.items()]
    q0, k0, _, _ = max(cases, key=lambda c: c[3])
    cases.append((q0, k0, torch.float32, 0))  # the fp32 case, off the main path
    cases += [(qs, (qs[0], skv, *qs[2:]), torch.bfloat16, 0) for qs, skv in RAGGED + RAGGED_FWD]
    rows = []
    for qs, ks, dt, launches in cases:
        q = torch.randn(qs, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(ks, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(ks, generator=gen, device="cuda", dtype=dt)
        o_k, lse_k = tfa.flash_attention_fwd(q, k, v)
        o_p, lse_p = attention_plain(q, k, v)
        tol, tol_lse = fwd_tolerance(o_p), TOL["attention_lse"]
        err = max(check_close(f"attention {qs} kv {ks[1]} {dtype_name(dt)}", o_k, o_p, tol),
                  check_close(f"attention lse {qs} {dtype_name(dt)}", lse_k, lse_p, tol_lse))
        used = {"o": tolerance_used(o_k, o_p, tol), "lse": tolerance_used(lse_k, lse_p, tol_lse)}
        b, sq, h, d = qs
        skv = ks[1]
        bytes_moved = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse_k.numel()
        bound_ms, bound_by = bound(bytes_moved, 4 * b * h * sq * skv * d, dtype_name(dt))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        big = b * h * sq * skv > PLAIN_LOGITS  # fewer timed calls of a slow plain version
        row = {
            "shape": {"q": list(qs), "kv": list(ks)}, "dtype": dtype_name(dt),
            "launches": launches, "max_abs_err": err, "tolerance_used": used,
            "ms": timed_ms(lambda: tfa.flash_attention_fwd(q, k, v)),
            "plain_ms": timed_ms(lambda: attention_plain(q, k, v), *((3, 2) if big else ())),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(row)
        log(f"flash_attn_fwd {row['dtype']} q{qs} kv{skv}: max|diff| {err:.2e}, share of "
            f"tolerance used O {used['o']:.3f} (atol {tol[0]:.2e}) LSE {used['lse']:.3f}, "
            f"{row['ms']:.4f} ms vs bound {bound_ms:.4f} ({bound_by}), plain "
            f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, {launches} launches")
    return {"flash_attn_fwd": rows}


RUN_TO_RUN = ((2, 4096, 10, 64), 4096)  # the backward twice at this shape, bf16


def _bwd_bounds(q, k, skv, acc_q, acc_kv):
    """Bounds (ms, by) of the backward at q's shape and kv length ``skv``:
    the function's (q, k, v, O, dO, LSE read, dQ, dK, dV written; five
    products), each kernel's, and those of the TPU design's K2 (four
    products) and K3 (three) for comparison with earlier records.
    ``acc_q`` / ``acc_kv``: whether dQ / dK and dV go through fp32
    accumulators."""
    b, sq, h, d = q.shape
    el, kind = q.element_size(), dtype_name(q.dtype)
    pair, rows = 2 * b * h * sq * skv * d, b * h * sq
    nq, nk = q.numel(), k.numel()
    acc = 4 * (nq * acc_q + 2 * nk * acc_kv)  # accumulator bytes (zeroed, added, read)
    inputs = el * (2 * nq + 2 * nk) + 8 * rows  # q, do, k, v, lse, di
    return {
        "function": bound(el * (3 * nq + 2 * nk) + 4 * rows + el * (nq + 2 * nk), 5 * pair, kind),
        "flash_attn_bwd_pre": bound(2 * el * nq + 4 * rows + acc, 2 * nq, "fp32"),
        "flash_attn_bwd": bound(inputs + (4 if acc_q else el) * nq + (4 if acc_kv else el) * 2 * nk,
                                5 * pair, kind),
        "flash_attn_bwd_post": bound(acc + el * (nq * acc_q + 2 * nk * acc_kv), 0, "fp32"),
        "k2": bound(inputs + el * 2 * nk, 4 * pair, kind),
        "k3": bound(inputs + el * nq, 3 * pair, kind),
    }


def attention_bwd_phase(shapes, seed):
    """The backward at every (q, kv, dtype) the updates gave it, plus one fp32
    case and the bf16 ``RAGGED`` cases: the whole backward
    (``flash_attention_bwd``) against ``flash_attention_bwd_plain``
    (``grad_tolerance``), and each kernel against its plain version on the
    same inputs: the pre kernel's Di against ``attention_di``
    (``TOL["attention_di"]``) and its accumulator all zero; the backward
    kernel's gradients (the accumulators decoded by ``bwd_post_plain``)
    against ``flash_attention_bwd_plain``; the post kernel against
    ``bwd_post_plain`` on the same accumulator, bit for bit. CUDA-event ms
    of each kernel, the whole backward, the plain backward and SDPA's
    backward (autograd: dQ, dK, dV in one call); the function's bound and
    each kernel's. Then the whole backward twice at ``RUN_TO_RUN``: the
    max|diff| between the two runs (the sums taken by bulk reductions come
    in another order) must lie within ``bwd_tolerance``."""
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cases = [(q, k, dt, n) for (q, k, dt), n in shapes.items()]
    q0, k0, _, _ = max(cases, key=lambda c: (c[3], c[0][1] * c[1][1]))
    cases.append((q0, k0, torch.float32, 0))  # the fp32 case, off the main path
    cases += [(qs, (qs[0], skv, *qs[2:]), torch.bfloat16, 0) for qs, skv in RAGGED]
    rows = {name: [] for name in ("flash_attn_bwd_pre", "flash_attn_bwd", "flash_attn_bwd_post")}
    whole_rows = []
    for qs, ks, dt, launches in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=dt) for s in (qs, ks, ks))
        do = torch.randn(qs, generator=gen, device="cuda", dtype=dt)
        o, lse = tfa.flash_attention_fwd(q, k, v)
        b, sq, h, d = qs
        skv, scale = ks[1], 1.0 / math.sqrt(d)
        name = f"{qs} kv {skv} {dtype_name(dt)}"
        want = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)))
        tol = {n: grad_tolerance(n, w, skv) for n, w in want.items()}

        def held(what, got):
            errs = [check_close(f"{what} {n} {name}", got[i], want[n], tol[n])
                    for i, n in enumerate(want)]
            return max(errs), max(tolerance_used(got[i], want[n], tol[n])
                                  for i, n in enumerate(want))

        whole_err, whole_used = held("backward", tfa.flash_attention_bwd(q, k, v, o, lse, do))
        # kernel by kernel, as flash_attention_bwd runs them
        if dt == torch.bfloat16:
            q_chunk, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms)
        else:
            q_chunk, dq_rows, kv_rows = -(-sq // tfa.TILE), 0, 0
        acc = torch.full((b * h * (dq_rows + 2 * kv_rows) * d,), float("nan"), device="cuda")
        di = tfa.flash_attention_bwd_pre(o, do, acc)
        err_pre = check_close(f"Di {name}", di, tfa.attention_di(o, do), TOL["attention_di"])
        if acc.numel() and acc.abs().max().item() != 0:
            raise AssertionError(f"pre kernel {name}: accumulator not zeroed")
        dq, dk, dv = tfa.flash_attention_bwd_main(q, k, v, do, lse, di, acc, q_chunk, scale)
        post = bool(dq_rows or kv_rows)
        if post:
            plain = [t.clone() for t in (dq, dk, dv)]
            tfa.bwd_post_plain(acc, *plain, bool(dq_rows), bool(kv_rows))
            tfa.flash_attention_bwd_post(acc, dq, dk, dv, bool(dq_rows), bool(kv_rows))
            err_post = max(check_close(f"post {n} {name}", g, w, (0.0, 0.0))
                           for n, g, w in zip("qkv", (dq, dk, dv), plain))
        main_err, main_used = held("backward kernel", (dq, dk, dv))
        bounds = _bwd_bounds(q, k, skv, bool(dq_rows), bool(kv_rows))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        big = b * h * sq * skv > PLAIN_LOGITS // 4  # fewer timed calls of a slow plain version
        t = {
            "sdpa": timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                         retain_graph=True)),
            "plain": timed_ms(lambda: tfa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                              *((3, 2) if big else (5,))),
            "whole": timed_ms(lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do)),
            "pre": timed_ms(lambda: tfa.flash_attention_bwd_pre(o, do, acc)),
            "pre_plain": timed_ms(lambda: tfa.attention_di(o, do)),
            "main": timed_ms(lambda: tfa.flash_attention_bwd_main(q, k, v, do, lse, di, acc,
                                                                  q_chunk, scale)),
        }
        if post:
            t["post"] = timed_ms(lambda: tfa.flash_attention_bwd_post(
                acc, dq, dk, dv, bool(dq_rows), bool(kv_rows)))
            t["post_plain"] = timed_ms(lambda: tfa.bwd_post_plain(
                acc, *plain, bool(dq_rows), bool(kv_rows)))
        common = {"shape": {"q": list(qs), "kv": list(ks)}, "dtype": dtype_name(dt),
                  "launches": launches, "q_chunk": q_chunk,
                  "accumulators": {"dq": bool(dq_rows), "dk_dv": bool(kv_rows)}}
        rows["flash_attn_bwd_pre"].append({
            **common, "max_abs_err": err_pre, "ms": t["pre"], "plain_ms": t["pre_plain"],
            "library_ms": None, "bound_ms": bounds["flash_attn_bwd_pre"][0],
            "bound_by": bounds["flash_attn_bwd_pre"][1]})
        rows["flash_attn_bwd"].append({
            **common, "max_abs_err": main_err, "tolerance_used": main_used, "ms": t["main"],
            "plain_ms": t["plain"], "library_ms": t["sdpa"],
            "bound_ms": bounds["flash_attn_bwd"][0], "bound_by": bounds["flash_attn_bwd"][1]})
        if post:
            rows["flash_attn_bwd_post"].append({
                **common, "max_abs_err": err_post, "ms": t["post"], "plain_ms": t["post_plain"],
                "library_ms": None, "bound_ms": bounds["flash_attn_bwd_post"][0],
                "bound_by": bounds["flash_attn_bwd_post"][1]})
        whole_rows.append({
            **common, "max_abs_err": whole_err, "tolerance_used": whole_used,
            "ms": t["whole"], "plain_ms": t["plain"], "sdpa_bwd_ms": t["sdpa"],
            "bound_ms": bounds["function"][0], "bound_by": bounds["function"][1],
            "k2_bound_ms": bounds["k2"][0], "k3_bound_ms": bounds["k3"][0],
            "kernel_ms": {k_: v_ for k_, v_ in t.items() if k_ in ("pre", "main", "post")}})
        log(f"backward {name} (q chunk {q_chunk}, accumulators dQ {bool(dq_rows)} dK/dV "
            f"{bool(kv_rows)}): whole {t['whole']:.4f} ms (pre {t['pre']:.4f}, kernel "
            f"{t['main']:.4f}" + (f", post {t['post']:.4f}" if post else "")
            + f"), bound {bounds['function'][0]:.4f} ({bounds['function'][1]}; kernel "
            f"{bounds['flash_attn_bwd'][0]:.4f}, TPU design K2 {bounds['k2'][0]:.4f} + K3 "
            f"{bounds['k3'][0]:.4f}), plain {t['plain']:.4f}, SDPA bwd {t['sdpa']:.4f}; max|diff| "
            f"{whole_err:.2e}, share of tolerance used {whole_used:.3f} (kernel by kernel "
            f"{main_used:.3f}, Di {err_pre:.1e}" + (f", post {err_post:.0e}" if post else "")
            + f"); {launches} launches")
        del out, qt, kt, vt, acc

    qs, skv = RUN_TO_RUN
    ks = (qs[0], skv, *qs[2:])
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for s in (qs, ks, ks, qs))
    o, lse = tfa.flash_attention_fwd(q, k, v)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    run_to_run = {}
    for n, a_, b_, w in zip(("dq", "dk", "dv"), first, second, want):
        run_to_run[n] = check_close(f"run to run {n} {qs} kv {skv}", b_, a_, bwd_tolerance(w))
    log(f"backward run to run at {qs} kv {skv} bf16: max|diff| between two runs "
        + ", ".join(f"{n} {e:.2e}" for n, e in run_to_run.items()))
    return rows, whole_rows, {"q": list(qs), "kv": skv, "max_abs_diff": run_to_run}


def attention_function_check(seed):
    """The autograd Function (K1 forward, the backward's kernels) against autograd
    of the plain forward on the same inputs and upstream gradient: in fp32
    at a UNet cross-attention shape, in bf16 at the update's 1024-token
    self- and cross-attention shapes with dO handed over as autograd gives
    it: contiguous (the UNet's reshape and output projection), as a
    (B, S, H, D) view of a (B, H, S, D) gradient (read in place) and with a
    strided last dim (copied first), and in bf16 at the ``RAGGED`` shapes."""
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    rand = lambda shape, dt: torch.randn(shape, generator=gen, device="cuda", dtype=dt)

    def project(o, g, w):  # the UNet's reshape and output projection
        b, s, h, d = o.shape
        return ((o.reshape(b, s, h * d) @ w).float() * g.float()).sum()

    # dO layout -> (loss of o, g and w; g's shape from q's (B, S, H, D);
    # what dO must be: (contiguous, read in place by the kernels))
    consumers = {
        "contiguous": (project, lambda b, s, h, d: (b, s, h * d), (True, True)),
        "strided": (lambda o, g, w: (o.transpose(1, 2).float() * g.float()).sum(),
                    lambda b, s, h, d: (b, h, s, d), (False, True)),
        "last_dim_strided": (lambda o, g, w: (o.transpose(2, 3).float() * g.float()).sum(),
                             lambda b, s, h, d: (b, s, d, h), (False, False)),
    }
    cases = [((8, 256, 20, 64), 77, torch.float32, "contiguous")]
    cases += [((8, 1024, 10, 64), skv, torch.bfloat16, layout)
              for skv in (1024, 77) for layout in consumers]
    cases += [(qs, skv, torch.bfloat16, "contiguous") for qs, skv in RAGGED]
    results = []
    for qs, skv, dt, layout in cases:
        b, sq, h, d = qs
        q, k, v = (rand(s, dt).requires_grad_() for s in (qs, (b, skv, h, d), (b, skv, h, d)))
        loss, g_shape, expect = consumers[layout]
        g, w = rand(g_shape(*qs), dt), rand((h * d, h * d), dt) / math.sqrt(h * d)
        seen = []
        o = tfa.flash_attention(q, k, v)
        o.register_hook(lambda grad: seen.append((grad.is_contiguous(), tfa._takes_layout(grad))))
        got = torch.autograd.grad(loss(o, g, w), (q, k, v))
        want = torch.autograd.grad(loss(tfa.flash_attention_plain(q, k, v)[0], g, w), (q, k, v))
        if seen != [expect]:
            raise AssertionError(f"dO {layout}: (contiguous, read in place) {seen} != {expect}")
        name = f"Function {dtype_name(dt)} q{qs} kv {skv} dO {layout}"
        tol = {n: grad_tolerance(f"d{n}", r, skv) for n, r in zip("qkv", want)}
        errs = {n: check_close(f"{name} d{n}", a, r, tol[n]) for n, a, r in zip("qkv", got, want)}
        used = max(tolerance_used(a, r, tol[n]) for n, a, r in zip("qkv", got, want))
        results.append({"q": list(qs), "kv": skv, "dtype": dtype_name(dt), "do": layout,
                        "max_abs_err": errs, "tolerance_used": used})
        log(f"FlashAttentionFunction grads vs autograd of the plain forward ({name}): max|diff| "
            + ", ".join(f"d{n} {e:.2e}" for n, e in errs.items())
            + f"; share of tolerance used {used:.3f}")
        del q, k, v, o, g, w, got, want
    return results


def gn_phase(shapes, seed):
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(xs, g, eps, dt, wdt, n) for (xs, g, eps, dt, wdt), n in shapes.items()]
    big = max(cases, key=lambda c: c[5])
    cases.append((big[0], big[1], big[2], torch.float32, torch.float32, 0))  # the fp32 case
    stats_rows, norm_rows = [], []
    for xs, g, eps, dt, wdt, launches in cases:
        x = torch.randn(xs, generator=gen, device="cuda", dtype=dt) * 1.5 + 0.25
        c = xs[1]
        w = (torch.randn(c, generator=gen, device="cuda") * 0.1 + 1).to(wdt)
        bias = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(wdt)
        tol = TOL["gn"][dtype_name(dt)]
        name = f"{tuple(xs)} G{g} eps{eps} {dtype_name(dt)}"
        part_k = tfg.group_stats(x, g)
        part_p = tfg.group_stats_plain(x, g)
        mk, vk = tfg.stats_from_partial(part_k, x, g)
        mp, vp = tfg.stats_from_partial(part_p, x, g)
        err4 = max(check_close(f"gn_stats mean {name}", mk, mp, tol),
                   check_close(f"gn_stats var {name}", vk, vp, tol))
        y_k = tfg.group_norm_silu_from_stats(x, part_k, w, bias, g, eps)
        y_p = tfg.group_norm_silu_from_stats_plain(x, part_k, w, bias, g, eps)
        err5 = check_close(f"gn_silu_norm {name}", y_k, y_p, tol)
        used4 = max(tolerance_used(mk, mp, tol), tolerance_used(vk, vp, tol))
        used5 = tolerance_used(y_k, y_p, tol)
        el = x.element_size()
        part_bytes = 4 * part_k.numel()
        b4, by4 = bound(x.numel() * el + part_bytes, GN_STATS_OPS * x.numel(), "fp32")
        b5, by5 = bound(2 * x.numel() * el + part_bytes + 2 * c * w.element_size(),
                        GN_NORM_OPS * x.numel(), "fp32")
        xv = x.view(xs[0] * g, -1)
        common = {"shape": {"x": list(xs), "groups": g, "eps": eps}, "dtype": dtype_name(dt),
                  "launches": launches}
        stats_rows.append({
            **common, "max_abs_err": err4, "tolerance_used": used4,
            "ms": timed_ms(lambda: tfg.group_stats(x, g)),
            "plain_ms": timed_ms(lambda: tfg.group_stats_plain(x, g)),
            "library_ms": timed_ms(lambda: torch.var_mean(xv, dim=-1, correction=0)),
            "bound_ms": b4, "bound_by": by4,
        })
        norm_rows.append({
            **common, "max_abs_err": err5, "tolerance_used": used5,
            "ms": timed_ms(lambda: tfg.group_norm_silu_from_stats(x, part_k, w, bias, g, eps)),
            "plain_ms": timed_ms(
                lambda: tfg.group_norm_silu_from_stats_plain(x, part_k, w, bias, g, eps)),
            "library_ms": None,
            "bound_ms": b5, "bound_by": by5,
            # yardstick for K4+K5 together: F.group_norm then F.silu (two calls)
            "pair_library_ms": timed_ms(lambda: F.silu(F.group_norm(x, g, w.to(dt), bias.to(dt),
                                                                    eps))),
        })
        s, n = stats_rows[-1], norm_rows[-1]
        log(f"gn {name}: stats max|diff| {err4:.2e} (share of tolerance used {used4:.3f}) "
            f"{s['ms']:.4f} ms (bound {b4:.4f}, plain {s['plain_ms']:.4f}, var_mean "
            f"{s['library_ms']:.4f}); norm+silu max|diff| {err5:.2e} ({used5:.3f}) "
            f"{n['ms']:.4f} ms (bound {b5:.4f}, plain {n['plain_ms']:.4f}); "
            f"F.group_norm+F.silu {n['pair_library_ms']:.4f} ms; {launches} launches each")
    return {"gn_stats": stats_rows, "gn_silu_norm": norm_rows}


def summarize(name, rows, launches):
    """One kernel's line entry: times and bound as launch-weighted means per
    launch over the main path's shape mix; max_abs_err over every case."""
    src, replaces = KERNELS[name]
    on_path = [r for r in rows if r["launches"]]
    total = sum(r["launches"] for r in on_path)
    mean = lambda key: (sum(r[key] * r["launches"] for r in on_path) / total
                        if all(r[key] is not None for r in on_path) else None)
    bytes_share = sum(r["launches"] * r["bound_ms"] for r in on_path if r["bound_by"] == "bytes")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if bytes_share * 2 >= sum(r["launches"] * r["bound_ms"]
                                                      for r in on_path) else "operations",
        "library_ms": mean("library_ms"),
        "shapes": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(card.splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    build_s = kernel_lib.build()
    log(f"kernels built in {time.perf_counter() - t:.1f} s: {build_s}")
    for log_file in sorted(kernel_lib.build_dir().glob("*.log")):
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {log_file.stem}: {line.strip()}")

    small = small_reference(args.seed)
    slice_summary = full_slice(args.seed)
    # the main paths whose shapes the kernel phases check: each sets the
    # counts to 0 just before its run and checks them just after
    recorder = ShapeRecorder()
    train_summary, metrics_jsonl = train_slice(args.seed, "turbo", recorder)
    dmd_summary, dmd_metrics_jsonl = train_slice(args.seed, "dmd", recorder)
    eval_summary = eval_slice(args.seed, recorder)
    paths = {"turbo_loop": train_summary["launches"], "dmd_loop": dmd_summary["launches"],
             "dmd_eval": eval_summary["launches"]}
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    bwd_rows, bwd_whole, run_to_run = attention_bwd_phase(recorder.attention_bwd, args.seed)
    rows = {**attention_phase(recorder.attention, args.seed), **bwd_rows,
            **gn_phase(recorder.gn, args.seed)}
    function_errs = attention_function_check(args.seed)
    kernels = [summarize(name, rows[name], launches[name]) for name in KERNELS]

    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "small_reference": small, "slice": slice_summary,
              "train": train_summary, "dmd_train": dmd_summary, "eval": eval_summary,
              "launches_by_path": paths, "function_check": function_errs, "kernels": kernels,
              "backward": bwd_whole, "backward_run_to_run": run_to_run,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    (out / "train_metrics.jsonl").write_text(metrics_jsonl)
    (out / "dmd_train_metrics.jsonl").write_text(dmd_metrics_jsonl)
    log(f"chip_smoke done in {record['seconds']:.1f} s; launches by path {paths}")
    log(card.splitlines()[0])
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "shapes"}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
