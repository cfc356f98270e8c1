#!/usr/bin/env python3
"""Drive the PyTorch port of online PSO (serving and update) on one NVIDIA H100.

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
   rebuild from the seed), and the checkpoint written at step 1 must
   restore. Prints sample / update / microbatch ms, pairs/s of the loop
   and peak memory;
6. one phase per kernel at every shape the loop gave it (recorded during
   step 5) in bf16, plus one fp32 case and, for the attention kernels,
   the bf16 ragged lengths of ``RAGGED`` (and, for the forward, of
   ``RAGGED_FWD`` at head dims 80 and 512; 0 launches): the kernel against
   its plain version on the same inputs (|diff| <= atol + rtol*|plain|,
   atol = rtol unless stated: attention forward 2e-3 fp32 and in bf16 rtol
   1e-2 with an atol of 5% of the plain O's rms, see ``fwd_tolerance``,
   its fp32 logsumexp atol 2e-3; attention backward 1e-4 fp32 and in bf16
   rtol 1e-2 with an atol of 5% of the plain gradient's rms, see
   ``bwd_tolerance`` and ``grad_tolerance``; GroupNorm+SiLU 3e-2 / 2e-4),
   and CUDA-event device times of
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (timed here only; the port never calls it):
   SDPA forward for K1, autograd of SDPA (dQ, dK, dV in one backward) for
   K2 and K3. Back-to-back calls on one input: an input under the 50 MB L2
   stays there, as a GroupNorm input just written by a conv does. Also the
   autograd Function's gradients against autograd of the plain forward:
   at one UNet shape in fp32, and in bf16 at the update's 1024-token
   self- and cross-attention shapes, with the upstream gradient handed
   over contiguous (as the UNet's reshape and output projection give it),
   as a strided view and with a strided last dim (copied first), and in
   bf16 at the ``RAGGED`` shapes;
7. prints the ``{"kernels": [...]}`` line, then, last, the device line.

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
       "gn": {"bf16": (3e-2, 3e-2), "fp32": (2e-4, 2e-4)}}
# bf16 head-dim-64 attention cases off the main path (0 launches): (q shape, kv
# length). Every main-path length but kv 77 is a multiple of 64, so only these
# reach the zero-filled and masked edges of the q and kv tiles.
RAGGED = (((2, 1000, 3, 64), 77), ((1, 200, 5, 64), 1000), ((1, 1, 2, 64), 1))
# The same for the forward's own tilings at PickScore's and the VAE's head
# dims (forward only: the backward takes d = 64).
RAGGED_FWD = (((2, 1000, 3, 80), 77), ((1, 1, 2, 80), 1), ((1, 1000, 1, 512), 77),
              ((2, 200, 1, 512), 1000))
KERNELS = {
    "flash_attn_fwd": ("pairwise_sample_optimization_tpu_torch/csrc/flash_attn_fwd.cu",
                       "pairwise_sample_optimization_tpu/ops/flash_attention.py:99"),
    "flash_attn_bwd_dkv": ("pairwise_sample_optimization_tpu_torch/csrc/flash_attn_bwd.cu",
                           "pairwise_sample_optimization_tpu/ops/flash_attention.py:193"),
    "flash_attn_bwd_dq": ("pairwise_sample_optimization_tpu_torch/csrc/flash_attn_bwd.cu",
                          "pairwise_sample_optimization_tpu/ops/flash_attention.py:244"),
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


def expected_launches(pipe, steps):
    """Launches of one ``sample_pairs`` call: ``steps`` UNet forwards, the
    VAE decode (its mid-block attention) and the PickScore vision tower."""
    vcfg = pipe.vae.config
    attn, gn_unet, _, _ = _unet_counts(pipe.unet.config)
    vae_resnets = 2 + len(vcfg.block_out_channels) * (vcfg.layers_per_block + 1)
    vision_layers = pipe.scorer.model.vision_config.layers
    k1 = steps * attn + 1 + vision_layers
    gn = steps * gn_unet + 2 * vae_resnets + 1
    return {"flash_attn_fwd": k1, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
            "gn_stats": gn, "gn_silu_norm": gn}


def expected_update_launches(ucfg, n_micro, fuse_ref_pass):
    """Launches of one optimizer update of ``n_micro`` microbatches. Per
    microbatch: the policy forward (with grad), its recompute under remat
    "full" and, unless fused into the policy call, the reference forward
    (no grad); K2 and K3 once per attention call in the backward. Under
    remat the ResnetBlocks that run before the first attention are not
    recomputed: nothing in them depends on the LoRA, so they save nothing
    for the backward. The GroupNorm+SiLU backward is the plain version."""
    attn, gn, resnets, grad_free = _unet_counts(ucfg)
    remat = ucfg.remat == "full"
    passes = 1 + (0 if fuse_ref_pass else 1)
    k1 = attn * (passes + remat)
    k45 = gn * passes + (2 * (resnets - grad_free) if remat else 0)
    return {"flash_attn_fwd": n_micro * k1, "flash_attn_bwd_dkv": n_micro * attn,
            "flash_attn_bwd_dq": n_micro * attn, "gn_stats": n_micro * k45,
            "gn_silu_norm": n_micro * k45}


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


def train_slice(seed):
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import (latest_checkpoint,
                                                                    restore_train_state)
    from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_dir, run_online_pso
    from pairwise_sample_optimization_tpu_torch.configs.sdxl_turbo_dpo import get_config
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                              make_optimizer)

    config = get_config()
    config.seed = seed
    config.output_dir = str(RUN_DIR)
    config.run_name = "online_turbo"
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t_cfg, s_cfg = config.train, config.sample
    pairs = s_cfg.batch_size * s_cfg.num_batches_per_epoch
    n_updates = pairs // (t_cfg.batch_size * t_cfg.gradient_accumulation_steps)
    n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with ShapeRecorder() as recorder:
        state, history, pipe = run_online_pso(config, num_epochs=1, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(kernel_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    out_dir = Path(run_dir(config))

    want = {k: s_cfg.num_batches_per_epoch * v
            for k, v in expected_launches(pipe, s_cfg.num_steps).items()}
    upd = expected_update_launches(pipe.unet.config, n_micro, bool(t_cfg.fuse_ref_pass))
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

    metrics_jsonl = (out_dir / "metrics.jsonl").read_text()
    metrics = [json.loads(line) for line in metrics_jsonl.splitlines()]
    times = next(m for m in metrics if "loss" in m)
    sample_ms, train_ms = times["time/sample_s"] * 1e3, times["time/train_s"] * 1e3
    summary = {
        "pairs": pairs, "updates": n_updates, "microbatches_per_update": n_micro,
        "policy_batch": 2 * t_cfg.batch_size, "remat": config.activation_checkpoint,
        "history": history, "launches": counts, "expected_launches": want,
        "sample_ms": sample_ms, "update_ms": train_ms / n_updates,
        "microbatch_ms": train_ms / n_updates / n_micro,
        "loop_pairs_per_s": pairs / (sample_ms + train_ms) * 1e3, "wall_s": wall_s,
        "peak_bytes": peak, "checkpoint": Path(ckpt).name, "lora_max_abs_delta": lora_moved,
        "checksums": checksums,
    }
    log(f"online PSO loop (1 epoch, {pairs} pairs, {n_updates} updates x {n_micro} "
        f"microbatches): sample {sample_ms:.1f} ms, update {summary['update_ms']:.1f} ms, "
        f"microbatch {summary['microbatch_ms']:.1f} ms, {summary['loop_pairs_per_s']:.3f} "
        f"pairs/s of the loop, peak {peak / 2**30:.2f} GiB; losses "
        f"{[round(m['loss'], 6) for m in history]}, grad_norm "
        f"{[round(m['grad_norm'], 6) for m in history]}; launches {counts}; LoRA max|delta| "
        f"{lora_moved:.3e}, frozen unchanged; restored {summary['checkpoint']}")
    del pipe, state, ref, restored, frozen, frozen0, lora, lora0, lora_ref
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary, recorder, metrics_jsonl


# ---------------------------------------------------------------------- #
# kernel phases
# ---------------------------------------------------------------------- #


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
        o_p, lse_p = tfa.flash_attention_plain(q, k, v)
        tol, tol_lse = fwd_tolerance(o_p), TOL["attention_lse"]
        err = max(check_close(f"attention {qs} kv {ks[1]} {dtype_name(dt)}", o_k, o_p, tol),
                  check_close(f"attention lse {qs} {dtype_name(dt)}", lse_k, lse_p, tol_lse))
        used = {"o": tolerance_used(o_k, o_p, tol), "lse": tolerance_used(lse_k, lse_p, tol_lse)}
        b, sq, h, d = qs
        skv = ks[1]
        bytes_moved = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse_k.numel()
        bound_ms, bound_by = bound(bytes_moved, 4 * b * h * sq * skv * d, dtype_name(dt))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "shape": {"q": list(qs), "kv": list(ks)}, "dtype": dtype_name(dt),
            "launches": launches, "max_abs_err": err, "tolerance_used": used,
            "ms": timed_ms(lambda: tfa.flash_attention_fwd(q, k, v)),
            "plain_ms": timed_ms(lambda: tfa.flash_attention_plain(q, k, v)),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(row)
        log(f"flash_attn_fwd {row['dtype']} q{qs} kv{skv}: max|diff| {err:.2e}, share of "
            f"tolerance used O {used['o']:.3f} (atol {tol[0]:.2e}) LSE {used['lse']:.3f}, "
            f"{row['ms']:.4f} ms vs bound {bound_ms:.4f} ({bound_by}), plain "
            f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, {launches} launches")
    return {"flash_attn_fwd": rows}


def attention_bwd_phase(shapes, seed):
    """K2 and K3 at every (q, kv, dtype) the update gave the backward, plus
    one fp32 case, against ``flash_attention_bwd_plain``."""
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cases = [(q, k, dt, n) for (q, k, dt), n in shapes.items()]
    q0, k0, _, _ = max(cases, key=lambda c: (c[3], c[0][1] * c[1][1]))
    cases.append((q0, k0, torch.float32, 0))  # the fp32 case, off the main path
    cases += [(qs, (qs[0], skv, *qs[2:]), torch.bfloat16, 0) for qs, skv in RAGGED]
    dkv_rows, dq_rows = [], []
    for qs, ks, dt, launches in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=dt) for s in (qs, ks, ks))
        do = torch.randn(qs, generator=gen, device="cuda", dtype=dt)
        o, lse = tfa.flash_attention_fwd(q, k, v)
        di = tfa.attention_di(o, do)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, di)
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, di)
        dq_p, dk_p, dv_p = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        name = f"{qs} kv {ks[1]} {dtype_name(dt)}"
        tol = {n: grad_tolerance(n, w, ks[1]) for n, w in (("dq", dq_p), ("dk", dk_p),
                                                            ("dv", dv_p))}
        err_kv = max(check_close(f"dk {name}", dk, dk_p, tol["dk"]),
                     check_close(f"dv {name}", dv, dv_p, tol["dv"]))
        err_q = check_close(f"dq {name}", dq, dq_p, tol["dq"])
        used_kv = max(tolerance_used(dk, dk_p, tol["dk"]), tolerance_used(dv, dv_p, tol["dv"]))
        used_q = tolerance_used(dq, dq_p, tol["dq"])
        grad_scale = {n: {"mean_abs": w.float().abs().mean().item(),
                          "rms": w.float().pow(2).mean().sqrt().item(), "atol": tol[n][0]}
                      for n, w in (("dq", dq_p), ("dk", dk_p), ("dv", dv_p))}
        b, sq, h, d = qs
        el, pair = q.element_size(), 2 * b * h * sq * ks[1] * d
        inputs = el * (2 * q.numel() + 2 * k.numel()) + 4 * 2 * lse.numel()  # q, do, k, v, lse, Di
        b2, by2 = bound(inputs + el * 2 * k.numel(), 4 * pair, dtype_name(dt))
        b3, by3 = bound(inputs + el * q.numel(), 3 * pair, dtype_name(dt))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        sdpa_bwd = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
        plain = timed_ms(lambda: tfa.flash_attention_bwd_plain(q, k, v, o, lse, do), reps=5)
        common = {"shape": {"q": list(qs), "kv": list(ks)}, "dtype": dtype_name(dt),
                  "launches": launches, "plain_ms": plain, "library_ms": sdpa_bwd,
                  "grad_scale": grad_scale}
        dkv_rows.append({**common, "max_abs_err": err_kv, "tolerance_used": used_kv,
                         "bound_ms": b2, "bound_by": by2,
                         "ms": timed_ms(lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, di))})
        dq_rows.append({**common, "max_abs_err": err_q, "tolerance_used": used_q,
                        "bound_ms": b3, "bound_by": by3,
                        "ms": timed_ms(lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, di))})
        r2, r3 = dkv_rows[-1], dq_rows[-1]
        log(f"flash_attn_bwd {name}: K2 max|diff| {err_kv:.2e} {r2['ms']:.4f} ms (bound {b2:.4f} "
            f"{by2}); K3 max|diff| {err_q:.2e} {r3['ms']:.4f} ms (bound {b3:.4f} {by3}); "
            f"share of tolerance used K2 {used_kv:.3f} K3 {used_q:.3f}; (mean|grad|, rms, atol) "
            + ", ".join(f"{n} ({g['mean_abs']:.3e}, {g['rms']:.3e}, {g['atol']:.2e})"
                        for n, g in grad_scale.items())
            + f"; plain bwd {plain:.4f}, SDPA bwd {sdpa_bwd:.4f}; {launches} launches each")
        del out, qt, kt, vt
    return {"flash_attn_bwd_dkv": dkv_rows, "flash_attn_bwd_dq": dq_rows}


def attention_function_check(seed):
    """The autograd Function (K1 forward, K2/K3 backward) against autograd
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
        el = x.element_size()
        part_bytes = 4 * part_k.numel()
        b4, by4 = bound(x.numel() * el + part_bytes, GN_STATS_OPS * x.numel(), "fp32")
        b5, by5 = bound(2 * x.numel() * el + part_bytes + 2 * c * w.element_size(),
                        GN_NORM_OPS * x.numel(), "fp32")
        xv = x.view(xs[0] * g, -1)
        common = {"shape": {"x": list(xs), "groups": g, "eps": eps}, "dtype": dtype_name(dt),
                  "launches": launches}
        stats_rows.append({
            **common, "max_abs_err": err4,
            "ms": timed_ms(lambda: tfg.group_stats(x, g)),
            "plain_ms": timed_ms(lambda: tfg.group_stats_plain(x, g)),
            "library_ms": timed_ms(lambda: torch.var_mean(xv, dim=-1, correction=0)),
            "bound_ms": b4, "bound_by": by4,
        })
        norm_rows.append({
            **common, "max_abs_err": err5,
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
        log(f"gn {name}: stats max|diff| {err4:.2e} {s['ms']:.4f} ms (bound {b4:.4f}, plain "
            f"{s['plain_ms']:.4f}, var_mean {s['library_ms']:.4f}); norm+silu max|diff| "
            f"{err5:.2e} {n['ms']:.4f} ms (bound {b5:.4f}, plain {n['plain_ms']:.4f}); "
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
    train_summary, recorder, metrics_jsonl = train_slice(args.seed)
    launches = train_summary["launches"]
    rows = {**attention_phase(recorder.attention, args.seed),
            **attention_bwd_phase(recorder.attention_bwd, args.seed),
            **gn_phase(recorder.gn, args.seed)}
    function_errs = attention_function_check(args.seed)
    kernels = [summarize(name, rows[name], launches[name]) for name in KERNELS]

    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "small_reference": small, "slice": slice_summary,
              "train": train_summary, "function_check": function_errs, "kernels": kernels,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    (out / "train_metrics.jsonl").write_text(metrics_jsonl)
    log(f"chip_smoke done in {record['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "shapes"}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
