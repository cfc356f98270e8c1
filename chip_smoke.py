#!/usr/bin/env python3
"""Drive the PyTorch port of PSO (every path, SD1.x included) on an H100.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --distributed-cards N   # step 11 alone, one rank a card, NCCL;
                                                  # its record on one line before the last

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
   peak memory. Then a checkpoint round trip: the pipeline's towers
   (rounded to fp16 values in place first) are written as a diffusers
   checkpoint directory in fp16 (``unet/diffusion_pytorch_model.fp16.
   safetensors``, ``vae/...``, ``text_encoder/model.fp16.safetensors``,
   ``text_encoder_2/...``, in a temporary directory under
   ``chip_smoke_runs/``, removed afterwards) and read back through
   ``SDXLPipeline.from_torch_dir``: every weight must equal the original,
   the LoRA exported and imported back must equal it, and generation with
   the same noise must give the same images. Prints the write and load
   seconds and the host's peak resident memory over the round trip. The
   serving pipelines are freed afterwards;
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
   ``load_file``) must equal the LoRA that checkpoint restores. Validation
   runs at step 2 (``validation_steps = 2``, ``val_max_prompts = 8`` of
   ``val_dataset = hf:<FIXTURE>``, the ``test_unique`` split of a committed
   ``save_to_disk`` export read by the port's Arrow reader, which must give
   the first 8 packaged ImageReward prompts; two chunks of 4 prompts, 4-step
   generation with the live adapter, PickScore and a CLIP-H scorer):
   ``val/pickscore`` and ``val/clip_score`` must be
   logged and finite, and ``val-2/`` must hold five PNGs. The ``lora-1``
   file is imported (``import_lora_safetensors``) into a fresh UNet, whose
   adapter must equal checkpoint-1's, and ``cli.generate`` runs twice at
   full width on the same random weights and prompts, once with
   ``--lora_path`` of that file: the images must differ. Prints
   sample / update / microbatch / validation ms, pairs/s of the loop and
   peak memory;
6. the same for SDXL-DMD2 (``run_online_pso(sampler="dmd")``,
   ``configs/sdxl_dmd_dpo.py``): 1024^2, 4 pair batches of 2 prompts = 8
   pairs, 2 updates of 4 x 3 microbatches (policy pass at batch 2, remat
   "full", a grad-free reference pass), LoRA rank 16, the transition noise
   shared within each trajectory side; the same checks (first loss log 2),
   no validation;
7. the PickaPic eval protocol, ``cli.evaluate_sdxl_dmd2`` at full width and
   1024^2: the first 8 packaged ImageReward prompts at batch 2, scored by
   PickScore, CLIP score, HPS (ViT-H/14 towers), the aesthetic scorer
   (CLIP-L/14, the released MLP) and ImageReward (BLIP ViT-L/16 and BERT,
   on a WordPiece vocabulary the script writes); launch counts as implied
   (ImageReward's 24 ViT self-attention and 12 BERT cross-attention
   launches a batch among them), scores finite, and the first two prompts
   run again at batch 1 must score the same within ``TOL["eval_batch"]``,
   and the 8 prompts again, read from the committed ``save_to_disk``
   export ``FIXTURE`` (``--hf_dataset``, its ``test_unique`` split: the
   same 8 prompts, through the port's Arrow reader) with ``--score_chunk 4
   --offload_scorers --vae_decode_chunk 1``, must score bit for bit as the
   first run (at 1024^2 the default decodes one image a call too). Prints
   prompts/min and peak memory;
8. DreamBooth PSO through its entry point,
   ``cli.train_pso_sdxl_turbo_dreambooth.main``, at full width and 512^2
   (random weights, bf16 towers, fp32 LoRA rank 16, remat "full") on four
   instance PNGs of non-square sizes the script writes with the port's PNG
   writer (so the reader, the bicubic resize and the random crops run on
   real files): run A, the reference workload's shape (``pso_db``,
   ``euler_edm``, batch 1, 4 accumulation steps, 4 self-generated
   negatives, checkpoints and a 25-prompt validation every 2 steps) to
   step 2, then resumed from ``latest`` to step 3; run B (``pso`` with its
   reference pass fused at policy batch 8, ``edm``, prior preservation
   with 4 class images generated into the class directory as PNGs and read
   back, 2 accumulation steps, ``--use_wandb`` with the import of wandb
   blocked: a warning and ``metrics.jsonl``), one step. Launch counts as
   ``expected_dreambooth_launches`` implies (VAE encoder calls, the
   negatives', class images' and validation's generations, the updates),
   losses finite, the resumed run starting at step 2, the LoRA moved and
   the frozen UNet unchanged, run B's first loss minus its prior term log 2
   within 1e-3, ``lora-2`` / ``lora-3`` equal to their checkpoints'
   adapters, 25 PNGs under ``gen_2/``. Run C (``pso`` with DoRA adapters,
   so its reference pass is a forward of its own at LoRA scale 0,
   text-encoder LoRA, Prodigy, the kohya export; 2 accumulation steps, 2
   steps, no validation (run A's covers it; the script runs within a time
   limit)): launch counts, its first loss
   minus the prior term log 2 within 1e-3, every adapter and DoRA magnitude
   moved and every frozen weight (UNet and text encoders) bit-equal to a
   rebuild, Prodigy's d finite and at least d0, ``lora-2`` holding the
   ``unet.`` / ``text_encoder.`` / ``text_encoder_2.`` tensors of
   ``checkpoint-2``, the kohya file's keys the diffusers file's mapped
   (``.alpha`` 16); each optimizer's step (fp32 AdamW, bf16 first moments,
   8-bit AdamW, Prodigy, and full finetuning's per-tensor 8-bit AdamW)
   timed over run C's adapters and held against the
   same two steps on the CPU (int8 state and scales bit-equal, parameters
   within 1e-6), and a ``pso``
   microbatch timed with DoRA on and off. Run D (``pso_db``, the 8-bit
   AdamW in two groups, text-encoder LoRA), one step: launch counts, int8
   moments on the card, a finite loss. Prints s per optimizer step (steady
   steps, synchronized), the negatives' and the encodes' s, the
   validation's s and peak memory;
9. the remat modes (``remat_phase``): one Turbo update microbatch at full
   width, 512^2, policy batch 8, under "full" (twice: the spread of the two
   sets the tolerance), "", "resnets", "dots", "lowres" and "lowres_dots":
   launch counts as each mode implies, peak memory, CUDA-event and wall ms
   (medians of ``REMAT_REPS``), each LoRA gradient tensor within a relative
   difference of ``REMAT_TOL_FACTOR`` x the largest between the two "full"
   runs of the first "full" run's, the loss likewise;
10. full finetuning (``full_finetune_slice``): ``run_online_pso`` with
   ``use_lora=False``, fp32 masters and ``offload_aux_during_update`` for 2
   epochs of 2 pairs at 512^2 (run A, the per-tensor AdamW), the
   whole-UNet train state (~31 GB) written after update 1, restored into a
   fresh run bit for bit and resumed for one epoch at step 2, then deleted;
   1 epoch without the offload; run C, 2 epochs with the per-tensor 8-bit
   AdamW and ``profile_dir``, whose second epoch's trace must hold the
   hand-written kernels' events. Runs A and C: launch counts, the first
   loss log 2, every weight with a gradient moved, the frozen reference
   copy bit-equal to the seed's weights, the VAE, scorer and text encoders
   in pinned host memory during each update and back after it, the second
   epoch sampled by the updated weights, the second update starting within
   0.5 GiB of the first's allocated bytes (no gradients held over); peaks
   with and without the offload, update and offload seconds, the
   optimizers' resting bytes, the checkpoint's size, write and read
   seconds and the host's peak resident memory;
10b. the opt-in int8 and subpixel paths and ``fast_init`` (``int8_slice``;
   each run's launch counts the formula's, the int8 kernels' too): the
   Turbo loop with ``train.int8_ref_pass`` (``INT8_TURBO``, 2 epochs), the
   reference pass's eps and log-prob gap to bf16 and its ms; DMD2 sampling
   at 1024^2 with ``kernels.int8_vae_decode``, a decode in bf16, int8 and
   int8 with ``int8_smooth_alpha`` (pixels' relative L2 to bf16); PickScore
   under the int8 scorer override (features' cosine to bf16); a DMD2
   update with ``kernels.subpixel_upsample`` against the naive path (loss,
   grad_norm, the LoRA step's cosine; ms of each); ``run_online_pso`` with
   ``fast_init`` (every tower zero, a finite loss);
11. data parallelism (``distributed_slice``): two processes of this script
   (``--distributed-worker``), both on the card, form a gloo group (NCCL
   refuses two ranks on one device) and run the Turbo loop at full width
   through ``run_online_pso``, 1 prompt a rank and one update of 3
   microbatches of policy batch 2 over the global 2 pairs: the ranks' LoRA
   bit-identical after it, their prompts different, the first loss log 2
   within 1e-3 on both, each rank's launch counts the formula's at its own
   batch, rank 0 alone writing the metrics, the checkpoint and the LoRA
   file; then ``train_epoch`` of the small fp32 pipeline of step 3 at world
   2 over the halves of a seeded sample set must agree with world 1 over
   the whole set to 2e-3; then NCCL at world 1 (through the launch
   contract) on CUDA tensors of the LoRA gradients' sizes: the mean, the
   gather and the broadcast bit-equal to their inputs. A rank that fails or
   does not end in time fails the phase. Prints per rank the sample and
   update ms, the all-reduce's, gather's and broadcast's ms and bytes, the
   peak memory, and the most memory the card held at once. Before the ranks
   start, a Turbo epoch at ``SHARDED_CONFIG`` (smaller, every LoRA ``up``
   drawn non-zero) at world 1 on the card (its LoRA gradient and step
   recorded); after the data-parallel run the ranks run that epoch
   data-parallel twice and under each mesh of ``SHARDED_ONE_CARD``: tensor
   parallelism at data 1 x model 2 (the UNet's attention and feed-forward
   sliced, K1 and the backward on each rank's 5 / 10 local heads; with
   ``train.int8_ref_pass``, as its world-1 run, so one run takes TP's bf16
   policy pass and its int8 reference pass) and FSDP over 2 (the
   frozen suite sharded, gathered per module). Each: launch
   counts the formula's at the rank's local heads, one update, a finite
   loss, the ranks' whole LoRA and metrics the same, the model ranks'
   prompts the same, rank 0's checkpoint and LoRA file holding the whole
   LoRA; TP against world 1: every LoRA tensor's gradient within
   ``TP_GRAD_RTOL`` of its norm plus its even share of the whole gradient's
   (checked before the ranks' sameness), the AdamW step's cosine at least
   ``TP_STEP_COSINE``; TP's UNet at most 0.7 of a replica's resident bytes;
   FSDP against the data-parallel run: the epoch's rewards and the update's
   loss and ratio_win bit-identical (the gathers are exact), the gradient
   within ``FSDP_SPREAD_FACTOR`` times the spread of the data-parallel run
   run again (whose forwards must be bit-identical to the first's: the
   backward kernel's sums come in another order each run), its frozen
   suite at most 0.6 of a replica's bytes. Prints per rank the resident bytes (beside
   ``sharding_prediction``'s from the parameter counts), the activation
   all-reduces' and weight gathers' calls, ms and bytes. With
   ``--distributed-cards 4`` (on a machine with four cards, this step
   alone, one rank a card over NCCL) the meshes are
   ``SHARDED_FOUR_CARDS``: 2 x 2, 1 x 4 (held against world 1 on card 0)
   and FSDP over 4;
11b. the SD1.x family (``sd15_slice``): the SD1.5 UNet at full width
   (``UNetConfig.sd15``, 860 M parameters, 8 fixed heads: attention at head
   dims 40, 80 and 160; random bf16 weights, LoRA rank 4 with ``up`` drawn
   non-zero), 2 prompts with CFG at guidance ``SD15_GUIDANCE`` (one UNet
   call of batch 4 a step, random 77 x 768 contexts), 20 DDIM steps (eta 1)
   at 512^2 on diffusers' leading spacing (``SD15_TIMESTEPS``) through
   ``train.sampling.sample_ddim_cfg_trajectories``: latents and log-probs
   finite, each log-prob equal to the step recomputed from its stored
   transition, launch counts the formula's (K1 32 a UNet call: 10 at
   d = 40, 10 at 80, 12 at 160; K4 / K5 45), the rollout's ms and the
   card's busy share (``torch.profiler``); then the gradient of the mean
   log-prob of two stored transitions with respect to the LoRA tensors
   (``sd15_grad``: launch counts; finite, non-zero LoRA gradients, none on
   a frozen weight; held against the same gradient through the plain
   attention on the card, within ``SD15_GRAD_SPREAD_FACTOR`` times the
   spread of two plain runs whose sums differ in order); then a small fp32
   SD1.x UNet whose head dims are the kernels' own (one head over 40, 80,
   160 channels) on the card and on the CPU: a 3-step CFG-DDIM rollout
   equal to 2e-3;
12. one phase per kernel at every shape steps 5-11b gave it (recorded during
   those runs) in bf16, plus one fp32 case and, for the attention kernels,
   the bf16 ragged lengths of ``RAGGED`` (and, for the forward, of
   ``RAGGED_FWD`` at head dims 80 and 512; 0 launches) and the local heads
   of tensor parallelism off the one-card path (``TP_LOCAL``: model 4 at
   the Turbo loop's token counts, model 2 and 4 at the DMD2 loop's; 0
   launches), the SD1.x head dims' ragged lengths (``RAGGED_SD15``) and
   their cross-attention shapes in fp32 (0 launches): the kernel against
   its plain version on the same inputs (ImageReward's two shapes, the ViT's
   self-attention (B, 197, 16, 64) and BERT's cross-attention (B, 35, 12,
   64) over 197 keys, among them; |diff| <= atol + rtol*|plain|,
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
   kernels) beside the function's bound, with launch-weighted means per
   head dim, and the backward twice at each ``RUN_TO_RUN`` shape (head
   dims 64 and 40) with the max|diff| between the two runs (its sums over
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
   tokens). GroupNorm rows report the share of the limit used. The
   attention forward's times are also printed per head dim. The int8
   kernels (``int8_phase``) at every shape the paths gave them and at the
   512^2 VAE decode's (``int8_off_path_shapes``, 0 launches): absmaxes,
   integers, scales and outputs equal to the plain versions' bit for bit;
   per ``torch._int_mm`` shape the whole int8 matmul beside bf16
   ``torch.matmul``;
13. prints the card line again, the ``{"kernels": [...]}`` line (launches:
   the sum over the runs of steps 5-11b, the sharded runs' and the world-1
   run's of step 11 among them; K1 at head dims 40 and 160 and the backward
   at 40, 80 and 160 as entries of their own, ``HEAD_DIM_ENTRIES``), then,
   last, the device line.

Any failure raises, and the script exits non-zero. It also exits non-zero,
printing no result, where CUDA or the port's package is missing. The full
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import logging
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "chip_smoke_runs"  # the training run's checkpoints (git-ignored, removed)

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense): device memory
# rate, bf16 tensor-core rate, fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
GN_STATS_OPS, GN_NORM_OPS = 3, 8  # fp32 operations per element of K4, K5
# (atol, rtol); in bf16 see fwd_tolerance and bwd_tolerance
TOL = {"attention": {"bf16": (5e-2, 1e-2), "fp32": (2e-3, 2e-3)},
       "attention_lse": (2e-3, 0.0),  # the fp32 logsumexp of either dtype
       "attention_bwd": {"bf16": (5e-2, 1e-2), "fp32": (1e-4, 1e-4)},
       # the pre kernel's Di against attention_di: fp32 sums of 64 products in
       # another order (each within ~64 ulps of the sum of their magnitudes)
       "attention_di": (1e-4, 1e-5),
       "gn": {"bf16": (3e-2, 3e-2), "fp32": (2e-4, 2e-4)},
       # a DDIM log-prob recomputed from its stored transition and the eps it was
       # taken with: only (x_prev - mean) against std * noise differs, by rounding
       "sd15_logprob": (1e-4, 1e-4),
       # an eval score at batch 2 against the same prompt's at batch 1 (bf16):
       # the noise is the same, the kernels cuBLAS and cuDNN pick may not be
       "eval_batch": (1e-2, 1e-2)}
EVAL_PROMPTS = 8  # packaged ImageReward prompts in the eval phase
# a local HF datasets save_to_disk export: its test_unique split holds the first
# 8 packaged ImageReward prompts (the Turbo loop's validation, the chunked eval)
FIXTURE = ROOT / "tests" / "fixtures" / "pickapic_test_unique_export"
VALIDATION = {"validation_steps": 2, "val_max_prompts": 8, "val_dataset": f"hf:{FIXTURE}",
              "val_split_name": "test_unique"}  # the Turbo loop's validation
# the diffusers checkpoint layout of the round trip: folder, file, pipeline tower
TOWER_FILES = (("unet", "diffusion_pytorch_model.fp16.safetensors", "unet"),
               ("vae", "diffusion_pytorch_model.fp16.safetensors", "vae"),
               ("text_encoder", "model.fp16.safetensors", "te1"),
               ("text_encoder_2", "model.fp16.safetensors", "te2"))
# the plain attention forward runs over slices of the batch of at most this
# many fp32 logits (1 GiB): 16384 VAE tokens at batch 4 would be 4.3 GB at once
PLAIN_LOGITS = 2**28
# bf16 head-dim-64 attention cases off the main path (0 launches): (q shape, kv
# length). Every main-path length but kv 77 is a multiple of 64, so only these
# reach the zero-filled and masked edges of the q and kv tiles.
RAGGED = (((2, 1000, 3, 64), 77), ((1, 200, 5, 64), 1000), ((1, 1, 2, 64), 1))
# The same for the forward's own tilings at PickScore's and the VAE's head
# dims (forward only: the backward takes d = 64).
# the local heads of tensor parallelism off the one-card run's path (0
# launches): d = 64 at model 4 (SDXL's 10 heads -> 3 / 2, 20 -> 5) at the
# Turbo loop's token counts (4096 and 1024 self, 77 cross; batch 2), and at
# model 2 and 4 at the DMD2 loop's (16384 and 4096; batch 1)
TP_LOCAL = tuple(((b, s, h, 64), skv) for b, levels in (
    (2, ((4096, (3, 2)), (1024, (5,)))), (1, ((16384, (5, 3, 2)), (4096, (10, 5)))))
    for s, heads in levels for h in heads for skv in (s, 77))
RAGGED_FWD = (((2, 1000, 3, 80), 77), ((1, 1, 2, 80), 1), ((1, 1000, 1, 512), 77),
              ((2, 200, 1, 512), 1000))
_BWD_SRC = "pairwise_sample_optimization_tpu_torch/csrc/flash_attn_bwd.cu"
_JAX_ATTN = "pairwise_sample_optimization_tpu/ops/flash_attention.py"
_INT8_SRC = "pairwise_sample_optimization_tpu_torch/csrc/int8_conv.cu"
_JAX_QCONV = "pairwise_sample_optimization_tpu/ops/qconv.py"
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
    # no Pallas counterpart: the JAX package's int8 paths in jnp / lax (ops/qconv.py),
    # which PyTorch has no CUDA op for; "replaces" names the JAX lines each computes
    "int8_absmax": (_INT8_SRC, f"{_JAX_QCONV}:115, {_JAX_QCONV}:158 (jnp, no Pallas kernel)"),
    "int8_quantize": (_INT8_SRC, f"{_JAX_QCONV}:117, {_JAX_QCONV}:160 (jnp, no Pallas kernel)"),
    "int8_conv3x3": (_INT8_SRC, f"{_JAX_QCONV}:164 (lax.conv_general_dilated, no Pallas kernel)"),
    "int8_dequant": (_INT8_SRC, f"{_JAX_QCONV}:123 (jnp, no Pallas kernel)"),
}
INT8_KERNELS = ("int8_absmax", "int8_quantize", "int8_conv3x3", "int8_dequant")


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


def timed_ms(fn, reps=3, inner=5, warm=3):
    """Median over ``reps`` (3 of 5 calls: the script runs within a time limit) of
    CUDA-event device time per call for ``inner``
    calls in a row, after ``warm`` warm-up calls. Each rep first queues a device
    sleep of at least ~2 ms and of about twice the host's time to enqueue
    ``inner`` calls (measured once; an autograd backward takes the host
    longer than its kernels take the card), so the host has enqueued the
    calls before the start event runs: the time is the device's, not the
    host's launch rate."""
    import torch

    for _ in range(warm):
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


def small_modules(seed):
    """The small fp32 towers (UNet, VAE, two text towers, PickScore) whose
    attention head dim the kernel takes (64), random from ``seed`` on the
    CPU, and the generator after their draws."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models import (
        AutoencoderKL, CLIPDualEncoder, CLIPTextConfig, CLIPTextTower, CLIPVisionConfig,
        SDXLUNet, UNetConfig, VAEConfig)
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_

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
    return mods, gen


def small_pipeline(mods, device):
    """A pipeline of copies of ``small_modules``' towers on ``device``."""
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.rewards import PickScoreScorer

    return SDXLPipeline(*[copy.deepcopy(m).to(device) for m in mods[:4]],
                        scorer=PickScoreScorer(copy.deepcopy(mods[4]).to(device)), resolution=64)


def small_reference(seed):
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.rewards import PickScoreScorer

    mods, gen = small_modules(seed)
    cpu = SDXLPipeline(*mods[:4], scorer=PickScoreScorer(mods[4]), resolution=64)
    gpu = small_pipeline(mods, "cuda")
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
    if min(v for k, v in counts.items() if "bwd" not in k and k not in INT8_KERNELS) == 0:
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
    """(attention calls, GroupNorm+SiLU calls) of one UNet forward."""
    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    blocks = sum(d * (2 * lpb + 1) for d in depths) + ucfg.mid_depth
    resnets = n * (2 * lpb + 1) + 2
    return 2 * blocks, 2 * resnets + 1


def _remat_recomputed(ucfg, trained_cond=False):
    """(attention calls, ResnetBlocks) of one UNet pass that its backward
    runs again under ``ucfg.remat``, level by level as
    ``models.unet.remat_at`` decides (the mid block at the lowest level):
    every rematerialized block whose output needs a gradient. With a LoRA
    the ResnetBlocks before the first attention need none (nothing in them
    depends on the adapter), unless the conditioning is trained or the
    UNet's own weights are (``trained_cond``)."""
    from pairwise_sample_optimization_tpu_torch.models.unet import remat_at

    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    first = next(i for i, d in enumerate(depths) if d)
    attn = resnets = 0
    for level in range(n):
        r_res, r_attn, _ = remat_at(ucfg.remat, level, n)
        mid = level == n - 1
        blocks = depths[level] * (2 * lpb + 1) + (depths[-1] if mid else 0)
        level_resnets = 2 * lpb + 1 + (2 if mid else 0)
        grad_free = 0 if trained_cond else (lpb if level < first else int(level == first))
        attn += r_attn * 2 * blocks
        resnets += r_res * (level_resnets - grad_free)
    return attn, resnets


def int8_launches(matmuls=0, convs=0, smoothed_convs=0):
    """Launches of dynamic int8 (``ops/qconv.py``): a matmul quantizes its
    activations and weights (two absmax, two quantize) and dequantizes the
    ``torch._int_mm`` product; a conv the same and the implicit-GEMM conv,
    with SmoothQuant one absmax more (the channels')."""
    c = convs + smoothed_convs
    return {"int8_absmax": 2 * (matmuls + c) + smoothed_convs, "int8_quantize": 2 * (matmuls + c),
            "int8_conv3x3": c, "int8_dequant": matmuls}


def unet_int8_sites(ucfg, subpixel=False):
    """(int8 matmuls, int8 convs) of one UNet forward inside the int8
    reference pass: per transformer block the two attentions' q, k, v, out
    and the feed-forward's two projections, per SpatialTransformer its
    proj_in and proj_out; per ResnetBlock two 3x3 convs, and the upsamplers'
    convs on the naive path (the subpixel rewrite never quantizes)."""
    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    blocks = sum(d * (2 * lpb + 1) for d in depths) + depths[-1]
    transformers = sum((2 * lpb + 1) for d in depths if d) + (1 if depths[-1] else 0)
    resnets = n * (2 * lpb + 1) + 2
    return 10 * blocks + 2 * transformers, 2 * resnets + (0 if subpixel else n - 1)


def vae_decoder_int8_convs(vcfg, subpixel=False):
    """The VAE decoder's 3x3 convs the int8 decode quantizes: two per
    ResnetBlock and, on the naive path, the upsamplers'."""
    n = len(vcfg.block_out_channels)
    return 2 * (2 + n * (vcfg.layers_per_block + 1)) + (0 if subpixel else n - 1)


def _generation_launches(ucfg, vcfg, steps, vision_layers, decodes=1, int8=None):
    """Launches of ``steps`` UNet forwards (Turbo's steps, or DMD2's S - 1
    transitions and the final x0 prediction), ``decodes`` VAE decoder calls
    (each one mid-block attention) and vision towers of ``vision_layers``
    layers. ``int8``: {"decode": smoothed or not (None: off), "subpixel",
    "vision_layers": layers whose MLPs run in int8}."""
    attn, gn_unet = _unet_counts(ucfg)
    vae_resnets = 2 + len(vcfg.block_out_channels) * (vcfg.layers_per_block + 1)
    k1 = steps * attn + decodes + sum(vision_layers)
    gn = steps * gn_unet + decodes * (2 * vae_resnets + 1)
    int8 = int8 or {}
    smooth = int8.get("decode")
    convs = (0 if smooth is None else
             decodes * vae_decoder_int8_convs(vcfg, int8.get("subpixel", False)))
    q = int8_launches(matmuls=2 * int8.get("vision_layers", 0),
                      **{"smoothed_convs" if smooth else "convs": convs})
    return {"flash_attn_fwd": k1, "flash_attn_bwd_pre": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_post": 0, "gn_stats": gn, "gn_silu_norm": gn, **q}


def expected_launches(pipe, steps):
    """Launches of one ``sample_pairs`` call (either sampler): ``steps`` UNet
    forwards, the VAE decode and the PickScore vision tower."""
    return _generation_launches(pipe.unet.config, pipe.vae.config, steps,
                                [pipe.scorer.model.vision_config.layers])


def expected_validation_launches(pipe, n_prompts, batch, validations=1):
    """Launches of ``validations`` validations of ``n_prompts`` prompts in
    chunks of ``batch``: per chunk one 4-step generation and two CLIP-H
    vision towers (the pipeline's PickScore and the validation's CLIP
    scorer, of the same architecture)."""
    layers = pipe.scorer.model.vision_config.layers
    chunks = validations * -(-n_prompts // batch)
    return {k: chunks * v for k, v in
            _generation_launches(pipe.unet.config, pipe.vae.config, 4, [layers, layers]).items()}


def expected_eval_launches(ucfg, vcfg, steps, batches, vision_layers, decodes=1):
    """Launches of an eval run of ``batches`` batches: per batch one DMD2
    generation (``steps`` UNet forwards, ``decodes`` VAE decoder calls: the
    batch over ``--vae_decode_chunk``) and the scorers'
    vision towers (``vision_layers``: one entry per scorer, its non-causal
    attention calls: ImageReward's are its ViT's layers and its BERT's
    cross-attention layers). The CLIP text towers are causal and BERT's
    self-attention is masked: neither takes a kernel."""
    return {k: batches * v for k, v in
            _generation_launches(ucfg, vcfg, steps, vision_layers, decodes).items()}


def local_heads(heads, tp=(0, 1)):
    """The heads model rank ``tp[0]`` of ``tp[1]`` runs (``parallel.tp``:
    whole heads, as evenly as they split)."""
    from pairwise_sample_optimization_tpu_torch.parallel.tp import split_bounds

    lo, hi = split_bounds(heads, tp[1])[tp[0]]
    return hi - lo


def attention_shapes(ucfg, batch, latent_hw, text_len=77, tp=(0, 1)):
    """(q shape (B, S, H, D), kv length) of each attention call of one UNet
    forward at ``batch`` and a ``latent_hw`` x ``latent_hw`` latent: per
    transformer block (the mid block's at the last level) a self-attention
    over the level's tokens and a cross-attention to the ``text_len`` text
    tokens; H the local heads of model rank ``tp[0]`` of ``tp[1]`` and D
    the level's head dim (``heads_for``: SDXL's fixed 64, SD1.x's 8 fixed
    heads)."""
    n, lpb, depths = len(ucfg.block_out_channels), ucfg.layers_per_block, ucfg.transformer_layers
    shapes = []
    for i, (ch, d) in enumerate(zip(ucfg.block_out_channels, depths)):
        blocks = d * (2 * lpb + 1) + (ucfg.mid_depth if i == n - 1 else 0)
        tokens = (latent_hw // 2 ** i) ** 2
        heads, head_dim = ucfg.heads_for(ch)
        q = (batch, tokens, local_heads(heads, tp), head_dim)
        shapes += [(q, tokens), (q, text_len)] * blocks
    return shapes


def bwd_needs_post(q_shape, skv, sms=132):
    """Whether the bf16 backward at these lengths and q's head dim runs the
    post kernel (has an fp32 accumulator; ``ops.flash_attention.bwd_plan``;
    a head dim the kernel does not take, the CPU tests' tiny models', is
    planned as 64's)."""
    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    b, sq, h, d = q_shape
    _, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms, d if d in tfa.BWD_KV_ROWS else 64)
    return bool(dq_rows or kv_rows)


def expected_update_launches(ucfg, n_micro, fuse_ref_pass, batch, latent_hw, sms=132,
                             reference=True, trained_cond=False, tp=(0, 1), int8_ref=False,
                             subpixel=False):
    """Launches of one optimizer update of ``n_micro`` microbatches with a
    policy pass at ``batch``. Per microbatch: the policy forward (with
    grad), what its backward recomputes under ``ucfg.remat``
    (:func:`_remat_recomputed`: a SpatialTransformer's attention calls, a
    ResnetBlock's two GroupNorm+SiLU calls; "dots" saves weight products
    only, so it re-runs the kernels as "full" does) and, where there is a
    reference pass (``reference``; DreamBooth's ``pso_db`` has none) and it
    is not fused into the policy call (one call at twice the batch), the
    reference forward (no grad); per attention call in the backward the pre
    kernel and the backward kernel, and the post kernel where that call's
    lengths give an accumulator (``bwd_needs_post`` on a card of ``sms``
    SMs). ``trained_cond``: the conditioning is trained (the text encoders'
    LoRA reaches every ResnetBlock through the pooled embedding's time
    embedding) or the UNet's own weights are (full finetuning), so every
    rematerialized ResnetBlock is recomputed. The GroupNorm+SiLU backward is
    the plain version. ``tp``: (model rank, model ranks) of a
    tensor-parallel UNet, whose attention runs the rank's local heads.
    ``int8_ref``: the (unfused) reference forward in the int8 scope
    (:func:`unet_int8_sites`; ``subpixel``: its upsamplers not in int8)."""
    attn, gn = _unet_counts(ucfg)
    re_attn, re_resnets = _remat_recomputed(ucfg, trained_cond)
    shapes = attention_shapes(ucfg, batch * (2 if fuse_ref_pass else 1), latent_hw, tp=tp)
    assert len(shapes) == attn, (len(shapes), attn)
    passes = 1 + (0 if fuse_ref_pass or not reference else 1)
    k1 = attn * passes + re_attn
    k45 = gn * passes + 2 * re_resnets
    post = sum(bwd_needs_post(q, skv, sms) for q, skv in shapes)
    q = int8_launches(*unet_int8_sites(ucfg, subpixel)) if int8_ref and passes == 2 else {}
    return {"flash_attn_fwd": n_micro * k1, "flash_attn_bwd_pre": n_micro * attn,
            "flash_attn_bwd": n_micro * attn, "flash_attn_bwd_post": n_micro * post,
            "gn_stats": n_micro * k45, "gn_silu_norm": n_micro * k45,
            **{k: n_micro * q.get(k, 0) for k in INT8_KERNELS}}


DB_VIEWS = 8  # random crops kept per instance image (``DreamBoothDataset``'s aug_pool)
DB_VALIDATION_PROMPTS = 25


def expected_encode_launches(vcfg):
    """Launches of one VAE encoder call: its mid-block attention (d = 512) and
    its GroupNorm+SiLU calls (two per ResnetBlock and ``conv_norm_out``; the
    attention's GroupNorm has no SiLU and takes no kernel)."""
    resnets = len(vcfg.block_out_channels) * vcfg.layers_per_block + 2
    gn = 2 * resnets + 1
    return {"flash_attn_fwd": 1, "flash_attn_bwd_pre": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_post": 0, "gn_stats": gn, "gn_silu_norm": gn, **int8_launches()}


def expected_dreambooth_launches(pipe, args, instance_images, steps, first_step=0,
                                 class_images_before=0, sms=132):
    """Launches of one ``cli.train_pso_sdxl_turbo_dreambooth`` run (``args``
    as its ``parse_args`` gives them) of ``steps`` optimizer steps from
    ``first_step``, on a directory of ``instance_images`` images and a class
    directory that held ``class_images_before``: VAE encoder calls of
    ``sample_batch_size`` images (the instance views: ``DB_VIEWS`` random
    crops per image unless center-cropped, twice with flips, times
    ``repeats``; the negatives; the class images), 4-step generations (the
    negatives and the missing class images in batches of
    ``sample_batch_size``, one per validation prompt) and per step one
    update of ``gradient_accumulation_steps`` microbatches with a policy
    pass at twice the win half (the batch, doubled by prior preservation),
    ``pso``'s reference fused into it (a forward of its own with
    ``--use_dora``), ``pso_db`` without one. The text encoders (with or
    without their LoRA) are causal and take no kernel."""
    ucfg, vcfg = pipe.unet.config, pipe.vae.config
    bs = max(1, args.sample_batch_size)
    calls = lambda n, batch: -(-n // batch) if n > 0 else 0
    views = (instance_images * args.repeats * (1 if args.center_crop else DB_VIEWS)
             * (2 if args.random_flip else 1))
    encodes = calls(views, bs) + calls(args.num_negatives, bs)
    generations = calls(args.num_negatives, min(bs, args.num_negatives))
    prior = bool(args.with_prior_preservation and args.class_data_dir)
    if prior:
        missing = args.num_class_images - class_images_before
        generations += calls(missing, min(bs, max(missing, 1)))
        encodes += calls(max(class_images_before, args.num_class_images), bs)
    if not args.skip_validation and args.validation_steps:
        generations += DB_VALIDATION_PROMPTS * sum(
            (s + 1) % args.validation_steps == 0 for s in range(first_step, first_step + steps))
    pso = args.loss_type == "pso"
    upd = expected_update_launches(ucfg, args.gradient_accumulation_steps,
                                   pso and not args.use_dora,
                                   2 * args.train_batch_size * (2 if prior else 1),
                                   pipe.latent_hw, sms, reference=pso,
                                   trained_cond=args.train_text_encoder)
    gen = _generation_launches(ucfg, vcfg, 4, [])
    enc = expected_encode_launches(vcfg)
    return {k: encodes * enc[k] + generations * gen[k] + steps * upd[k] for k in gen}


class ShapeRecorder:
    """Records the shapes the main path hands each kernel wrapper, by
    wrapping the module functions the models reach (observation only)."""

    INT8_WRAPPERS = ("absmax", "quantize_rows", "quantize_nhwc", "conv3x3", "dequant", "int_mm")

    def __init__(self):
        from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
        from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg
        from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

        self.mods, self.attention, self.attention_bwd, self.gn = (tfa, tfg), {}, {}, {}
        self.orig = (tfa.flash_attention_fwd, tfa.flash_attention_bwd, tfg.fused_groupnorm_silu)
        self.tq, self.int8 = tq, {}
        self.int8_orig = {n: getattr(tq, n) for n in self.INT8_WRAPPERS}

    def __enter__(self):
        tfa, tfg = self.mods
        fwd, bwd, gn = self.orig

        def count(table, key):
            table[key] = table.get(key, 0) + 1

        def rec_int8(name, fn):
            sig = inspect.signature(fn)

            def wrapper(*args, **kwargs):
                a = sig.bind(*args, **kwargs)
                a.apply_defaults()
                a = a.arguments
                shape = lambda t: tuple(t.shape)
                key = {"absmax": lambda: (shape(a["x"]), str(a["x"].dtype), a["mode"],
                                          a["div"] is not None),
                       "quantize_rows": lambda: (shape(a["x"]), str(a["x"].dtype)),
                       "quantize_nhwc": lambda: (shape(a["x"]), str(a["x"].dtype),
                                                 a["div"] is not None),
                       "conv3x3": lambda: (shape(a["xq"]), shape(a["wq"]), str(a["dtype"]),
                                           a["bias"] is not None),
                       "dequant": lambda: (shape(a["acc"]), str(a["dtype"]),
                                           a["bias"] is not None),
                       # the product between Q1 and Q3 (torch._int_mm): (M, K, N)
                       "int_mm": lambda: shape(a["xq"]) + (a["wq"].shape[0],)}[name]()
                count(self.int8, (name,) + key)
                return fn(*args, **kwargs)
            return wrapper

        for n, fn in self.int8_orig.items():
            setattr(self.tq, n, rec_int8(n, fn))

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
        for n, fn in self.int8_orig.items():
            setattr(self.tq, n, fn)

    def int8_launches(self):
        """The int8 kernels' launches a card counts for the recorded calls."""
        calls = lambda *names: sum(n for key, n in self.int8.items() if key[0] in names)
        return {"int8_absmax": calls("absmax"),
                "int8_quantize": calls("quantize_rows", "quantize_nhwc"),
                "int8_conv3x3": calls("conv3x3"), "int8_dequant": calls("dequant")}


class HostPeak:
    """The host's resident memory over a ``with`` block: sampled every 10 ms
    from ``/proc/self/statm`` by a thread (``peak`` stays None where that
    file cannot be read), beside the process's lifetime peak
    (``ru_maxrss``) before and after the block."""

    def __enter__(self):
        import threading

        self.max_rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        self.before = self.peak = self._resident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _resident():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return None

    def _sample(self):
        while not self._stop.wait(0.01):
            now = self._resident()
            if now is not None:
                self.peak = max(self.peak or 0, now)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.max_rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def summary(self):
        return {"resident_before_bytes": self.before, "resident_peak_bytes": self.peak,
                "max_rss_before_bytes": self.max_rss_before,
                "max_rss_after_bytes": self.max_rss_after}


def checkpoint_round_trip(pipe, seed):
    """``pipe``'s towers through a diffusers checkpoint directory in fp16 and
    back through ``SDXLPipeline.from_torch_dir``; see the module docstring."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE,
                                                                    export_lora_safetensors,
                                                                    import_lora_safetensors,
                                                                    save_file)
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

    towers = {name: getattr(pipe, name) for _, _, name in TOWER_FILES}
    with torch.no_grad():  # fp16 values, so that the file holds the weights exactly
        for module in towers.values():
            for name, p in module.named_parameters():
                if ".lora." not in name:
                    p.copy_(p.half().to(p.dtype))
    RUN_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="checkpoint_", dir=RUN_DIR))
    try:
        with HostPeak() as host:
            t0 = time.perf_counter()
            file_bytes = {}
            for folder, file, name in TOWER_FILES:
                (tmp / folder).mkdir()
                sd = {k: v.half() for k, v in towers[name].state_dict().items()
                      if ".lora." not in k}
                save_file(sd, str(tmp / folder / file))
                file_bytes[folder] = (tmp / folder / file).stat().st_size
                del sd
            export_lora_safetensors(pipe.unet, str(tmp / LORA_FILE))
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = SDXLPipeline.from_torch_dir(str(tmp), lora_rank=pipe.unet.config.lora_rank,
                                                 dtype=torch.bfloat16, resolution=pipe.resolution,
                                                 seed=seed + 7, device="cuda", with_scorer=False)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        import_lora_safetensors(str(tmp / LORA_FILE), loaded.unet)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_tensors, differing = 0, []
    for _, _, name in TOWER_FILES:
        want, got = towers[name].state_dict(), getattr(loaded, name).state_dict()
        if set(want) != set(got):
            raise AssertionError(f"round trip {name}: keys differ")
        for k, w in want.items():
            n_tensors += 1
            if got[k].dtype != w.dtype or not torch.equal(got[k], w):
                differing.append(f"{name}.{k}")
    if differing:
        raise AssertionError(f"round trip: {len(differing)} tensors differ, e.g. {differing[:5]}")
    gen = torch.Generator().manual_seed(seed + 8)
    ids = [torch.randint(1, 49407, (2, 77), generator=gen) for _ in range(2)]
    for t in ids:
        t[:, 20] = 49407  # EOS
    images = []
    for p_ in (pipe, loaded):
        cond = p_.encode_prompt(*[t.cuda() for t in ids])
        images.append(p_.generate(cond, torch.Generator(device="cuda").manual_seed(seed + 9)))
    if not torch.equal(*images):
        raise AssertionError(f"round trip: images differ, max|diff| "
                             f"{(images[0] - images[1]).abs().max().item():.3e}")
    summary = {"file_bytes": file_bytes, "tensors": n_tensors, "write_s": write_s,
               "load_s": load_s, "host": host.summary(), "images": list(images[0].shape)}
    gib = lambda x: "not readable" if x is None else f"{x / 2**30:.2f} GiB"
    log(f"checkpoint round trip (fp16 diffusers dir, {sum(file_bytes.values()) / 1e9:.2f} GB, "
        f"{n_tensors} tensors): write {write_s:.1f} s, from_torch_dir {load_s:.1f} s; host "
        f"resident {gib(host.before)} before, peak {gib(host.peak)} (sampled every 10 ms); the "
        f"process's peak {gib(host.max_rss_before)} before, {gib(host.max_rss_after)} after; "
        f"every tensor equal, the LoRA back equal, the same images {summary['images']}")
    del loaded, images
    torch.cuda.empty_cache()
    return summary


def full_slice(seed, prompts=4, steps=4, iters=3):
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
    del out
    summary["checkpoint_round_trip"] = checkpoint_round_trip(pipe, seed)
    del pipe
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------- #
# the online-PSO loop (sampling + update) at full width
# ---------------------------------------------------------------------- #


def _frozen_and_lora(unet):
    frozen = {k: v for k, v in unet.state_dict().items() if ".lora." not in k}
    lora = {k: v for k, v in unet.state_dict().items() if ".lora." in k}
    return frozen, lora


def lora_import_and_generate(lora_file, restored, unet_config, seed):
    """The Turbo loop's ``lora-1`` file imported into a fresh UNet (its
    adapter must equal checkpoint-1's, ``restored``), then ``cli.generate``
    at full width twice on the same random weights, prompts and noise,
    once with ``--lora_path`` of the file: the images must differ."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import import_lora_safetensors
    from pairwise_sample_optimization_tpu_torch.cli import generate
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet

    fresh = SDXLUNet(unet_config, device="meta").to_empty(device="cuda")
    init_random_(fresh, torch.Generator(device="cuda").manual_seed(seed + 5))
    import_lora_safetensors(str(lora_file), fresh)
    got = {k: v for k, v in fresh.state_dict().items() if ".lora." in k}
    if set(got) != set(restored.lora) or any(
            not torch.equal(got[k], restored.lora[k].detach()) for k in got):
        raise AssertionError(f"{lora_file} imported into a fresh UNet is not checkpoint-1's LoRA")
    del fresh, got
    torch.cuda.empty_cache()
    out = {}
    for name, extra in (("base", []), ("lora", ["--lora_path", str(lora_file)])):
        t0 = time.perf_counter()
        paths = generate.main(["--device", "cuda", "--seed", str(seed), "--lora_rank",
                               str(unet_config.lora_rank), "--out", str(RUN_DIR / f"gen_{name}"),
                               "--prompt", "a red fox in the snow", "--prompt",
                               "an astronaut riding a horse", *extra])
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "png": [Path(p).read_bytes() for p in paths]}
        torch.cuda.empty_cache()
    if any(not p.startswith(b"\x89PNG") for p in out["base"]["png"] + out["lora"]["png"]):
        raise AssertionError("cli.generate wrote no PNG")
    if out["base"]["png"] == out["lora"]["png"]:
        raise AssertionError("cli.generate with --lora_path gave the images it gave without")
    summary = {"imported_tensors": len(restored.lora),
               "generate_s": {k: v["s"] for k, v in out.items()},
               "images_differ": [a != b for a, b in zip(out["base"]["png"], out["lora"]["png"])]}
    log(f"lora-1 imported into a fresh UNet equals checkpoint-1's LoRA ({len(restored.lora)} "
        f"tensors); cli.generate at 512^2 without / with --lora_path "
        f"{summary['generate_s']['base']:.1f} / {summary['generate_s']['lora']:.1f} s, the "
        f"images differ: {summary['images_differ']}")
    return summary


def train_slice(seed, sampler, recorder):
    """One epoch of ``run_online_pso`` with ``sampler``'s config defaults
    (Turbo: ``configs/sdxl_turbo_dpo.py``, with validation at step 2;
    DMD2: ``configs/sdxl_dmd_dpo.py``, without), the kernel wrappers' shapes
    recorded into ``recorder``."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE, latest_checkpoint,
                                                                    load_file,
                                                                    restore_train_state)
    from pairwise_sample_optimization_tpu_torch.cli import online_runner
    from pairwise_sample_optimization_tpu_torch.cli.online_runner import (VAL_IMAGES, run_dir,
                                                                          run_online_pso)
    from pairwise_sample_optimization_tpu_torch.configs import sdxl_dmd_dpo, sdxl_turbo_dpo
    from pairwise_sample_optimization_tpu_torch.data import PromptDataset
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                              make_optimizer)

    config = (sdxl_turbo_dpo if sampler == "turbo" else sdxl_dmd_dpo).get_config()
    config.seed = seed
    config.output_dir = str(RUN_DIR)
    config.run_name = f"online_{sampler}"
    for key, value in (VALIDATION if sampler == "turbo" else {"validation_steps": 0}).items():
        config[key] = value
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t_cfg, s_cfg = config.train, config.sample
    pairs = s_cfg.batch_size * s_cfg.num_batches_per_epoch
    n_updates = pairs // (t_cfg.batch_size * t_cfg.gradient_accumulation_steps)
    n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps

    val_prompts = []  # the prompts each validation ran
    validate = online_runner.run_validation

    def run_validation(pipe, clip_scorer, prompts, *args, **kwargs):
        val_prompts.append(list(prompts))
        return validate(pipe, clip_scorer, prompts, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    online_runner.run_validation = run_validation
    try:
        with recorder:
            state, history, pipe = run_online_pso(config, sampler=sampler, num_epochs=1,
                                                  device="cuda")
    finally:
        online_runner.run_validation = validate
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
    validations = sum(step % config.validation_steps == 0 for step in range(1, n_updates + 1)
                      ) if config.validation_steps else 0
    val = expected_validation_launches(pipe, config.val_max_prompts, s_cfg.batch_size,
                                       validations)
    want = {k: want[k] + n_updates * upd[k] + val[k] for k in want}
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
    val_rows = [m for m in metrics if "val/pickscore" in m]
    if len(val_rows) != validations or not all(
            math.isfinite(m[k]) for m in val_rows for k in ("val/pickscore", "val/clip_score")):
        raise AssertionError(f"validation rows {val_rows}, expected {validations} finite")
    validation = None
    if validations:
        want_prompts = PromptDataset("imagereward").prompts[:config.val_max_prompts]
        if val_prompts != [want_prompts] * validations:
            raise AssertionError(f"validation ran on {val_prompts}, not the first "
                                 f"{config.val_max_prompts} captions of {config.val_dataset}")
        step = val_rows[0]["step"]
        pngs = sorted((out_dir / f"val-{step}").glob("*.png"))
        if len(pngs) != VAL_IMAGES or any(not p.read_bytes().startswith(b"\x89PNG")
                                          for p in pngs):
            raise AssertionError(f"val-{step}/ holds {[p.name for p in pngs]}")
        validation = {"rows": val_rows, "pngs": [p.name for p in pngs],
                      "ms": val_rows[0]["time/validation_s"] * 1e3,
                      "source": config.val_dataset, "split": config.val_split_name}
    lora_check = (lora_import_and_generate(lora_file, restored, pipe.unet.config, seed)
                  if sampler == "turbo" else None)
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
        "validation": validation, "lora_import_and_generate": lora_check,
    }
    log(f"online PSO loop, {sampler} at {s_cfg.resolution}^2 (1 epoch, {pairs} pairs, "
        f"{n_updates} updates x {n_micro} microbatches of policy batch {2 * t_cfg.batch_size}): "
        f"sample {sample_ms:.1f} ms, update {summary['update_ms']:.1f} ms, "
        f"microbatch {summary['microbatch_ms']:.1f} ms, {summary['loop_pairs_per_s']:.3f} "
        f"pairs/s of the loop, peak {peak / 2**30:.2f} GiB; losses "
        f"{[round(m['loss'], 6) for m in history]}, grad_norm "
        f"{[round(m['grad_norm'], 6) for m in history]}; launches {counts}; LoRA max|delta| "
        f"{lora_moved:.3e}, frozen unchanged; restored {summary['checkpoint']}; "
        f"lora-1/{LORA_FILE} ({len(exported)} tensors) equals its LoRA"
        + (f"; validation at step {val_rows[0]['step']} on the {config.val_split_name} split "
           f"of {Path(config.val_dataset[3:]).name} (its {config.val_max_prompts} captions "
           f"read by the port's Arrow reader): {validation['ms']:.1f} ms, "
           f"val/pickscore {val_rows[0]['val/pickscore']:.6f}, val/clip_score "
           f"{val_rows[0]['val/clip_score']:.6f}, {len(validation['pngs'])} PNGs"
           if validation else ""))
    del pipe, state, ref, restored, frozen, frozen0, lora, lora0, lora_ref
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary, metrics_jsonl


# ---------------------------------------------------------------------- #
# the memory options: remat modes, full finetuning with the aux offload
# ---------------------------------------------------------------------- #

REMAT_PAIRS = 4  # pairs of the remat phase's microbatch: policy batch 8, the Turbo loop's
REMAT_TOL_FACTOR = 4  # gradients of a mode vs "full": 4x the spread of two "full" runs
REMAT_REPS = 1  # timed runs of each mode's microbatch (the script runs within a time limit)
FULL_FT = {"sample.batch_size": 2, "sample.num_batches_per_epoch": 1, "train.batch_size": 1,
           "train.gradient_accumulation_steps": 2}  # 2 pairs an epoch, 1 update, policy batch 2
# how much more the second full-finetuning update may start with than the first
# (the gradients of all 2.57 G weights, if held over, are 9.6 GiB)
HELD_GRADS_LIMIT = 2**29


def remat_phase(seed, recorder):
    """One update microbatch of the Turbo loop (``OnlinePSOTrainer._micro_loss``
    and its backward: the policy forward and backward, the reference
    forward) at full SDXL-Turbo width, 512^2, bf16 towers, fp32 LoRA rank 32
    with a non-zero B, on 4 pairs the pipeline sampled itself (policy batch
    8), under each remat mode of ``models.unet.REMAT_MODES``: "full" twice
    first (the spread of the two sets the tolerance: the backward's dQ sums
    come in no fixed order), then "", "resnets", "dots", "lowres" and
    "lowres_dots". Per mode: the launch counts (zeroed just before, read just
    after) equal to ``expected_update_launches`` of the mode, the peak
    memory (``max_memory_allocated`` after ``reset_peak_memory_stats``),
    then ``REMAT_REPS`` runs timed with CUDA events around each and on the
    host clock (medians); the loss and each LoRA gradient tensor against the
    first "full" run's: the tensor's relative difference ||g - g_full|| /
    ||g_full|| within ``REMAT_TOL_FACTOR`` times the largest relative
    difference of any tensor between the two "full" runs (1e-6 at least),
    the loss within ``REMAT_TOL_FACTOR`` times the two runs' difference plus
    1e-6 of |loss|. One tolerance for every tensor: the backward's sums
    land in another order each run, and a tensor whose sums happened to
    land alike in the two "full" runs is no more exact than the others."""
    import dataclasses

    import torch

    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                              lora_parameters)

    pipe = SDXLPipeline.random(lora_rank=32, dtype=torch.bfloat16, resolution=512, seed=seed,
                               lora_b_std=1.0 / 32, device="cuda")
    for m in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model):
        m.requires_grad_(False)
    lora = lora_parameters(pipe.unet)
    trainer = OnlinePSOTrainer(OnlinePSOConfig(), pipe)
    gen = torch.Generator().manual_seed(seed + 11)
    b = REMAT_PAIRS
    vocab = pipe.te1.config.vocab_size
    ids = [torch.randint(1, vocab - 1, (b, 77), generator=gen).to(pipe.device) for _ in range(3)]
    cond = pipe.encode_prompt(*ids)
    samples, _ = trainer.sample_pairs(cond, torch.Generator(device=pipe.device).manual_seed(seed))
    micro = {k: samples[k][:, :, 0] for k in ("input_latents", "latents", "next_latents")}
    micro.update({k: samples[k][:, 0] for k in ("step_indices", "timesteps")})
    micro["rewards"] = samples["rewards"]
    c = {k: cond[k] for k in ("embeds", "pooled", "time_ids")}
    axis = torch.zeros(b, dtype=torch.long)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base_cfg = pipe.unet.config

    def microbatch():
        for p in lora.values():
            p.grad = None
        loss, _ = trainer._micro_loss(micro, c, axis=axis)
        loss.backward()
        return loss.detach()

    rows, ref, spread, launches = [], None, None, {k: 0 for k in KERNELS}
    for mode in ("full", "full", "", "resnets", "dots", "lowres", "lowres_dots"):
        pipe.unet.config = dataclasses.replace(base_cfg, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        kernel_lib.reset_launch_counts()
        with recorder:
            loss = microbatch()
        torch.cuda.synchronize()
        counts, peak = dict(kernel_lib.launch_counts), torch.cuda.max_memory_allocated()
        want = expected_update_launches(pipe.unet.config, 1, False, 2 * b, pipe.latent_hw, sms)
        if counts != want:
            raise AssertionError(f"remat {mode!r}: launch counts {counts} != expected {want}")
        for k in launches:
            launches[k] += counts[k]
        grads = {k: p.grad for k, p in lora.items()}
        event_ms, wall_ms = [], []
        for _ in range(REMAT_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            microbatch()
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        row = {"mode": mode, "loss": float(loss), "peak_bytes": peak,
               "activation_peak_bytes": peak - resting, "launches": counts,
               "event_ms": statistics.median(event_ms), "wall_ms": statistics.median(wall_ms),
               "event_ms_runs": event_ms}
        rel = lambda: {k: float((grads[k] - g).norm() / g.norm().clamp_min(1e-30))
                       for k, g in ref[1].items()}
        if ref is None:
            ref = (float(loss), grads)
        elif spread is None:  # the second "full" run: the run-to-run spread
            d = rel()
            spread = {"loss": abs(float(loss) - ref[0]), "grad_rel": max(d.values())}
            row["spread"] = {"loss": spread["loss"], "grad_rel_max": max(d.values()),
                             "grad_rel_median": statistics.median(d.values()),
                             "bit_equal_tensors": sum(x == 0 for x in d.values())}
        else:
            d = rel()
            limit = max(REMAT_TOL_FACTOR * spread["grad_rel"], 1e-6)
            worst = max(d, key=d.get)
            if d[worst] > limit:
                raise AssertionError(f"remat {mode!r}: {worst} ||g - g_full|| / ||g_full|| "
                                     f"{d[worst]:.3e} > {limit:.3e} ({REMAT_TOL_FACTOR} x the two "
                                     f"full runs' {spread['grad_rel']:.3e})")
            if abs(float(loss) - ref[0]) > REMAT_TOL_FACTOR * spread["loss"] + 1e-6 * abs(ref[0]):
                raise AssertionError(f"remat {mode!r}: loss {float(loss)} vs full {ref[0]}")
            row["grad_rel"] = {"max": d[worst], "median": statistics.median(d.values()),
                               "limit": limit}
        rows.append(row)
        del grads
        log(f"remat {mode or 'off'!r}: peak {peak / 2**30:.2f} GiB (activations "
            f"{row['activation_peak_bytes'] / 2**30:.2f}), microbatch {row['event_ms']:.1f} ms "
            f"(events, median of {[round(x, 1) for x in event_ms]}) / {row['wall_ms']:.1f} ms "
            f"wall, loss {row['loss']:.6f}, launches {counts}"
            + (f"; LoRA grads vs full's ||g - g_full|| / ||g_full|| max "
               f"{row['grad_rel']['max']:.2e}, median {row['grad_rel']['median']:.2e} (limit "
               f"{row['grad_rel']['limit']:.2e})" if "grad_rel" in row else "")
            + (f"; two full runs: ||g1 - g2|| / ||g1|| max {row['spread']['grad_rel_max']:.2e}, "
               f"median {row['spread']['grad_rel_median']:.2e}, "
               f"{row['spread']['bit_equal_tensors']} of {len(ref[1])} tensors bit-equal; loss "
               f"{spread['loss']:.2e}" if "spread" in row else ""))
    pipe.unet.config = base_cfg
    del pipe, trainer, lora, samples, micro, cond, ref
    torch.cuda.empty_cache()
    return {"pairs": b, "policy_batch": 2 * b, "rows": rows, "tol_factor": REMAT_TOL_FACTOR,
            "launches": launches}


class _UpdateWatch:
    """Observes a run of ``run_online_pso`` through ``OnlinePSOTrainer``'s
    ``sample_pairs`` and ``train_epoch`` and ``PSOTrainState``'s
    ``apply_gradients`` (patched for the ``with`` block, each calling the
    original): at each sampling, how far the live UNet's weights are from
    the frozen reference copy; at each update, whether the VAE, the scorer
    and both text encoders are in pinned host memory, the memory allocated
    when it starts, its peak and its seconds; at each optimizer step, the
    trained tensors whose gradient is not all zero (the trainers release
    the gradients after the step)."""

    def __enter__(self):
        from pairwise_sample_optimization_tpu_torch.train import OnlinePSOTrainer, PSOTrainState

        self.cls, self.orig = OnlinePSOTrainer, (OnlinePSOTrainer.sample_pairs,
                                                 OnlinePSOTrainer.train_epoch)
        self.state_cls, self.orig_apply = PSOTrainState, PSOTrainState.apply_gradients
        self.samplings, self.updates, self.with_grad = [], [], []
        sample, train = self.orig
        apply = self.orig_apply
        watch = self

        def sample_pairs(trainer, *args, **kwargs):
            watch.samplings.append(watch.distance(trainer.pipe))
            return sample(trainer, *args, **kwargs)

        def train_epoch(trainer, *args, **kwargs):
            import torch

            pipe = trainer.pipe
            aux = [p for m in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model)
                   for p in m.parameters()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            entry = {"aux_on_host": all(p.device.type == "cpu" and p.is_pinned() for p in aux),
                     "aux_bytes": sum(p.numel() * p.element_size() for p in aux),
                     "allocated_bytes": torch.cuda.memory_allocated()}
            t0 = time.perf_counter()
            out = train(trainer, *args, **kwargs)
            torch.cuda.synchronize()
            entry.update({"s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated()})
            watch.updates.append(entry)
            return out

        def apply_gradients(state, grads):
            import torch

            nonzero = torch.stack([g.any() for g in grads.values()]).tolist()
            watch.with_grad.append([k for k, nz in zip(grads, nonzero) if nz])
            return apply(state, grads)

        OnlinePSOTrainer.sample_pairs, OnlinePSOTrainer.train_epoch = sample_pairs, train_epoch
        PSOTrainState.apply_gradients = apply_gradients
        return self

    def __exit__(self, *exc):
        self.cls.sample_pairs, self.cls.train_epoch = self.orig
        self.state_cls.apply_gradients = self.orig_apply

    @staticmethod
    def distance(pipe):
        """max |w - reference| over the UNet's weights."""
        ref = dict(pipe.reference_unet.named_parameters())
        return max(float((p.detach().float() - ref[k].float()).abs().max())
                   for k, p in pipe.unet.named_parameters())


_INT_OF_SIZE = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def state_fingerprints(state):
    """{name: (sum, position-weighted sum)} of the bits of every trained
    tensor and every optimizer state tensor (read as integers of the same
    width, summed in int64): equal bits give equal pairs."""
    import torch

    tensors = {f"lora.{k}": v for k, v in state.lora.items()}
    for name, value in state.tx.state_dict()["state"].items():
        for i, t in enumerate(value if isinstance(value, (list, tuple)) else [value]):
            tensors[f"tx.{name}.{i}"] = t
    sums = []
    for t in tensors.values():
        w = t.detach().reshape(-1).view(getattr(torch, _INT_OF_SIZE[t.element_size()]))
        w = w.to(torch.int64)
        pos = torch.arange(1, w.numel() + 1, device=w.device, dtype=torch.int64)
        sums.append(torch.stack([w.sum(), (w * pos).sum()]))
    return dict(zip(tensors, map(tuple, torch.stack(sums).cpu().tolist())))


def _mem_total_bytes():
    with open("/proc/meminfo") as f:
        return int(next(line for line in f if line.startswith("MemTotal:")).split()[1]) * 1024


class _CheckpointWatch:
    """Wraps the runner's ``save_train_state`` and ``restore_train_state``
    (patched for the ``with`` block, each calling the original). A save
    records the free disk and the host's MemTotal before it, the state's
    fingerprints (:func:`state_fingerprints`), the write seconds, the host's
    resident memory over the write, the file's size, and then the seconds
    an ``fsync`` takes, after which the file is dropped from the page cache
    (``POSIX_FADV_DONTNEED``) so that a restore reads it from the disk. A
    restore records the read seconds (through the copies onto the card),
    the host's memory over it and the restored state's fingerprints."""

    def __enter__(self):
        from pairwise_sample_optimization_tpu_torch.cli import online_runner

        self.mod = online_runner
        self.orig = (online_runner.save_train_state, online_runner.restore_train_state)
        self.saves, self.restores = [], []
        save, restore = self.orig
        watch = self

        def save_train_state(base_dir, step, state, extra=None, blob=None):
            import torch

            entry = {"step": step, "disk_free_bytes": shutil.disk_usage(base_dir).free,
                     "mem_total_bytes": _mem_total_bytes(),
                     "fingerprints": state_fingerprints(state)}
            torch.cuda.synchronize()
            with HostPeak() as host:
                t0 = time.perf_counter()
                path = save(base_dir, step, state, extra, blob)
                entry["write_s"] = time.perf_counter() - t0
            files = [p for p in Path(path).iterdir() if p.is_file()]
            t0 = time.perf_counter()
            for p in files:
                fd = os.open(p, os.O_RDONLY)
                try:
                    os.fsync(fd)
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            entry.update({"fsync_s": time.perf_counter() - t0, "host": host.summary(),
                          "bytes": sum(p.stat().st_size for p in files)})
            watch.saves.append(entry)
            return path

        def restore_train_state(path, state):
            import torch

            torch.cuda.synchronize()
            with HostPeak() as host:
                t0 = time.perf_counter()
                extra = restore(path, state)
                torch.cuda.synchronize()
                read_s = time.perf_counter() - t0
            watch.restores.append({"read_s": read_s, "host": host.summary(),
                                   "fingerprints": state_fingerprints(state), "step": state.step})
            return extra

        online_runner.save_train_state = save_train_state
        online_runner.restore_train_state = restore_train_state
        return self

    def __exit__(self, *exc):
        self.mod.save_train_state, self.mod.restore_train_state = self.orig


FULL_FT_CKPT_EVERY = 1000  # the runner writes step 1 and every this many: step 1 alone here


def _trace_kernels(path):
    """(file bytes, kernel events, names of the kernel events) of a Chrome
    trace written by ``torch.profiler``."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return Path(path).stat().st_size, len(names), set(names)


def full_finetune_slice(seed, recorder):
    """The Turbo loop at full width training every UNet weight through
    ``run_online_pso`` (``use_lora=False``, ``param_dtype="float32"``: fp32
    masters computing in bf16, a frozen bf16 reference copy), 2 epochs of 2
    pairs (one update of 2 x 3 microbatches at policy batch 2 each), no
    validation:

    - run A: the per-tensor AdamW, ``offload_aux_during_update=True``, the
      whole-UNet train state written after update 1 (``checkpointing_steps``
      ``FULL_FT_CKPT_EVERY``: step 1 alone). Then a fresh run restores it
      (``resume_from``) and trains one epoch: every restored master and
      moment bit-equal to what was saved (:func:`state_fingerprints` at the
      save and after the restore), the step numbering continuing at 2. The
      free disk and MemTotal before the write, the size, the write, fsync
      and read seconds and the host's peak resident memory are printed; the
      checkpoint is then deleted. Where the disk or the host could not hold
      it, the round trip runs on run C's state instead;
    - the same without the offload, 1 epoch, for its peak;
    - run C: ``train.use_8bit_adam=True`` (the per-tensor 8-bit AdamW) with
      the offload and ``profile_dir``: the trace of its second epoch must
      hold the card's kernel events, K1's and the backward kernel's among
      them; its size and kernel events are printed and it is deleted.

    Runs A and C: launch counts as implied (zeroed before, read after), the
    first loss log 2 within 1e-3, every UNet weight with a gradient in the
    last update (recorded at the optimizer step) moved and at least half of
    them with one, the reference copy bit-equal to a rebuild from the seed,
    the VAE, scorer and text encoders in pinned host memory during each
    update and back on the card after, the second epoch sampled by weights
    the first update moved, and the second update starting within
    ``HELD_GRADS_LIMIT`` of the first's allocated bytes (the trainers release
    the gradients after each update). Prints peaks, update seconds, the
    optimizer's resting bytes and the offload's seconds."""
    import torch

    from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_dir, run_online_pso
    from pairwise_sample_optimization_tpu_torch.configs import sdxl_turbo_dpo
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    def run(offload, epochs, extra=(), resume=False, name="online_full"):
        config = sdxl_turbo_dpo.get_config()
        config.seed, config.output_dir = seed, str(RUN_DIR)
        config.run_name = name
        for key, value in {**FULL_FT, "use_lora": False, "param_dtype": "float32",
                           "offload_aux_during_update": offload, "checkpointing_steps": 0,
                           "validation_steps": 0, **dict(extra)}.items():
            config.override(f"{key}={value}")
        if resume:
            config.resume_from = run_dir(config)
        else:
            shutil.rmtree(RUN_DIR, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        t0 = time.perf_counter()
        with recorder, _UpdateWatch() as watch, _CheckpointWatch() as ckpt:
            state, history, pipe = run_online_pso(config, num_epochs=epochs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel_lib.launch_counts)
        t_cfg, s_cfg = config.train, config.sample
        n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps
        gen = expected_launches(pipe, s_cfg.num_steps)
        upd = expected_update_launches(pipe.unet.config, n_micro, False, 2 * t_cfg.batch_size,
                                       pipe.latent_hw,
                                       torch.cuda.get_device_properties(0).multi_processor_count,
                                       trained_cond=True)
        want = {k: epochs * (gen[k] + upd[k]) for k in gen}
        if counts != want:
            raise AssertionError(f"full finetuning {name} launch counts {counts} != expected "
                                 f"{want}")
        metrics = [json.loads(r) for r in
                   (Path(run_dir(config)) / "metrics.jsonl").read_text().splitlines()]
        return {"config": config, "state": state, "history": history, "pipe": pipe,
                "watch": watch, "ckpt": ckpt, "counts": counts, "wall": wall,
                "metrics": metrics}

    def check(r, label):
        """Run A's and C's checks (see the docstring); returns its summary."""
        state, history, pipe, watch = r["state"], r["history"], r["pipe"], r["watch"]
        unet_params = dict(pipe.unet.named_parameters())
        if set(state.lora) != set(unet_params) or any(state.lora[k] is not p
                                                      for k, p in unet_params.items()):
            raise AssertionError(f"{label}: the train state does not hold the UNet's weights")
        if abs(history[0]["loss"] - math.log(2.0)) > 1e-3 or not all(
                math.isfinite(m[k]) for m in history for k in ("loss", "grad_norm")):
            raise AssertionError(f"{label}: full finetuning metrics {history}")
        if any(p.grad is not None for p in unet_params.values()):
            raise AssertionError(f"{label}: gradients held after the last update")
        ref = dict(pipe.reference_unet.named_parameters())
        with_grad = watch.with_grad[-1]
        unmoved = [k for k in with_grad if torch.equal(unet_params[k].float(), ref[k].float())]
        if unmoved or len(with_grad) < len(unet_params) // 2:
            raise AssertionError(f"{label}: {len(with_grad)} of {len(unet_params)} weights with "
                                 f"a gradient, unmoved: {unmoved[:5]}")
        rebuilt = SDXLUNet(pipe.reference_unet.config, device="meta").to_empty(
            device=pipe.device)
        init_random_(rebuilt, torch.Generator(device=pipe.device).manual_seed(seed))
        # one state_dict of the reference: taken per key, 1680 of them cost ~30 s
        ref_state = pipe.reference_unet.state_dict()
        changed = [k for k, v in rebuilt.state_dict().items() if not torch.equal(v, ref_state[k])]
        if changed:
            raise AssertionError(f"{label}: the reference copy changed: {changed[:5]}")
        del rebuilt
        aux = [p for m in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model)
               for p in m.parameters()]
        if not all(u["aux_on_host"] for u in watch.updates) or any(p.device != pipe.device
                                                                    for p in aux):
            raise AssertionError(f"{label}: aux towers not on the host during the updates "
                                 f"{watch.updates} or not back on the card after")
        if len(watch.samplings) != 2 or watch.samplings[0] != 0 or not watch.samplings[1] > 0:
            raise AssertionError(f"{label}: sampling weights' distance from the reference "
                                 f"{watch.samplings}: the second epoch must sample the updated "
                                 "weights")
        start = [u["allocated_bytes"] for u in watch.updates]
        if start[1] - start[0] > HELD_GRADS_LIMIT:
            raise AssertionError(f"{label}: the second update starts with {start[1]} bytes "
                                 f"allocated, the first with {start[0]}: more than "
                                 f"{HELD_GRADS_LIMIT} held over")
        tx_tensors = [t for v in state.tx.state_dict()["state"].values()
                      for t in (v if isinstance(v, (list, tuple)) else [v])]
        return {"history": history, "launches": r["counts"], "wall_s": r["wall"],
                "updates": watch.updates, "sampling_distance": watch.samplings,
                "weights": len(unet_params), "weights_with_grad": len(with_grad),
                "trained_elements": sum(p.numel() for p in unet_params.values()),
                "optimizer": type(state.tx).__name__,
                "optimizer_bytes": sum(t.numel() * t.element_size() for t in tx_tensors),
                "offload_bytes": r["metrics"][-1].get("offload_bytes"),
                "offload_s": [m.get("time/offload_s", 0) + m.get("time/reload_s", 0)
                              for m in r["metrics"] if "loss" in m]}

    def round_trip(r, summary, label, extra):
        """Restore the checkpoint run ``r`` wrote into a fresh run and train one
        epoch: fingerprints equal, step numbering continuing."""
        (saved,) = r["ckpt"].saves
        del r["state"], r["pipe"]
        torch.cuda.empty_cache()
        resumed = run(True, 1, extra, resume=True)
        (restored,) = resumed["ckpt"].restores
        differ = [k for k, v in saved["fingerprints"].items()
                  if restored["fingerprints"].get(k) != v]
        if differ or set(restored["fingerprints"]) != set(saved["fingerprints"]):
            raise AssertionError(f"{label}: {len(differ)} restored tensors differ from the saved "
                                 f"ones, e.g. {differ[:5]}")
        steps = [m["step"] for m in resumed["metrics"] if "loss" in m]
        if restored["step"] != 1 or resumed["state"].step != 2 or steps[-1:] != [2]:
            raise AssertionError(f"{label}: restored at step {restored['step']}, resumed to "
                                 f"{resumed['state'].step}, logged steps {steps}")
        summary["checkpoint"] = {
            "run": label, "tensors": len(saved["fingerprints"]), "bytes": saved["bytes"],
            "disk_free_bytes": saved["disk_free_bytes"],
            "mem_total_bytes": saved["mem_total_bytes"], "write_s": saved["write_s"],
            "fsync_s": saved["fsync_s"], "read_s": restored["read_s"],
            "host_write": saved["host"], "host_read": restored["host"],
            "resumed_loss": resumed["history"][0]["loss"],
            "uninterrupted_loss": summary["history"][1]["loss"],
            "resumed_launches": resumed["counts"], "resumed_wall_s": resumed["wall"]}
        del resumed
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        torch.cuda.empty_cache()

    # the round trip needs the state on the disk once and in host memory once
    # (the restore reads it whole): run A's fp32 masters and two fp32 moments
    elements = sum(p.numel() for p in SDXLUNet(UNetConfig.sdxl(), device="meta").parameters())
    RUN_DIR.mkdir(exist_ok=True)
    free, mem_total = shutil.disk_usage(RUN_DIR).free, _mem_total_bytes()
    trip_on_a = 12 * elements * 1.2 < min(free, mem_total / 2)
    ckpt_extra = {"checkpointing_steps": FULL_FT_CKPT_EVERY}
    a = run(True, 2, ckpt_extra if trip_on_a else {})
    summary = check(a, "run A")
    if trip_on_a:
        round_trip(a, summary, "run A", ckpt_extra)
    del a
    torch.cuda.empty_cache()
    off = run(False, 1)
    summary["no_offload"] = {"updates": off["watch"].updates, "wall_s": off["wall"],
                             "launches": off["counts"]}
    del off
    torch.cuda.empty_cache()
    trace_dir = RUN_DIR / "trace"
    c_extra = {"train.use_8bit_adam": True, "profile_dir": str(trace_dir),
               **({} if trip_on_a else ckpt_extra)}
    c = run(True, 2, c_extra)
    summary["run_c"] = check(c, "run C")
    traces = sorted(p.name for p in trace_dir.iterdir())
    if traces != ["epoch-1.json"]:
        raise AssertionError(f"run C's profile_dir holds {traces}, not the second epoch's trace")
    size, n_kernels, names = _trace_kernels(trace_dir / "epoch-1.json")
    missing = [k for k in ("flash_fwd_kernel", "flash_bwd_pre_kernel", "flash_bwd_kernel",
                           "gn_stats_kernel", "gn_norm_silu_kernel")
               if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"run C's trace ({n_kernels} kernel events) holds no {missing}")
    summary["run_c"]["trace"] = {"bytes": size, "kernel_events": n_kernels,
                                 "kernel_names": len(names)}
    shutil.rmtree(trace_dir, ignore_errors=True)
    if not trip_on_a:
        log(f"checkpoint round trip on run C: {free / 1e9:.1f} GB free on the disk, MemTotal "
            f"{mem_total / 2**30:.1f} GiB cannot hold run A's ~{12 * elements / 1e9:.1f} GB")
        round_trip(c, summary["run_c"], "run C", c_extra)
    del c
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    runs = [summary, summary["no_offload"], summary["run_c"]]
    trip = summary.get("checkpoint") or summary["run_c"]["checkpoint"]
    summary["launches"] = {k: sum(x["launches"][k] for x in runs) + trip["resumed_launches"][k]
                           for k in summary["launches"]}

    gib = lambda n: n / 2**30
    u, u0, uc = summary["updates"], summary["no_offload"]["updates"], summary["run_c"]["updates"]
    fmt = lambda xs, key: [round(gib(x[key]), 2) for x in xs]
    log(f"full finetuning (Turbo 512^2, {summary['trained_elements']} trained elements in "
        f"{summary['weights']} tensors, fp32 masters, 2 epochs of 2 pairs): run A (per-tensor "
        f"AdamW) losses {[round(m['loss'], 6) for m in summary['history']]}; update "
        f"{[round(x['s'], 3) for x in u]} s with the aux offload (peak {fmt(u, 'peak_bytes')} "
        f"GiB, allocated at its start {fmt(u, 'allocated_bytes')} GiB, "
        f"{gib(u[0]['aux_bytes']):.2f} GiB of towers on the host, moves "
        f"{[round(x, 3) for x in summary['offload_s']]} s), without "
        f"{[round(x['s'], 3) for x in u0]} s (peak {fmt(u0, 'peak_bytes')} GiB, allocated at "
        f"its start {fmt(u0, 'allocated_bytes')} GiB); optimizer at rest "
        f"{gib(summary['optimizer_bytes']):.2f} GiB; {summary['weights_with_grad']} weights with "
        f"a gradient all moved, the reference copy bit-equal to the seed's, sampling distance "
        f"from it {summary['sampling_distance']}")
    rc = summary["run_c"]
    log(f"full finetuning run C ({rc['optimizer']}, the aux offload): losses "
        f"{[round(m['loss'], 6) for m in rc['history']]}; update {[round(x['s'], 3) for x in uc]}"
        f" s (the second traced), peak {fmt(uc, 'peak_bytes')} GiB, allocated at its start "
        f"{fmt(uc, 'allocated_bytes')} GiB; optimizer at rest {gib(rc['optimizer_bytes']):.2f} "
        f"GiB; {rc['weights_with_grad']} weights with a gradient all moved, the reference "
        f"bit-equal; trace of epoch 1 {rc['trace']['bytes'] / 1e6:.1f} MB, "
        f"{rc['trace']['kernel_events']} kernel events ({rc['trace']['kernel_names']} names, "
        f"K1's, the backward's and K4 / K5's among them), deleted")
    hw, hr = trip["host_write"], trip["host_read"]
    log(f"whole-UNet checkpoint round trip ({trip['run']}, {trip['tensors']} tensors, "
        f"{trip['bytes'] / 1e9:.2f} GB; disk free before {trip['disk_free_bytes'] / 1e9:.1f} GB, "
        f"MemTotal {gib(trip['mem_total_bytes']):.1f} GiB): write {trip['write_s']:.1f} s "
        f"(+ fsync {trip['fsync_s']:.1f} s), read {trip['read_s']:.1f} s from the disk; host "
        f"resident peak {gib(hw['resident_peak_bytes'] or 0):.2f} GiB writing, "
        f"{gib(hr['resident_peak_bytes'] or 0):.2f} GiB reading; every master and moment "
        f"bit-equal after the restore, resumed at step 2 (loss {trip['resumed_loss']:.6f}, "
        f"uninterrupted {trip['uninterrupted_loss']:.6f}); deleted; launches "
        f"{summary['launches']}")
    return summary


# ---------------------------------------------------------------------- #
# the PickaPic eval protocol (SDXL-DMD2 at 1024^2, four scorers)
# ---------------------------------------------------------------------- #


def write_wordpiece_vocab(path):
    """A BERT-style WordPiece vocabulary for the eval's ImageReward: the
    four specials, single characters and their ``##`` continuations, and
    the words of the packaged ImageReward prompts (fewer entries than
    BLIP's 30524 ids). Returns its size."""
    from pairwise_sample_optimization_tpu_torch.data import (PromptDataset,
                                                             WordPieceTokenizer)

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?;:()[]{}\"'`~@#$%^&*+=|\\/<>-")
    split = WordPieceTokenizer(vocab=specials)._split
    words = sorted({w for p in PromptDataset("imagereward").prompts for w in split(p)}
                   - set(chars))
    vocab = specials + chars + ["##" + c for c in chars] + words
    Path(path).write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return len(vocab)


def eval_slice(seed, recorder, prompts=EVAL_PROMPTS):
    """``cli.evaluate_sdxl_dmd2`` at full width and 1024^2 on the first
    ``prompts`` packaged ImageReward prompts at batch 2 with PickScore,
    CLIP score, HPS, the aesthetic scorer (the released MLP) and ImageReward
    (on the vocabulary of :func:`write_wordpiece_vocab`), shapes
    recorded into ``recorder``; then the first two prompts again at batch 1,
    whose per-prompt scores must equal the batch-2 run's within
    ``TOL["eval_batch"]`` (each prompt's noise depends on its index only;
    what differs is bf16 rounding in kernels chosen by batch size). Last, the
    first run again with ``--score_chunk 4 --offload_scorers
    --vae_decode_chunk 1``: every scorer in pinned host memory but for its
    turn on a chunk of 4 prompts, the images of two batches buffered, one
    image a VAE call (what the default does at 1024^2): its scores must
    equal the first run's bit for bit. Launch counts as implied (one VAE
    decoder call per image at 1024^2)."""
    import contextlib

    import torch

    from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev
    from pairwise_sample_optimization_tpu_torch.models import (BertConfig, CLIPVisionConfig,
                                                               UNetConfig, VAEConfig, ViTConfig)
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    vocab = out / "wordpiece_vocab.txt"
    vocab_size = write_wordpiece_vocab(vocab)
    vit, bert = ViTConfig.blip_large(), BertConfig.blip_base()
    # per batch: each CLIP vision tower's layers; ImageReward's ViT layers and
    # BERT cross-attention layers
    layers = ([CLIPVisionConfig.vit_h14().layers] * 3 + [CLIPVisionConfig.vit_l14().layers]
              + [vit.layers + bert.layers])

    def run(n, bs, rec, extra=(), name=None, source=("--prompts_json", "imagereward")):
        path = out / f"{name or f'eval_b{bs}'}.json"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        t0 = time.perf_counter()
        with rec or contextlib.nullcontext():
            ev.main(["--device", "cuda", "--seed", str(seed), *source,
                     "--max_prompts", str(n), "--batch_size", str(bs), "--scorers",
                     ",".join(ev.SCORERS), "--aesthetic_mlp_path", "packaged",
                     "--wordpiece_vocab", str(vocab), "--timing", "--output_json", str(path),
                     *extra])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, peak = dict(kernel_lib.launch_counts), torch.cuda.max_memory_allocated()
        want = expected_eval_launches(UNetConfig.sdxl(), VAEConfig.sdxl(), 4, -(-n // bs), layers,
                                      decodes=bs)
        if counts != want:
            raise AssertionError(f"eval launch counts {counts} != expected {want}")
        result = json.loads(path.read_text())
        for name in ev.SCORERS:
            scores = result["per_prompt"][name]
            if len(scores) != n or not all(math.isfinite(x) for x in scores):
                raise AssertionError(f"eval {name} scores {scores}")
        return {"result": result, "launches": counts, "peak_bytes": peak, "wall_s": wall_s}

    main_run = run(prompts, 2, recorder)
    tokens = (vit.image_size // vit.patch_size) ** 2 + 1
    head_dim = vit.width // vit.heads
    for q, kv in (((2, tokens, vit.heads, head_dim), tokens),
                  ((2, 35, bert.heads, bert.hidden // bert.heads), tokens)):
        if not any(qs == q and ks[1] == kv for qs, ks, _ in recorder.attention):
            raise AssertionError(f"the eval gave the attention no q {q} kv {kv}")
    solo = run(2, 1, None)
    per_prompt, solo_scores = main_run["result"]["per_prompt"], solo["result"]["per_prompt"]
    errs, used = {}, {}
    for name in ev.SCORERS:
        got, want = torch.tensor(per_prompt[name][:2]), torch.tensor(solo_scores[name])
        errs[name] = check_close(f"eval {name} batch 2 vs batch 1", got, want, TOL["eval_batch"])
        used[name] = tolerance_used(got, want, TOL["eval_batch"])
    chunked = run(prompts, 2, recorder, ["--score_chunk", "4", "--offload_scorers",
                                         "--vae_decode_chunk", "1"], "eval_chunked",
                  ("--hf_dataset", str(FIXTURE), "--split", "test_unique"))
    for name in ev.SCORERS:
        if chunked["result"]["per_prompt"][name] != per_prompt[name]:
            raise AssertionError(f"eval {name}: chunked and offloaded scores "
                                 f"{chunked['result']['per_prompt'][name]} != {per_prompt[name]}")
    timing = main_run["result"]["timing"]
    summary = {
        "prompts": prompts, "batch_size": 2, "resolution": 1024, "scorers": list(ev.SCORERS),
        "wordpiece_vocab_size": vocab_size,
        "means": {k: v for k, v in main_run["result"].items() if k.endswith("_mean")},
        "per_prompt": per_prompt, "batch1_scores": solo_scores, "batch1_max_abs_diff": errs,
        "batch1_tolerance_used": used, "timing": timing, "launches": main_run["launches"],
        "peak_bytes": main_run["peak_bytes"], "wall_s": main_run["wall_s"],
        "batch1_run": {k: solo[k] for k in ("launches", "peak_bytes", "wall_s")},
        "chunked_run": {"args": f"--hf_dataset {FIXTURE.relative_to(ROOT)} --split test_unique "
                                "--score_chunk 4 --offload_scorers --vae_decode_chunk 1",
                        "timing": chunked["result"]["timing"], "scores_bit_equal": True,
                        **{k: chunked[k] for k in ("launches", "peak_bytes", "wall_s")}},
        "launches_all_runs": {k: main_run["launches"][k] + chunked["launches"][k]
                              for k in main_run["launches"]},
    }
    log(f"eval (DMD2 at 1024^2, {prompts} ImageReward prompts at batch 2, five scorers): "
        f"{timing['prompts_per_min']:.2f} prompts/min (steady batches {timing['steady_batch_s']:.3f} "
        f"s, generation {timing['gen_s']:.3f} s, scoring {timing['score_s']}), peak "
        f"{main_run['peak_bytes'] / 2**30:.2f} GiB; means {summary['means']}; launches "
        f"{main_run['launches']}; first two prompts at batch 1: max|diff| "
        + ", ".join(f"{k} {v:.2e} (share of limit {used[k]:.3f})" for k, v in errs.items()))
    ct = chunked["result"]["timing"]
    log(f"eval of the fixture's test_unique split (--hf_dataset) with --score_chunk 4 "
        f"--offload_scorers --vae_decode_chunk 1: "
        f"{ct['prompts_per_min']:.2f} prompts/min (steady chunks {ct['steady_batch_s']:.3f} s, "
        f"staging {ct['stage_s']}), peak {chunked['peak_bytes'] / 2**30:.2f} GiB; scores "
        f"bit-equal to the default run's; launches {chunked['launches']}")
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------- #
# DreamBooth PSO (instance PNGs, self-generated negatives, LoRA updates)
# ---------------------------------------------------------------------- #

DB_IMAGES = ((600, 520), (520, 640), (560, 600), (640, 576))  # (h, w) of the instance PNGs


def _instance_image(h, w, rng):
    """A smooth colour field with noise, uint8 (random content the resize
    and crops act on)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phase = rng.uniform(0, 6.3, 3)
    base = np.stack([np.sin(6 * xx + p) + np.cos(5 * yy - p) for p in phase], -1)
    return np.clip(127.5 + 60 * base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


class _WarningLog(logging.Handler):
    """The messages of the warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def optimizer_cuda_vs_cpu(make, lora, grads, steps=2):
    """Two steps of the optimizer ``make(params)`` builds over copies of
    ``lora`` on the card and on the CPU, with the same gradients scaled to a
    global norm of 0.5 (below every clip, so both devices step on the same
    bits). The CPU is the reference (its square root is the fp64 one rounded
    to fp32): every int8 payload and its scales must be bit-equal, and the
    parameters must agree within 1e-6. Returns the parameters' largest
    difference and, for each state tensor, whether it is bit-equal."""
    import torch

    from pairwise_sample_optimization_tpu_torch.train.train_state import global_norm

    norm = float(global_norm(grads.values()))
    on_grads = {k: g * (0.5 / norm) for k, g in grads.items()}
    off_grads = {k: g.cpu() for k, g in on_grads.items()}
    on = {k: torch.nn.Parameter(v.detach().clone()) for k, v in lora.items()}
    off = {k: torch.nn.Parameter(v.detach().cpu()) for k, v in lora.items()}
    tx_on, tx_off = make(on), make(off)
    for _ in range(steps):
        tx_on.step(on, on_grads)
        tx_off.step(off, off_grads)
    equal = {}
    for name in tx_on.state_names:  # a tensor, or one per chunk (the per-tensor 8-bit AdamW)
        a, b = getattr(tx_on, name), getattr(tx_off, name)
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        equal[name] = all(x.device.type == "cuda" and torch.equal(x.cpu(), y) for x, y in pairs)
    err = max(float((on[k].detach().cpu() - off[k].detach()).abs().max()) for k in on)
    int8_state = [n for n in tx_on.state_names if n.startswith(("mu_", "nu_"))]
    if err > 1e-6 or not all(equal[n] for n in int8_state):
        raise AssertionError(f"{type(tx_on).__name__} on the card vs the CPU: params differ by "
                             f"{err}, state bit-equal {equal}")
    return {"param_max_abs_err": err, "state_bit_equal": equal}


def optimizer_step_times(lora, seed, steps=10):
    """Each DreamBooth optimizer (``FlatAdamW`` with fp32 and with bf16
    first moments, ``Adam8bit``, ``Prodigy``; the CLI's settings, the UNet
    and the text encoders in two groups where the CLI makes two), and full
    finetuning's per-tensor 8-bit AdamW (``ForeachAdam8bit``), over fresh
    copies of ``lora``'s tensors with random gradients: the median
    synchronized wall ms of a step after 2 warm-up steps, the device ms of a
    step (``timed_ms``, the host's enqueueing hidden), and its agreement
    with the same steps on the CPU (``optimizer_cuda_vs_cpu``)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.train import make_optimizer
    from pairwise_sample_optimization_tpu_torch.train.prodigy import Prodigy

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = {k: torch.randn(v.shape, generator=gen, device="cuda") * 1e-3
             for k, v in lora.items()}

    def groups(ps):
        te = {k: p for k, p in ps.items() if k.startswith(("te1.", "te2."))}
        return [{"params": {k: p for k, p in ps.items() if k not in te}, "lr": 2e-4,
                 "weight_decay": 1e-4}, {"params": te, "lr": 5e-5, "weight_decay": 1e-2}]

    makers = {"adamw_fp32": lambda ps: make_optimizer(groups(ps), max_grad_norm=1.0),
              "adamw_bf16_mu": lambda ps: make_optimizer(groups(ps), max_grad_norm=1.0,
                                                         state_dtype="bfloat16"),
              "adam8bit": lambda ps: make_optimizer(groups(ps), max_grad_norm=1.0,
                                                    use_8bit=True),
              "adam8bit_per_tensor": lambda ps: make_optimizer(
                  groups(ps), max_grad_norm=1.0, use_8bit=True, per_tensor=True),
              "prodigy": lambda ps: Prodigy(ps, learning_rate=1.0, weight_decay=1e-4,
                                            use_bias_correction=True, safeguard_warmup=True)}
    out = {"tensors": len(lora), "elements": sum(p.numel() for p in lora.values())}
    for name, make in makers.items():
        agreement = optimizer_cuda_vs_cpu(make, lora, grads)
        params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in lora.items()}
        tx = make(params)
        step = lambda: tx.step(params, grads)
        for _ in range(2):
            step()
        walls = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"wall_ms": statistics.median(walls),
                     "device_ms": timed_ms(step, reps=5, inner=5), "cuda_vs_cpu": agreement}
        del tx, params
    return out


def dora_overhead(pipe, seed, reps=4):
    """Synchronized wall ms of one ``pso`` microbatch (policy forward and
    backward, the static-0 reference forward) at 512^2, batch 1 per half,
    with the UNet's DoRA on and off (the same modules: ``use_dora`` turned
    off for the off runs), in turns on, off, off, on, ..."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models.layers import LoRALinear
    from pairwise_sample_optimization_tpu_torch.train import (DreamBoothPSOConfig,
                                                              DreamBoothPSOTrainer)
    from pairwise_sample_optimization_tpu_torch.train.dreambooth_pso import (
        sample_lattice_timesteps)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    hw = pipe.latent_hw
    lat = lambda: torch.randn((1, hw, hw, 4), generator=gen, device="cuda")
    vocab = pipe.te1.config.vocab_size
    ids = torch.randint(1, vocab - 1, (1, 77), generator=gen, device="cuda")
    ids[:, 10] = vocab - 1  # the end token: the highest id
    cond = {k: v for k, v in pipe.encode_prompt(ids, ids).items() if k != "reward_ids"}
    micro = {"instance_latents": lat(), "negative_latents": lat(), "cond": cond}
    trainer = DreamBoothPSOTrainer(DreamBoothPSOConfig(loss_type="pso", fuse_ref_pass=False),
                                   pipe)
    idx = sample_lattice_timesteps(1, 1000, 4, gen, "cuda")
    noise = lat()
    dora = [m for m in pipe.unet.modules() if isinstance(m, LoRALinear) and m.use_dora]

    def run(on):
        for m in dora:
            m.use_dora = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.microbatch_loss(micro, idx, noise)
        loss.backward()
        torch.cuda.synchronize()
        pipe.unet.zero_grad(set_to_none=True)
        return (time.perf_counter() - t0) * 1e3

    run(True)
    run(False)
    times = {True: [], False: []}
    for i in range(reps):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            times[on].append(run(on))
    for m in dora:
        m.use_dora = True
    on, off = statistics.median(times[True]), statistics.median(times[False])
    return {"dora_layers": len(dora), "microbatch_ms_dora": on, "microbatch_ms_lora": off,
            "overhead_ms": on - off, "runs_ms": {"dora": times[True], "lora": times[False]}}


def dreambooth_slice(seed, recorder):
    """``cli.train_pso_sdxl_turbo_dreambooth.main`` at full width and 512^2
    (random weights from ``seed``, bf16 towers, fp32 LoRA rank 16, remat
    "full") on four instance PNGs of non-square sizes written by the port's
    writer, shapes recorded into ``recorder``. Run A (the reference
    workload's shape: ``pso_db``, ``euler_edm``, batch 1, 4 accumulation
    steps, 4 negatives, checkpoints and validation every 2 steps with one
    image per prompt) to step 2, then again with ``--resume_from_checkpoint
    latest`` to step 3; run B (``pso``, ``edm``, prior preservation with 4
    class images generated into the class directory, 2 accumulation steps)
    one step. Checks: launch counts as ``expected_dreambooth_launches``
    says, finite losses, run A2 starting at step 2, the LoRA moved and the
    frozen UNet unchanged (against a rebuild from the seed), run B's first
    loss minus ``prior_loss_weight`` x its lose loss at log 2 (a fresh
    adapter: policy = reference), ``lora-2`` and ``lora-3`` equal to the
    adapters ``checkpoint-2`` and ``checkpoint-3`` restore, 25 validation
    PNGs under ``gen_2/``, four class PNGs written. Run C (``pso`` with DoRA,
    so its reference pass is a forward of its own, text-encoder LoRA at
    lr 5e-5, Prodigy at lr 1.0, the kohya export, 2 accumulation steps, no
    prior) two steps with a validation at step 2: launch counts, its first
    loss minus the prior term at log 2 (DoRA and the text encoders' LoRA
    start as no-ops), the UNet's and both text encoders' adapters and DoRA
    magnitudes moved, every frozen weight bit-equal to a rebuild, Prodigy's
    d finite and at least d0, ``lora-2`` holding the ``unet.``,
    ``text_encoder.`` and ``text_encoder_2.`` tensors ``checkpoint-2``
    holds, the kohya file's keys the diffusers file's mapped with ``.alpha``
    16. Then each optimizer's step time over run C's adapters and its steps
    on the card against the same steps on the CPU
    (``optimizer_step_times``) and the DoRA overhead of a microbatch
    (``dora_overhead``). Run D (``pso_db``, the 8-bit AdamW, text-encoder
    LoRA at lr 5e-5 and weight decay 1e-2, 2 accumulation steps) one step:
    launch counts, int8 moments on the card, two parameter groups, a
    finite loss."""
    import numpy as np
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import (KOHYA_FILE, LORA_FILE,
                                                                    load_file, restore_train_state)
    from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as db
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                              make_optimizer)
    from pairwise_sample_optimization_tpu_torch.train.prodigy import D0
    from pairwise_sample_optimization_tpu_torch.utils.png import read_png, write_png

    root = RUN_DIR / "dreambooth"
    shutil.rmtree(root, ignore_errors=True)
    inst = root / "instance"
    inst.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(DB_IMAGES):
        write_png(str(inst / f"{i}.png"), _instance_image(h, w, rng))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    common = ["--device", "cuda", "--seed", str(seed), "--instance_data_dir", str(inst),
              "--instance_prompt", "a photo of sks dog", "--class_prompt", "a photo of dog",
              "--rank", "16", "--train_batch_size", "1", "--gradient_checkpointing",
              "--num_negatives", "4", "--sample_batch_size", "4", "--checkpointing_steps", "2",
              "--validation_steps", "2", "--num_validation_images", "1"]
    run_a = common + ["--output_dir", str(root / "a"), "--loss_type", "pso_db",
                      "--scheduler_space", "euler_edm", "--gradient_accumulation_steps", "4"]
    run_b = common + ["--output_dir", str(root / "b"), "--loss_type", "pso",
                      "--scheduler_space", "edm", "--with_prior_preservation", "--class_data_dir",
                      str(root / "class"), "--num_class_images", "4",
                      "--gradient_accumulation_steps", "2", "--max_train_steps", "1",
                      "--use_wandb"]

    def run(name, argv, first_step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        t0 = time.perf_counter()
        with recorder:
            state, history, pipe = db.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, peak = dict(kernel_lib.launch_counts), torch.cuda.max_memory_allocated()
        args = db.parse_args(argv)
        want = expected_dreambooth_launches(pipe, args, len(DB_IMAGES), len(history), first_step,
                                            sms=sms)
        if counts != want:
            raise AssertionError(f"dreambooth {name} launch counts {counts} != expected {want}")
        if state.step - len(history) != first_step or not history:
            raise AssertionError(f"dreambooth {name} ran steps {state.step - len(history) + 1}.."
                                 f"{state.step}, expected from {first_step + 1}")
        for m in history:
            if not all(math.isfinite(m[k]) for k in ("loss", "win_loss", "lose_loss")):
                raise AssertionError(f"dreambooth {name}: non-finite metrics {m}")
        out = Path(args.output_dir)
        rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        setup = next(r for r in reversed(rows) if "time/encode_s" in r)
        return {"history": history, "launches": counts, "expected_launches": want,
                "wall_s": wall_s, "peak_bytes": peak, "setup_s": {
                    k[5:-2]: v for k, v in setup.items() if k.startswith("time/")},
                "validation_s": [r["time/validation_s"] for r in rows
                                 if "time/validation_s" in r]}, state, pipe

    a1, state, pipe = run("A1", run_a + ["--max_train_steps", "2"], 0)
    del pipe, state  # each run's adapters and optimizer state go before the next run
    torch.cuda.empty_cache()
    a2, state, pipe = run("A2", run_a + ["--max_train_steps", "3",
                                         "--resume_from_checkpoint", "latest"], 2)
    # frozen UNet weights unchanged and LoRA moved, against a rebuild from the
    # seed (the UNet is the first tower SDXLPipeline.random draws)
    ref = SDXLUNet(pipe.unet.config, device="meta").to_empty(device="cuda")
    init_random_(ref, torch.Generator(device="cuda").manual_seed(seed))
    frozen, lora = _frozen_and_lora(pipe.unet)
    frozen0, lora0 = _frozen_and_lora(ref)
    changed = [k for k in frozen if not torch.equal(frozen[k], frozen0[k])]
    lora_moved = max(float((lora[k].float() - lora0[k].float()).abs().max()) for k in lora)
    if changed or lora_moved == 0:
        raise AssertionError(f"dreambooth: frozen UNet weights changed {changed[:5]} or LoRA did "
                             f"not move (max|delta| {lora_moved})")
    # each lora-<step> file holds the adapter its checkpoint restores
    lora_ref = lora_parameters(ref)
    restored = PSOTrainState.create(lora_ref, make_optimizer(lora_ref))
    exports = {}
    for step in (2, 3):
        extra = restore_train_state(str(root / "a" / f"checkpoint-{step}"), restored)
        exported = load_file(str(root / "a" / f"lora-{step}" / LORA_FILE))
        want_lora = {"unet." + k: v.detach().float().cpu() for k, v in restored.lora.items()}
        if extra.get("step") != step or set(exported) != set(want_lora) or any(
                not torch.equal(exported[k], want_lora[k]) for k in want_lora):
            raise AssertionError(f"dreambooth lora-{step} is not checkpoint-{step}'s adapter")
        exports[step] = len(exported)
    if any(not torch.equal(restored.lora[k], state.lora[k]) for k in state.lora):
        raise AssertionError("dreambooth: checkpoint-3 does not hold the final adapter")
    pngs = sorted((root / "a" / "gen_2").glob("p_*/img_*.png"))
    if len(pngs) != DB_VALIDATION_PROMPTS or any(read_png(str(p)).shape != (512, 512, 3)
                                                 for p in pngs):
        raise AssertionError(f"gen_2/ holds {len(pngs)} validation PNGs")
    del pipe, state, ref, restored, frozen, frozen0, lora, lora0, lora_ref
    torch.cuda.empty_cache()
    # run B asks for wandb with its import blocked (the card's machine may have
    # wandb, and a wandb run would reach for the network): the CLI must warn and
    # keep metrics.jsonl
    warned = _WarningLog()
    blocked, sys.modules["wandb"] = sys.modules.get("wandb"), None
    logging.getLogger("pso").addHandler(warned)
    try:
        b, state, pipe = run("B", run_b, 0)
    finally:
        logging.getLogger("pso").removeHandler(warned)
        if blocked is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = blocked
    del pipe, state
    b["wandb_warning"] = [m for m in warned.messages if "wandb unavailable" in m]
    rows_b = (root / "b" / "metrics.jsonl").read_text().splitlines()
    if not b["wandb_warning"] or not any("loss" in json.loads(r) for r in rows_b):
        raise AssertionError(f"dreambooth B --use_wandb without wandb: warnings {warned.messages}, "
                             f"{len(rows_b)} JSONL rows")
    torch.cuda.empty_cache()
    first = b["history"][0]
    prior_w = db.parse_args(run_b).prior_loss_weight
    if abs(first["loss"] - prior_w * first["lose_loss"] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"dreambooth B first loss {first} - {prior_w} x lose_loss != log 2")
    class_pngs = sorted((root / "class").glob("class-*.png"))
    if len(class_pngs) != 4:
        raise AssertionError(f"class directory holds {[p.name for p in class_pngs]}")

    run_c = common + ["--output_dir", str(root / "c"), "--loss_type", "pso", "--use_dora",
                      "--train_text_encoder", "--text_encoder_lr", "5e-5", "--optimizer",
                      "prodigy", "--learning_rate", "1.0", "--output_kohya_format",
                      "--gradient_accumulation_steps", "2", "--max_train_steps", "2",
                      "--skip_validation"]
    c, state, pipe = run("C", run_c, 0)
    first = c["history"][0]
    if abs(first["loss"] - prior_w * first["lose_loss"] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"dreambooth C first loss {first} - {prior_w} x lose_loss != log 2")
    ref = SDXLPipeline.random(16, torch.bfloat16, 512, seed=seed, remat="full", device="cuda",
                              with_scorer=False, te_lora_rank=16, use_dora=True)
    moved, changed = {}, []
    for which in ("unet", "te1", "te2"):  # state_dict() holds the towers' tensors: none kept
        (frozen, lora), (frozen0, lora0) = (_frozen_and_lora(getattr(p, which))
                                            for p in (pipe, ref))
        changed += [f"{which}.{k}" for k in frozen if not torch.equal(frozen[k], frozen0[k])]
        for leaf in ("down.weight", "up.weight", "magnitude"):
            moved[f"{which}.{leaf}"] = max(float((lora[k].float() - lora0[k].float()).abs().max())
                                           for k in lora if k.endswith(".lora." + leaf))
    del frozen, lora, frozen0, lora0
    d, d0 = float(state.tx.d), float(torch.tensor(D0))  # D0 as the fp32 d holds it
    if changed or min(moved.values()) == 0 or not (math.isfinite(d) and d >= d0):
        raise AssertionError(f"dreambooth C: frozen weights changed {changed[:5]}, adapters "
                             f"moved {moved}, prodigy d {d}")
    blob = torch.load(root / "c" / "checkpoint-2" / "state.pt", map_location="cpu",
                      weights_only=True)
    prefix = {"te1": "text_encoder.", "te2": "text_encoder_2."}
    want_lora = {}
    for k, v in blob["lora"].items():
        which, rest = k.split(".", 1) if k.startswith(("te1.", "te2.")) else ("unet", k)
        rest = rest.replace(".lora.magnitude", ".lora_magnitude_vector")
        want_lora[prefix.get(which, "unet.") + rest] = v.float()
    diffusers = load_file(str(root / "c" / "lora-2" / LORA_FILE))
    if blob["step"] != 2 or set(diffusers) != set(want_lora) or any(
            not torch.equal(diffusers[k], want_lora[k]) for k in want_lora):
        raise AssertionError("dreambooth C: lora-2 is not checkpoint-2's adapters")
    kohya = load_file(str(root / "c" / "lora-2" / KOHYA_FILE))
    kohya_prefix = {"unet.": "lora_unet_", "text_encoder.": "lora_te1_",
                    "text_encoder_2.": "lora_te2_"}
    kohya_suffix = {".lora.down.weight": ".lora_down.weight", ".lora.up.weight": ".lora_up.weight",
                    ".lora_magnitude_vector": ".dora_scale"}
    mapped = set()
    for k in diffusers:
        head = next(h for h in sorted(kohya_prefix, key=len, reverse=True) if k.startswith(h))
        tail = next(t for t in kohya_suffix if k.endswith(t))
        site = kohya_prefix[head] + k[len(head):-len(tail)].replace(".", "_")
        mapped.add(site + kohya_suffix[tail])
        if tail == ".lora.down.weight":
            mapped.add(site + ".alpha")
    alphas = [float(v) for k, v in kohya.items() if k.endswith(".alpha")]
    if set(kohya) != mapped or set(alphas) != {16.0}:
        raise AssertionError(f"dreambooth C: kohya keys {len(kohya)} vs {len(mapped)} mapped, "
                             f"alphas {set(alphas)}")
    if {k.split(".")[0] for k in diffusers} != {"unet", "text_encoder", "text_encoder_2"}:
        raise AssertionError("dreambooth C: lora-2 lacks a tower's adapter")
    c_pngs = len(sorted((root / "c" / "gen_2").glob("p_*/img_*.png")))
    if c_pngs:  # --skip_validation
        raise AssertionError(f"dreambooth C: gen_2/ holds {c_pngs} validation PNGs")
    del ref
    torch.cuda.empty_cache()
    opt_times = optimizer_step_times(state.lora, seed)
    overhead = dora_overhead(pipe, seed)
    del pipe, state
    torch.cuda.empty_cache()

    run_d = common + ["--output_dir", str(root / "d"), "--loss_type", "pso_db", "--use_8bit_adam",
                      "--train_text_encoder", "--text_encoder_lr", "5e-5",
                      "--adam_weight_decay_text_encoder", "1e-2", "--gradient_accumulation_steps",
                      "2", "--max_train_steps", "1", "--skip_validation"]
    dd, state, pipe = run("D", run_d, 0)
    tx = state.tx
    if (type(tx).__name__ != "Adam8bit" or tx.mu_q.dtype != torch.int8
            or tx.mu_q.device.type != "cuda" or len(tx.group_slices) != 2
            or not math.isfinite(dd["history"][0]["loss"])):
        raise AssertionError(f"dreambooth D: optimizer {type(tx).__name__} groups "
                             f"{len(getattr(tx, 'group_slices', []))} loss {dd['history']}")
    d_moments = {"mu_q": [tx.mu_q.dtype.__repr__(), list(tx.mu_q.shape)],
                 "groups": [(end - start, lr, wd) for start, end, lr, wd, _ in tx.group_slices]}
    del pipe, state, tx
    torch.cuda.empty_cache()
    steady = [m["time/step_s"] for m in a1["history"][1:] + a2["history"]]
    launches = {k: sum(r["launches"][k] for r in (a1, a2, b, c, dd)) for k in KERNELS}
    summary = {
        "instance_images": [list(hw) for hw in DB_IMAGES], "resolution": 512, "lora_rank": 16,
        "run_a1": a1, "run_a2": a2, "run_b": b, "run_c": c, "run_d": dd, "launches": launches,
        "s_per_step_steady": statistics.median(steady), "steady_steps_s": steady,
        "negatives_s": a1["setup_s"].get("negatives"), "encode_s": a1["setup_s"].get("encode"),
        "validation_s": a1["validation_s"][0], "lora_max_abs_delta": lora_moved,
        "lora_exports": exports, "validation_pngs": len(pngs),
        "peak_bytes": max(r["peak_bytes"] for r in (a1, a2, b)),
        "run_c_checks": {"adapters_moved": moved, "prodigy_d": d, "lora_files": len(diffusers),
                         "kohya_keys": len(kohya), "validation_pngs": c_pngs},
        "run_d_optimizer": d_moments, "optimizer_step": opt_times, "dora": overhead,
    }
    log(f"dreambooth (512^2, 4 instance PNGs): run A pso_db/euler_edm ga 4 policy batch 2: "
        f"{summary['s_per_step_steady']:.3f} s per optimizer step (steady steps "
        f"{[round(x, 3) for x in steady]}; first {a1['history'][0]['time/step_s']:.3f} s), "
        f"negatives {summary['negatives_s']:.3f} s (4 images), encode {summary['encode_s']:.3f} s "
        f"({len(DB_IMAGES) * DB_VIEWS} views + 4 negatives), validation "
        f"{summary['validation_s']:.3f} s (25 images), losses "
        f"{[round(m['loss'], 5) for m in a1['history'] + a2['history']]}, A2 resumed at step 2; "
        f"run B pso/edm prior ga 2 policy batch 8 (fused): {b['history'][0]['time/step_s']:.3f} s, "
        f"loss {first['loss']:.6f} = log 2 + {prior_w} x {first['lose_loss']:.6f}, --use_wandb "
        f"with wandb blocked warned and kept metrics.jsonl, class images "
        f"{b['setup_s'].get('class_images', 0):.3f} s; peak {summary['peak_bytes'] / 2**30:.2f} "
        f"GiB; LoRA max|delta| {lora_moved:.3e}, frozen unchanged; lora-2/3 equal their "
        f"checkpoints; launches {launches}")
    c_steps = [m["time/step_s"] for m in c["history"]]
    log(f"dreambooth run C (pso, DoRA, text-encoder LoRA, prodigy, kohya; ga 2, policy batch 2 "
        f"+ a reference forward): s per step {[round(x, 3) for x in c_steps]}, losses "
        f"{[round(m['loss'], 6) for m in c['history']]}, peak "
        f"{c['peak_bytes'] / 2**30:.2f} GiB, prodigy d "
        f"{d:.3e}, adapters moved {moved}, {len(diffusers)} diffusers / {len(kohya)} kohya "
        f"tensors; run D (pso_db, 8-bit AdamW, 2 groups, text-encoder LoRA): "
        f"{dd['history'][0]['time/step_s']:.3f} s, loss {dd['history'][0]['loss']:.6f}, peak "
        f"{dd['peak_bytes'] / 2**30:.2f} GiB")
    log(f"optimizer step over run C's {opt_times['tensors']} adapter tensors "
        f"({opt_times['elements']} elements), wall / device ms: " + ", ".join(
            f"{k} {v['wall_ms']:.3f} / {v['device_ms']:.3f}" for k, v in opt_times.items()
            if isinstance(v, dict)))
    log(f"DoRA overhead of a pso microbatch ({overhead['dora_layers']} DoRA layers): "
        f"{overhead['microbatch_ms_dora']:.1f} ms with DoRA, {overhead['microbatch_ms_lora']:.1f} "
        f"ms without, {overhead['overhead_ms']:.1f} ms")
    shutil.rmtree(root, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------- #
# data parallelism: two ranks sharing the card over gloo, NCCL at world 1
# ---------------------------------------------------------------------- #

DIST_WORLD = 2  # ranks sharing the one card
DIST_TIMEOUT_S = 300  # the group's: the longest wait is for rank 0's checkpoint
DIST_JOIN_S = 780  # the ranks' whole run: data-parallel, sharded and small
# per rank: one pair batch of 1 prompt, one update of 3 microbatches of
# policy batch 2 over the global pairs (2 on one card); checkpoint and LoRA
# export at step 1
DIST_CONFIG = {"sample.batch_size": 1, "sample.num_batches_per_epoch": 1,
               "train.batch_size": 1, "train.gradient_accumulation_steps": 1,
               "validation_steps": 0}
# the sharded meshes and the runs they are held against: DIST_CONFIG cut to
# 1 prompt a rank, 2 Turbo steps and one update of 1 microbatch (there are
# five such runs a rank; FSDP's weight gathers go through the host on one
# card, and the script runs within a time limit), with every LoRA ``up``
# drawn from a normal of this std (seeded) instead of zero, so that every
# ``down`` has a gradient in the one update
SHARDED_CONFIG = {**DIST_CONFIG, "sample.batch_size": 1, "train.gradient_accumulation_steps": 1,
                  "sample.num_steps": 2, "train.distilled_train_steps": 1}
SHARDED_LORA_UP_STD = 1e-3
DIST_SMALL_PAIRS = 4  # the small pipeline's sample set of part (b)
# world 2 vs world 1 on the small fp32 pipeline: the LoRA after one AdamW
# step at lr 1e-3 (a first step is at most lr in size, so the limit sits far
# below it), and the update's loss, ratio_win and grad_norm
DIST_SMALL_TOL = (5e-5, 5e-5)
DIST_SMALL_METRICS_TOL = (1e-6, 1e-3)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _small_trainer(pipe, world):
    from pairwise_sample_optimization_tpu_torch.train import OnlinePSOConfig, OnlinePSOTrainer

    return OnlinePSOTrainer(OnlinePSOConfig(num_steps=4, train_batch_size=DIST_SMALL_PAIRS // world,
                                            grad_accum=1), pipe)


def _small_epoch(pipe, samples, cond, world, seed, num_batches=1):
    """``train_epoch`` of the small pipeline's LoRA over ``samples``
    (``num_batches`` pair batches): one update of the global
    DIST_SMALL_PAIRS pairs. Returns the LoRA (CPU) and the update's
    metrics."""
    import torch

    from pairwise_sample_optimization_tpu_torch.train import (PSOTrainState, lora_parameters,
                                                              make_optimizer)

    lora = lora_parameters(pipe.unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, learning_rate=1e-3))
    _, metrics = _small_trainer(pipe, world).train_epoch(
        state, samples, cond, torch.Generator().manual_seed(seed + 3), num_batches)
    if len(metrics) != 1:
        raise AssertionError(f"{len(metrics)} updates over the small sample set, expected 1")
    return {k: v.detach().cpu() for k, v in state.lora.items()}, metrics[0]


def _digest(tensors):
    """sha256 of named tensors' names and bytes: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().cpu().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()


# the sharded runs of ``distributed_slice`` after the data-parallel one: (name,
# mesh overrides) on one card (two gloo ranks) and on four cards (NCCL)
# on one card TP runs with the int8 reference pass (as its world-1 run does),
# which takes the TP path of both the bf16 policy pass and the int8 reference
# pass in one run; the four cards keep the bf16 reference pass
ONE_CARD_INT8 = {"train.int8_ref_pass": True}
SHARDED_ONE_CARD = (("tp", {"mesh.data": 1, "mesh.model": 2, **ONE_CARD_INT8}),
                    ("fsdp", {"mesh.fsdp": True}))
SHARDED_FOUR_CARDS = (("tp_2x2", {"mesh.data": 2, "mesh.model": 2}),
                      ("tp_1x4", {"mesh.data": 1, "mesh.model": 4}),
                      ("fsdp", {"mesh.fsdp": True}))
# tensor parallelism at data 1 against one process on the same card: the
# row-parallel sums are bf16 products summed in another order (fp32 sums of
# the ranks' bf16 partials, one rounding), a few bf16 ulps per activation
# that 70 transformer blocks carry into the LoRA gradient. Limits: each
# LoRA tensor's gradient error (L2) within TP_GRAD_RTOL of its own norm plus
# the norm it would have were the whole gradient spread evenly (atol + rtol:
# a tensor whose gradient is far below the rms, as attention's at a
# saturated softmax, is mostly rounding noise; a rank's share of a
# replicated tensor's gradient, or a wrong slice, is off by about its whole
# norm), and the cosine of the LoRA's AdamW step
TP_GRAD_RTOL = 0.15
TP_STEP_COSINE = 0.9
# FSDP against the data-parallel run: every forward bit-identical (the
# gathers are exact: the epoch's rewards, the update's loss and ratio_win);
# the gradient only as close as two data-parallel runs of the one update
# are (the backward kernel's fp32 dQ sums come in another order each run,
# ``RUN_TO_RUN``, and some of their bf16 roundings turn): its relative L2
# from the first run at most this many times the second run's
FSDP_SPREAD_FACTOR = 4


def _whole(tensors, params=None):
    """Whole tensors on the CPU: the tensor-parallel slices of ``params``
    (default: ``tensors`` themselves) gathered (a collective)."""
    from pairwise_sample_optimization_tpu_torch.parallel import tp

    params = tensors if params is None else params
    return {k: (tp.shard_of(params[k]).gather(v.detach()) if tp.shard_of(params[k])
                else v.detach()).to("cpu", copy=True) for k, v in tensors.items()}


def _loop_run(config, out_dir, name, capture=False, lora_up_std=0.0):
    """One Turbo epoch through ``run_online_pso`` with its observation: the
    prompts the loader gave, the synchronized wall time of the phases and
    the collectives (the gradient all-reduce, the gathers and broadcast,
    tensor parallelism's activation all-reduces, FSDP's weight gathers),
    the launch counts (zeroed just before, read just after), the whole
    LoRA's digest, the resident bytes of the UNet and of the frozen suite.
    ``capture``: rank 0 writes the whole LoRA gradient of the first update,
    the LoRA before and after it to ``<out_dir>/<name>_update.pt``.
    ``lora_up_std``: every LoRA ``up`` of the new UNet drawn from a normal of
    this std (a generator seeded with the config's seed, before the weights
    are placed on the mesh) instead of zero."""
    import torch

    from pairwise_sample_optimization_tpu_torch import parallel
    from pairwise_sample_optimization_tpu_torch.cli import online_runner
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.parallel import collectives, fsdp, tp
    from pairwise_sample_optimization_tpu_torch.train import online_pso, train_state

    prompts, times, captured = [], {}, {}

    class Recording(online_runner.PromptLoader):
        def epoch(self):
            for batch in super().epoch():
                prompts.append(list(batch["prompts"]))
                yield batch

    def timed(key, fn, nbytes=None):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            entry = times.setdefault(key, {"calls": 0, "ms": 0.0, "bytes": 0})
            entry["calls"] += 1
            entry["ms"] += (time.perf_counter() - t0) * 1e3
            if nbytes is not None:
                entry["bytes"] += nbytes(*args, out=out)
            return out
        return wrapper

    size = lambda t: t.numel() * t.element_size()
    # the trained tensors and the optimizer's state tensors
    state_bytes = lambda st, *a, out=None: sum(size(t) for t in [*st.lora.values(), *(
        v for v in st.tx.state_dict()["state"].values() if isinstance(v, torch.Tensor))])
    apply_gradients = train_state.PSOTrainState.apply_gradients

    def capturing(state, grads):
        if not captured:
            captured["grads"] = _whole(grads, state.lora)
            captured["before"] = _whole(state.lora)
        return apply_gradients(state, grads)

    patches = [(online_runner, "PromptLoader", Recording),
               (online_pso.OnlinePSOTrainer, "sample_pairs",
                timed("sample_pairs", online_pso.OnlinePSOTrainer.sample_pairs)),
               (online_pso.OnlinePSOTrainer, "update",
                timed("update", online_pso.OnlinePSOTrainer.update)),
               (online_pso, "all_reduce_mean_",
                timed("all_reduce_mean_", online_pso.all_reduce_mean_,
                      lambda ts, *a, out=None: sum(size(t) for t in ts))),
               (online_pso, "process_allgather",
                timed("process_allgather", online_pso.process_allgather,
                      lambda t, *a, out=None: size(t))),
               (online_runner, "broadcast_train_state_",
                timed("broadcast_train_state_", online_runner.broadcast_train_state_,
                      state_bytes)),
               (collectives, "_reduce",
                timed("tp_activation_all_reduce", collectives._reduce,
                      lambda x, *a, out=None: size(out))),
               (fsdp, "all_gather_dim",
                timed("fsdp_weight_gather", fsdp.all_gather_dim,
                      lambda t, *a, out=None: size(out)))]
    if capture:
        patches.append((train_state.PSOTrainState, "apply_gradients", capturing))
    if lora_up_std:
        build_pipeline = online_runner.build_pipeline

        def with_lora_up(*args, **kwargs):
            pipe = build_pipeline(*args, **kwargs)
            gen = torch.Generator().manual_seed(config.seed)
            with torch.no_grad():
                for k, p in sorted(pipe.unet.named_parameters()):
                    if k.endswith(".lora.up.weight"):
                        p.copy_(torch.randn(p.shape, generator=gen) * lora_up_std)
            return pipe

        patches.append((online_runner, "build_pipeline", with_lora_up))
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    recorder = ShapeRecorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with recorder:
            state, history, pipe = online_runner.run_online_pso(config, num_epochs=1,
                                                                device="cuda")
        torch.cuda.synchronize()
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
    wall_s = time.perf_counter() - t0
    counts = dict(kernel_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    mesh = parallel.current_mesh()
    t_cfg = config.train
    n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps
    sample = expected_launches(pipe, config.sample.num_steps)
    update = expected_update_launches(pipe.unet.config, n_micro, bool(t_cfg.fuse_ref_pass),
                                      2 * t_cfg.batch_size, pipe.latent_hw,
                                      torch.cuda.get_device_properties(0).multi_processor_count,
                                      tp=(mesh.model_index, mesh.model),
                                      int8_ref=bool(t_cfg.int8_ref_pass))
    want = {k: config.sample.num_batches_per_epoch * sample[k] + len(history) * update[k]
            for k in sample}
    lora = _whole(state.lora)
    frozen = [p for n, p in pipe.unet.named_parameters() if ".lora." not in n]
    frozen += [p for m in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model) for p in m.parameters()]
    out = {"name": name, "rank": parallel.rank(), "world": parallel.world_size(),
           "lora_up_std": lora_up_std,
           "mesh": {"data": mesh.data, "model": mesh.model, "fsdp": mesh.fsdp,
                    "data_index": mesh.data_index, "model_index": mesh.model_index},
           "launches": counts, "expected_launches": want, "history": history,
           "step": state.step, "prompts": prompts, "lora_sha256": _digest(lora),
           "lora_tensors": len(lora), "peak_bytes": peak, "wall_s": wall_s, "times": times,
           "n_micro": n_micro, "policy_batch": 2 * t_cfg.batch_size,
           "unet_bytes": sum(size(t) for t in [*pipe.unet.parameters(), *pipe.unet.buffers()]),
           "frozen_bytes": sum(size(p) for p in frozen),
           "tp_sliced_tensors": len(tp.tp_plan(pipe.unet)),
           "shapes": {"attention": recorder.attention, "attention_bwd": recorder.attention_bwd,
                      "gn": recorder.gn, "int8": recorder.int8}}
    if capture and parallel.rank() == 0:
        torch.save({**captured, "after": lora, "lr": float(t_cfg.learning_rate)},
                   out_dir / f"{name}_update.pt")
    del state, pipe, lora
    torch.cuda.empty_cache()
    return out


def _dist_config(seed, out_dir, name, mesh=(), base=SHARDED_CONFIG):
    from pairwise_sample_optimization_tpu_torch.configs import sdxl_turbo_dpo

    config = sdxl_turbo_dpo.get_config()
    config.seed, config.output_dir, config.run_name = seed, str(out_dir), name
    for key, value in {**base, **dict(mesh)}.items():
        config.override(f"{key}={value}")
    return config


def distributed_worker(out_dir, seed, backend):
    """One rank of ``distributed_slice`` (this script with
    ``--distributed-worker``; torchrun's variables in its environment): (a)
    the Turbo loop through ``run_online_pso`` at full width over
    ``backend`` on the card ``LOCAL_RANK`` names, data-parallel
    (``DIST_CONFIG``), then at ``SHARDED_CONFIG`` data-parallel twice and
    under each mesh of ``SHARDED_ONE_CARD`` (two ranks) or
    ``SHARDED_FOUR_CARDS`` (four), (b) ``train_epoch`` of the small pipeline
    over this rank's share of the sample set. Writes ``rank<r>.pt`` for the
    parent to check."""
    import torch

    from pairwise_sample_optimization_tpu_torch import parallel

    torch.set_num_threads(1)
    parallel.maybe_initialize_distributed(backend=backend, device="cuda",
                                          timeout_s=DIST_TIMEOUT_S)
    r, world = parallel.rank(), parallel.world_size()
    turbo = _loop_run(_dist_config(seed, out_dir, "turbo", base=DIST_CONFIG), out_dir, "turbo")
    # the sharded runs' data-parallel reference, and the same again: the
    # spread FSDP's update is held to
    ddp, again = (_loop_run(_dist_config(seed, out_dir, n), out_dir, n, capture=True,
                            lora_up_std=SHARDED_LORA_UP_STD) for n in ("ddp", "ddp_again"))
    sharded = {}
    for name, mesh in (SHARDED_FOUR_CARDS if world == 4 else SHARDED_ONE_CARD):
        sharded[name] = _loop_run(_dist_config(seed, out_dir, name, mesh), out_dir, name,
                                  capture=mesh.get("mesh.data") == 1 or "mesh.fsdp" in mesh,
                                  lora_up_std=SHARDED_LORA_UP_STD)
    parallel.reset_mesh()

    # (b) this rank's share of the small sample set, as pair batches of one
    # prompt each
    small = torch.load(out_dir / "small_samples.pt", weights_only=True)
    pipe = small_pipeline(small_modules(seed)[0], "cuda")
    half = DIST_SMALL_PAIRS // world
    rows = lambda tree: {k: v[r * half:(r + 1) * half].cuda() for k, v in tree.items()}
    lora, metrics = _small_epoch(pipe, rows(small["samples"]), rows(small["cond"]), world,
                                 seed, num_batches=half)
    torch.save({"turbo": turbo, "ddp": ddp, "again": again, "sharded": sharded, "small_lora": lora,
                "small_metrics": metrics}, out_dir / f"rank{r}.pt")
    parallel.barrier()
    parallel.shutdown_distributed()
    return 0


def sharding_prediction(lora_rank=32):
    """Resident bytes predicted from the parameter counts of the port's
    full-width towers (built on the meta device): a replica's UNet (bf16
    frozen weights, fp32 LoRA) and frozen suite (the UNet's frozen weights,
    the VAE, both text towers and PickScore, bf16), each model rank's UNet
    under tensor parallelism at model 2 and 4, and each data rank's frozen
    suite under FSDP at 2 and 4 ranks (``fsdp_plan``: the sharded leaves
    divided, the small ones whole)."""
    from pairwise_sample_optimization_tpu_torch.models.clip import (CLIPTextConfig,
                                                                     CLIPTextTower,
                                                                     CLIPVisionConfig)
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from pairwise_sample_optimization_tpu_torch.parallel import fsdp, tp
    from pairwise_sample_optimization_tpu_torch.rewards.pickscore import CLIPDualEncoder

    unet = lambda: SDXLUNet(UNetConfig.sdxl(lora_rank=lora_rank), device="meta")
    towers = {"unet": unet(), "vae": AutoencoderKL(VAEConfig.sdxl(), device="meta"),
              "te1": CLIPTextTower(CLIPTextConfig.sdxl_te1(), device="meta"),
              "te2": CLIPTextTower(CLIPTextConfig.sdxl_te2(), device="meta"),
              "pickscore": CLIPDualEncoder(CLIPTextConfig.vit_h14(), CLIPVisionConfig.vit_h14(),
                                           device="meta")}
    frozen = lambda m: {n: p.numel() for n, p in m.named_parameters() if ".lora." not in n}
    unet_bytes = lambda m: sum(p.numel() * (4 if ".lora." in n else 2)
                               for n, p in m.named_parameters())
    out = {"params": {k: sum(frozen(m).values()) for k, m in towers.items()},
           "replica_unet_bytes": unet_bytes(towers["unet"]),
           "replica_frozen_bytes": 2 * sum(sum(frozen(m).values()) for m in towers.values())}
    for model in (2, 4):
        out[f"tp{model}_unet_bytes"] = [unet_bytes(tp.shard_unet_tp(unet(), r, model, None))
                                        for r in range(model)]
    for n in (2, 4):
        total = 0
        for m in towers.values():
            plan = fsdp.fsdp_plan(m, n)
            total += 2 * sum(c // n if k in plan else c for k, c in frozen(m).items())
        out[f"fsdp{n}_frozen_bytes"] = total
    return out


def _check_sharded_run(run):
    """One rank's run: its launch counts the formula's at its batch and local
    heads, one update at step 1, the first loss log 2 with a fresh adapter
    (finite with a drawn ``up``)."""
    if run["launches"] != run["expected_launches"]:
        raise AssertionError(f"{run['name']} rank {run['rank']} launch counts {run['launches']} "
                             f"!= expected {run['expected_launches']}")
    if len(run["history"]) != 1 or run["step"] != 1:
        raise AssertionError(f"{run['name']} rank {run['rank']}: {len(run['history'])} updates, "
                             f"step {run['step']}")
    loss = run["history"][0]["loss"]
    if not (math.isfinite(loss) if run["lora_up_std"] else abs(loss - math.log(2.0)) <= 1e-3):
        raise AssertionError(f"{run['name']} rank {run['rank']} first loss "
                             f"{run['history'][0]['loss']} != log 2")


def _update_against(name, ref, out, grad_limit, cosine_limit, leaf=False):
    """Run ``name``'s first update against run ``ref``'s (both written by
    ``_loop_run(capture=True)``): the same LoRA before it, the whole LoRA
    gradient within ``grad_limit`` relative L2 or, with ``leaf``, every
    LoRA tensor's within ``grad_limit`` of its norm plus its even share of
    the whole's (``TP_GRAD_RTOL``), the cosine of the LoRA's AdamW step at
    least ``cosine_limit``."""
    import torch

    got, want = (torch.load(out / f"{n}_update.pt", weights_only=True) for n in (name, ref))
    for k in want["before"]:
        if not torch.equal(got["before"][k], want["before"][k]):
            raise AssertionError(f"{name}: the LoRA before the update differs from {ref}'s at {k}")
    flat = lambda d: torch.cat([d[k].double().reshape(-1) for k in sorted(d)])
    g, g1 = flat(got["grads"]), flat(want["grads"])
    rel_l2 = lambda a, b: float(torch.linalg.vector_norm(a.double() - b.double())
                                / torch.linalg.vector_norm(b.double()))
    rel = rel_l2(g, g1)
    norm1, n1 = float(torch.linalg.vector_norm(g1)), g1.numel()
    leaves = {}
    for k, v in want["grads"].items():
        err = float(torch.linalg.vector_norm(got["grads"][k].double() - v.double()))
        own, even = float(torch.linalg.vector_norm(v.double())), norm1 * math.sqrt(v.numel() / n1)
        leaves[k] = {"rel": err / own if own else math.inf, "norm_over_even": own / even,
                     "ratio": err / (grad_limit * (own + even))}
    worst = max(leaves, key=lambda k: leaves[k]["rel"])
    worst_ratio = max(leaves, key=lambda k: leaves[k]["ratio"])
    # per role (attn1 / attn2 x q, k, v, out x down, up): relative L2
    roles = {}
    for k in want["grads"]:
        role = ".".join(x for x in k.split(".") if x in ("attn1", "attn2", "to_q", "to_k", "to_v",
                                                          "to_out", "down", "up"))
        roles.setdefault(role, []).append(k)
    by_role = {r: rel_l2(torch.cat([got["grads"][k].reshape(-1) for k in ks]),
                         torch.cat([want["grads"][k].reshape(-1) for k in ks]))
               for r, ks in sorted(roles.items())}
    step, step1 = flat(got["after"]) - flat(got["before"]), flat(want["after"]) - flat(want["before"])
    cos = float(step @ step1 / (torch.linalg.vector_norm(step) * torch.linalg.vector_norm(step1)))
    res = {"grad_rel_l2": rel, "worst_leaf": {worst: leaves[worst]},
           "worst_ratio": leaves[worst_ratio]["ratio"],
           "worst_ratio_leaf": {worst_ratio: leaves[worst_ratio]}, "rel_l2_by_role": by_role,
           "zero_grad_leaves": sum(not bool(v.any()) for v in want["grads"].values()),
           "leaves": len(leaves), "step_cosine": cos,
           "step_max_abs_diff": float((step - step1).abs().max()), "lr": want["lr"],
           "grad_norm": float(torch.linalg.vector_norm(g)),
           f"grad_norm_{ref}": float(torch.linalg.vector_norm(g1))}
    log(f"{name} vs {ref}: {res}")
    if leaf and res["zero_grad_leaves"]:
        raise AssertionError(f"{name} vs {ref}: {res['zero_grad_leaves']} LoRA tensors of {ref} "
                             f"have no gradient to hold {name}'s against")
    if leaf and not res["worst_ratio"] <= 1:
        raise AssertionError(f"{name} vs {ref}: {worst_ratio}'s gradient off by "
                             f"{res['worst_ratio']:.3f} x its limit ({grad_limit} of its norm plus "
                             f"its even share; {leaves[worst_ratio]})")
    if not (leaf or rel <= grad_limit) or not cos >= cosine_limit:
        raise AssertionError(f"{name} vs {ref}: gradient rel L2 {rel:.3e} (limit {grad_limit}), "
                             f"step cosine {cos:.5f} (limit {cosine_limit})")
    return res


def _first_rewards(out, name):
    """The epoch's reward mean and std rank 0 logged for run ``name``."""
    rows = [json.loads(x) for x in (out / name / "metrics.jsonl").read_text().splitlines()]
    return next((x["reward_mean"], x["reward_std"]) for x in rows if "reward_mean" in x)


def _forwards(out, name, history):
    """What the forwards alone decide: the epoch's rewards (rank 0's log)
    and the update's mean loss and ratio_win (the weights do not change
    within an update)."""
    return _first_rewards(out, name), {k: history[0][k] for k in ("loss", "ratio_win")}


def _run_to_run(out, again, ddp):
    """The sharded runs' data-parallel reference and the same run again:
    every forward bit-identical (the kernels' forwards are deterministic),
    and the update's spread (``_update_against`` with no limit)."""
    for r in ddp + again:
        _check_sharded_run(r)
    if _forwards(out, "ddp_again", again[0]["history"]) != _forwards(out, "ddp",
                                                                    ddp[0]["history"]):
        raise AssertionError(f"the data-parallel run's forwards differ from run to run: "
                             f"{_forwards(out, 'ddp_again', again[0]['history'])} vs "
                             f"{_forwards(out, 'ddp', ddp[0]['history'])}")
    return _update_against("ddp_again", "ddp", out, math.inf, -math.inf)


def _check_sharded(name, runs, ddp, world1, out, spread):
    """The ranks of one sharded run (``SHARDED_ONE_CARD`` /
    ``SHARDED_FOUR_CARDS``): each rank's counts and first update; FSDP's
    frozen suite's resident bytes at most 0.6 of a replica's, every forward
    bit-identical to the data-parallel run ``ddp`` at the same world size
    and the update's gradient within ``FSDP_SPREAD_FACTOR`` times the
    ``spread`` of two data-parallel runs (relative L2); tensor
    parallelism's UNet at most 0.7 (model 2) / 0.5 (model 4) of a
    replica's, and at data 1 held against ``world1``; then the ranks' whole
    LoRA and metrics the same, the checkpoint and LoRA file of rank 0 whole
    (the checkpoint's LoRA the run's)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import LORA_FILE, load_file

    for run in runs:
        _check_sharded_run(run)
    by_data = {}
    for r in runs:  # the model ranks of one data index read the same prompts
        by_data.setdefault(r["mesh"]["data_index"], set()).add(json.dumps(r["prompts"]))
    if any(len(p) != 1 for p in by_data.values()) or len(by_data) != runs[0]["mesh"]["data"]:
        raise AssertionError(f"{name}: prompts by data index {by_data}")
    mesh = runs[0]["mesh"]
    replica = ddp[0]
    summary = {"mesh": mesh, "history": runs[0]["history"], "lora_sha256": runs[0]["lora_sha256"],
               "per_rank": [{k: r[k] for k in ("rank", "unet_bytes", "frozen_bytes", "peak_bytes",
                                               "wall_s", "times", "tp_sliced_tensors")}
                            for r in runs],
               "replica_unet_bytes": replica["unet_bytes"],
               "replica_frozen_bytes": replica["frozen_bytes"]}
    for r in runs:
        t = r["times"]
        red, gat = t.get("tp_activation_all_reduce", {}), t.get("fsdp_weight_gather", {})
        log(f"{name} ({mesh['data']} x {mesh['model']}{', fsdp' if mesh['fsdp'] else ''}) rank "
            f"{r['rank']}: UNet {r['unet_bytes'] / 2**30:.3f} GiB (replica "
            f"{replica['unet_bytes'] / 2**30:.3f}), frozen suite {r['frozen_bytes'] / 2**30:.3f} "
            f"GiB (replica {replica['frozen_bytes'] / 2**30:.3f}); sample "
            f"{t['sample_pairs']['ms']:.1f} ms, update {t['update']['ms']:.1f} ms; activation "
            f"all-reduces {red.get('calls', 0)} calls {red.get('ms', 0.0):.1f} ms "
            f"{red.get('bytes', 0)} bytes; weight gathers {gat.get('calls', 0)} calls "
            f"{gat.get('ms', 0.0):.1f} ms {gat.get('bytes', 0)} bytes; peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; run {r['wall_s']:.1f} s")
    if mesh["fsdp"]:
        got, want = (_forwards(out, name, runs[0]["history"]),
                     _forwards(out, "ddp", replica["history"]))
        if got != want:
            raise AssertionError(f"{name}: a forward differs from data parallelism's: {got} vs "
                                 f"{want}")
        summary["against_ddp"] = _update_against(
            name, "ddp", out, FSDP_SPREAD_FACTOR * spread["grad_rel_l2"], -math.inf)
        summary["run_to_run"] = spread
        if any(r["frozen_bytes"] > 0.6 * replica["frozen_bytes"] for r in runs):
            raise AssertionError(f"{name}: frozen suite {[r['frozen_bytes'] for r in runs]} bytes "
                                 f"a rank against {replica['frozen_bytes']} a replica")
    else:
        limit = 0.7 if mesh["model"] == 2 else 0.5
        if any(r["unet_bytes"] > limit * replica["unet_bytes"] for r in runs):
            raise AssertionError(f"{name}: UNet {[r['unet_bytes'] for r in runs]} bytes a rank "
                                 f"against {replica['unet_bytes']} a replica")
        if mesh["data"] == 1:
            summary["against_world1"] = _update_against(name, "world1", out, TP_GRAD_RTOL,
                                                        TP_STEP_COSINE, leaf=True)
    if len({r["lora_sha256"] for r in runs}) != 1 or any(r["history"] != runs[0]["history"]
                                                        for r in runs):
        raise AssertionError(f"{name}: the ranks' LoRA or metrics differ: "
                             f"{[(r['lora_sha256'][:12], r['history']) for r in runs]}")
    ckpt = torch.load(out / name / "checkpoint-1" / "state.pt", weights_only=True)
    export = load_file(str(out / name / "lora-1" / LORA_FILE))
    if _digest(ckpt["lora"]) != runs[0]["lora_sha256"] or any(
            not torch.equal(export[f"unet.{k}"], v) for k, v in ckpt["lora"].items()):
        raise AssertionError(f"{name}: the checkpoint or LoRA file is not the run's whole LoRA")
    return summary


def _nccl_world_1():
    """(c): NCCL at world 1 through the launch contract: the collectives on
    CUDA tensors of the Turbo LoRA's gradients' sizes (rank 32) must return
    their inputs bit for bit; their ms."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pairwise_sample_optimization_tpu_torch import parallel
    from pairwise_sample_optimization_tpu_torch.models.unet import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.train import lora_parameters

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        parallel.maybe_initialize_distributed(device="cuda", timeout_s=DIST_TIMEOUT_S)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"a CUDA device took the {backend} backend, not NCCL")
        shapes = [p.shape for p in lora_parameters(
            SDXLUNet(UNetConfig.sdxl(lora_rank=32), device="meta")).values()]
        gen = torch.Generator(device="cuda").manual_seed(5)
        grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
        want = [g.clone() for g in grads]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        res = {"backend": backend, "tensors": len(grads), "bytes": nbytes}

        def timed(fn):
            fn()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        _, res["all_reduce_mean_ms"] = timed(lambda: parallel.all_reduce_mean_(grads))
        _, res["broadcast_ms"] = timed(lambda: parallel.broadcast_(grads))
        gathered, res["allgather_ms"] = timed(lambda: [parallel.process_allgather(g)
                                                        for g in grads])
        host = np.arange(11, dtype=np.float32)
        for name, ok in (("all_reduce_mean_", all(torch.equal(g, w) for g, w in zip(grads, want))),
                         ("broadcast_", True),
                         ("process_allgather", all(o.shape == (1, *w.shape) and torch.equal(o[0], w)
                                                   for o, w in zip(gathered, want))),
                         ("process_allgather (numpy)",
                          np.array_equal(parallel.process_allgather(host), host[None]))):
            if not ok:
                raise AssertionError(f"NCCL at world 1: {name} changed its input")
    finally:
        parallel.shutdown_distributed()
    log(f"NCCL at world 1 over {res['tensors']} LoRA-gradient tensors ({res['bytes']} bytes): "
        f"all_reduce_mean_ {res['all_reduce_mean_ms']:.2f} ms, broadcast_ "
        f"{res['broadcast_ms']:.2f} ms, process_allgather {res['allgather_ms']:.2f} ms "
        f"({res['tensors']} calls); every result bit-equal to its input")
    return res


def distributed_slice(seed, recorder, cards=1):
    """Data parallelism and the sharded meshes on the card, in four parts:

    (a) two ranks, each a process of this script on ``cuda:0``, over gloo
    (NCCL refuses two ranks on one device; with ``cards`` > 1, one rank a
    card over NCCL, ``--distributed-cards``), run the Turbo loop at full width
    through ``run_online_pso`` (``DIST_CONFIG``: 1 prompt a rank, one update
    of the global pairs, a checkpoint and LoRA export by rank 0 at step 1):
    both ranks' LoRA bit-identical after the update, their prompts
    different (``seed + rank``), the first loss log 2 within 1e-3 on both,
    each rank's launch counts (zeroed just before its run, read just after)
    the formula's at its own batch, one metrics row (rank 0's), the
    checkpoint and the LoRA file written; per rank the sample, update,
    all-reduce, gather and broadcast ms and bytes and the peak memory, and
    the most device memory the two used at once;
    (b) ``train_epoch`` of the small fp32 pipeline at world 2 over the two
    halves of a seeded sample set of ``DIST_SMALL_PAIRS`` pairs, each half
    two pair batches of one prompt, against world 1 over the whole set in
    the order of a one-process epoch (pair batch, then rank), here: every
    LoRA tensor within ``DIST_SMALL_TOL``, the update's loss, ratio_win and
    grad_norm within ``DIST_SMALL_METRICS_TOL``, the ranks' bit-equal (over
    ``cards`` ranks and shares where more);
    (c) NCCL at world 1 (``_nccl_world_1``);
    (d) before the ranks start, the epoch of ``SHARDED_CONFIG`` at world 1 on
    this card; after (a), the ranks run it data-parallel twice (the second
    run's spread from the first holds FSDP) and under each sharded mesh
    (``SHARDED_ONE_CARD``, with ``cards`` > 1 ``SHARDED_FOUR_CARDS``),
    checked by :func:`_check_sharded`.

    A rank that fails, or does not end within ``DIST_JOIN_S``, fails the
    phase. The ranks' kernel shapes join ``recorder``."""
    import torch

    from pairwise_sample_optimization_tpu_torch.checkpoints import LORA_FILE

    world, backend = (DIST_WORLD, "gloo") if cards == 1 else (cards, "nccl")
    out = RUN_DIR / "distributed"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    # (b)'s sample set and its world-1 epoch, made before the ranks start
    mods, _ = small_modules(seed)
    pipe = small_pipeline(mods, "cuda")
    g = torch.Generator().manual_seed(seed + 1)
    ids = [torch.randint(1, 998, (DIST_SMALL_PAIRS, 77), generator=g).cuda() for _ in range(3)]
    cond = pipe.encode_prompt(*ids)
    samples, _ = _small_trainer(pipe, 1).sample_pairs(
        cond, torch.Generator(device="cuda").manual_seed(seed + 2))
    cond = {k: cond[k] for k in ("embeds", "pooled", "time_ids")}
    torch.save({"samples": {k: v.cpu() for k, v in samples.items()},
                "cond": {k: v.cpu() for k, v in cond.items()}}, out / "small_samples.pt")
    # one process's epoch of the ranks' pair batches: batch j holds row j of
    # each rank's share, in rank order
    half = DIST_SMALL_PAIRS // world
    order = torch.tensor([r * half + j for j in range(half) for r in range(world)],
                         device=samples["log_probs"].device)
    small_want, small_want_metrics = _small_epoch(
        pipe, {k: v[order] for k, v in samples.items()},
        {k: v[order] for k, v in cond.items()}, 1, seed)
    del pipe, mods, samples, cond
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    prediction = sharding_prediction()
    log(f"resident bytes predicted from the parameter counts: {prediction}")
    # (a)'s world-1 run on this card, which the tensor-parallel runs at data 1
    # are held against
    world1 = _loop_run(_dist_config(seed, out, "world1", ONE_CARD_INT8 if cards == 1 else ()),
                       out, "world1", capture=True, lora_up_std=SHARDED_LORA_UP_STD)
    _check_sharded_run(world1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (a) and (b) in the rank processes
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world)}
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
                               "--distributed-worker", str(out), "--distributed-backend",
                               backend], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r if cards > 1 else 0)},
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    free0, total = torch.cuda.mem_get_info()
    most_used = total - free0
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > DIST_JOIN_S:
                raise AssertionError(f"the ranks did not end within {DIST_JOIN_S} s")
            most_used = max(most_used, total - torch.cuda.mem_get_info()[0])
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                          + (out / f"rank{r}.log").read_text()[-4000:]
                          for r, c in enumerate(codes))
        raise AssertionError(f"distributed ranks exited {codes}\n{tails}")
    res = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    turbo = [x["turbo"] for x in res]

    if len({t["lora_sha256"] for t in turbo}) != 1:
        raise AssertionError(f"the ranks' LoRA differ after the update: "
                             f"{[t['lora_sha256'] for t in turbo]}")
    if len({json.dumps(t["prompts"]) for t in turbo}) != world:
        raise AssertionError(f"ranks sampled the same prompts: {[t['prompts'] for t in turbo]}")
    for t in turbo:
        if t["launches"] != t["expected_launches"]:
            raise AssertionError(f"rank {t['rank']} launch counts {t['launches']} != expected "
                                 f"{t['expected_launches']}")
        if len(t["history"]) != 1 or t["step"] != 1:
            raise AssertionError(f"rank {t['rank']}: {len(t['history'])} updates, step {t['step']}")
        if abs(t["history"][0]["loss"] - math.log(2.0)) > 1e-3:
            raise AssertionError(f"rank {t['rank']} first loss {t['history'][0]['loss']} != log 2")
    if any(t["history"] != turbo[0]["history"] for t in turbo):
        raise AssertionError(f"the ranks logged other numbers: {[t['history'] for t in turbo]}")
    run = out / "turbo"
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    if sum("loss" in x for x in rows) != 1 or not (run / "checkpoint-1" / "state.pt").exists() \
            or not (run / "lora-1" / LORA_FILE).exists():
        raise AssertionError(f"rank 0's writes: {len(rows)} metrics rows, "
                             f"{sorted(p.name for p in run.iterdir())}")
    sharded = {name: [x["sharded"][name] for x in res] for name in res[0]["sharded"]}
    ddp = [x["ddp"] for x in res]
    spread = _run_to_run(out, [x["again"] for x in res], ddp)
    sharded_summary = {name: _check_sharded(name, runs, ddp, world1, out, spread)
                       for name, runs in sharded.items()}
    small_errs, metric_errs = [], []
    for x in res:
        small_errs.append(max(check_close(f"small LoRA {k}, world 2 vs 1", x["small_lora"][k],
                                          small_want[k], DIST_SMALL_TOL) for k in small_want))
        metric_errs.append({k: check_close(f"small update's {k}, world 2 vs 1",
                                           torch.tensor(x["small_metrics"][k], dtype=torch.float64),
                                           torch.tensor(v, dtype=torch.float64),
                                           DIST_SMALL_METRICS_TOL)
                            for k, v in small_want_metrics.items()})
    if any(not torch.equal(res[0]["small_lora"][k], x["small_lora"][k])
           for x in res for k in small_want):
        raise AssertionError("the ranks' small LoRA differ")
    for t in turbo + ddp + [world1] + [x for runs in sharded.values() for x in runs]:
        # the ranks' kernel shapes join the kernel phases'
        for table, entries in t["shapes"].items():
            mine = getattr(recorder, table)
            for key, n in entries.items():
                mine[key] = mine.get(key, 0) + n
    nccl = _nccl_world_1()

    launches = {k: sum(t["launches"][k] for t in turbo) for k in KERNELS}
    per_rank = [{"rank": t["rank"], "peak_bytes": t["peak_bytes"], "wall_s": t["wall_s"],
                 "sample_ms": t["times"]["sample_pairs"]["ms"],
                 "update_ms": t["times"]["update"]["ms"],
                 "all_reduce": t["times"]["all_reduce_mean_"],
                 "gather": t["times"]["process_allgather"],
                 "broadcast": t["times"]["broadcast_train_state_"]} for t in turbo]
    summary = {"world": world, "backend": backend, "cards": cards, "config": DIST_CONFIG,
               "policy_batch": turbo[0]["policy_batch"], "n_micro": turbo[0]["n_micro"],
               "launches": launches, "launches_by_rank": [t["launches"] for t in turbo],
               "history": turbo[0]["history"], "lora_sha256": turbo[0]["lora_sha256"],
               "prompts": [t["prompts"] for t in turbo], "per_rank": per_rank,
               "most_device_bytes_in_use": most_used, "ranks_s": ranks_s,
               "small_max_abs_diff": small_errs, "small_metrics": small_want_metrics,
               "small_metrics_abs_diff": metric_errs, "nccl_world_1": nccl,
               "world1": {k: world1[k] for k in ("launches", "history", "lora_sha256",
                                                 "unet_bytes", "frozen_bytes", "wall_s",
                                                 "peak_bytes", "times")},
               "sharded": sharded_summary, "prediction": prediction,
               "launches_by_run": {"world1": world1["launches"], **{
                   name: {k: sum(x["launches"][k] for x in runs) for k in KERNELS}
                   for name, runs in sharded.items()}}}
    for p in per_rank:
        log(f"distributed rank {p['rank']} of {world} ({backend}, "
            f"{'one card each' if cards > 1 else 'all on one card'}): sample "
            f"{p['sample_ms']:.1f} ms, update {p['update_ms']:.1f} ms (its all-reduce "
            f"{p['all_reduce']['ms']:.1f} ms over {p['all_reduce']['bytes']} bytes in "
            f"{p['all_reduce']['calls']} calls), gather {p['gather']['ms']:.1f} ms / "
            f"{p['gather']['bytes']} bytes, broadcast {p['broadcast']['ms']:.1f} ms / "
            f"{p['broadcast']['bytes']} bytes, peak {p['peak_bytes'] / 2**30:.2f} GiB, run "
            f"{p['wall_s']:.1f} s")
    log(f"distributed Turbo loop at 512^2, {world} ranks x {DIST_CONFIG['sample.batch_size']} "
        f"prompts, one update of "
        f"{turbo[0]['n_micro']} microbatches at policy batch {turbo[0]['policy_batch']} a rank: "
        f"LoRA bit-identical (sha256 {turbo[0]['lora_sha256'][:16]}), loss "
        f"{turbo[0]['history'][0]['loss']:.6f}, prompts {[t['prompts'] for t in turbo]}, "
        f"launches per rank {turbo[0]['launches']}; card 0 held at most "
        f"{most_used / 2**30:.2f} GiB; ranks' processes {ranks_s:.1f} s; small pipeline world "
        f"{world} vs 1 max|diff| {max(small_errs):.2e} (limit {DIST_SMALL_TOL}), its update "
        f"{small_want_metrics} at world 1, |diff| {metric_errs} (limit {DIST_SMALL_METRICS_TOL})")
    shutil.rmtree(out, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------- #
# the opt-in int8 and subpixel paths, and fast_init
# ---------------------------------------------------------------------- #

# the Turbo loop with the int8 reference pass: 4 prompts an epoch, one update
# of 3 microbatches at the config's policy batch (8), two epochs
INT8_TURBO = {"sample.batch_size": 4, "sample.num_batches_per_epoch": 1,
              "train.gradient_accumulation_steps": 1, "validation_steps": 0,
              "checkpointing_steps": 0, "train.int8_ref_pass": True}
INT8_TURBO_EPOCHS = 2
# the runner with fast_init: one prompt, one update of 3 microbatches
FAST_INIT = {"sample.batch_size": 1, "sample.num_batches_per_epoch": 1, "train.batch_size": 1,
             "train.gradient_accumulation_steps": 1, "validation_steps": 0,
             "checkpointing_steps": 0, "fast_init": True}
INT8_DMD_PROMPTS = 2  # the DMD2 sampling at 1024^2 with the int8 decode
INT8_DECODE_LATENTS = 2  # latents decoded bf16 / int8 / int8 smoothed, compared
INT8_SMOOTH_ALPHA = 0.5
SUBPIXEL_REPS = 2  # timed DMD2 updates of each upsample path, in turns


def _run_config(module, seed, name, overrides):
    config = module.get_config()
    config.seed, config.output_dir, config.run_name = seed, str(RUN_DIR), name
    for key, value in overrides.items():
        config.override(f"{key}={value}")
    return config


def _counted(recorder, fn):
    """``fn()`` with the launch counts zeroed just before and read just after,
    the kernel wrappers' shapes into ``recorder``: (result, counts)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    with recorder:
        out = fn()
    torch.cuda.synchronize()
    return out, dict(kernel_lib.launch_counts)


def _check_counts(name, counts, want):
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts} != expected {want}")


def _ref_logprob_gap(pipe, trainer, samples, cond, reps=3):
    """One microbatch's reference pass (the first timestep column, both
    trajectories of every prompt) in bf16 and in the int8 scope: the eps's
    relative L2 and the reference log-probs' largest gap, and each pass's
    synchronized ms (median of ``reps``, in turns)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.ops.qconv import int8_ref_pass

    b = samples["timesteps"].shape[0]
    flat = lambda x: x[:, :, 0].transpose(0, 1).reshape((2 * b,) + x.shape[3:])
    inp, x_t, x_prev = (flat(samples[k]) for k in ("input_latents", "latents", "next_latents"))
    t2 = torch.cat([samples["timesteps"][:, 0]] * 2)
    s2 = torch.cat([samples["step_indices"][:, 0]] * 2)
    cond2 = {k: torch.cat([cond[k]] * 2) for k in ("embeds", "pooled", "time_ids")}
    eps, ms = {}, {"bf16": [], "int8": []}
    with torch.no_grad():
        for _ in range(reps):
            for mode in ("bf16", "int8"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with int8_ref_pass(mode == "int8"):
                    eps[mode] = pipe.unet_eps(inp, t2, cond2, 0.0)
                torch.cuda.synchronize()
                ms[mode].append((time.perf_counter() - t0) * 1e3)
        lp = {m: trainer._recompute_logprob(e, s2, t2, x_t, x_prev) for m, e in eps.items()}
    e, e8 = eps["bf16"].double(), eps["int8"].double()
    return {"batch": 2 * b, "eps_rel_l2": float((e8 - e).norm() / e.norm()),
            "logprob_max_abs_gap": float((lp["int8"] - lp["bf16"]).abs().max()),
            "logprob_mean_abs": float(lp["bf16"].abs().mean()),
            "ms": {m: statistics.median(v) for m, v in ms.items()}}


def int8_slice(seed, recorder):
    """The opt-in int8 and subpixel paths and ``fast_init`` at full width:

    (a) the Turbo loop through ``run_online_pso`` with
    ``train.int8_ref_pass`` (``INT8_TURBO``, two epochs): launch counts the
    formula's (the reference forward's weight products and resnet and
    upsample convs through Q1 / Q2 / Q3), every loss finite; then one
    microbatch's reference pass in bf16 and in int8 on the trained adapter:
    the eps's relative L2, the reference log-probs' largest gap, the ms;
    (b) SDXL-DMD2 at 1024^2: a pair of DMD2 trajectories for each of
    ``INT8_DMD_PROMPTS`` prompts with ``kernels.int8_vae_decode`` (counts
    as the formula), then ``INT8_DECODE_LATENTS`` latents decoded in bf16,
    in int8 and in int8 with ``int8_smooth_alpha`` ``INT8_SMOOTH_ALPHA``
    (each decode counted): the pixels' relative L2 to the bf16 decode;
    (c) PickScore's image features of (b)'s images with the int8 scorer
    override against bf16: the cosine (counted);
    (d) one DMD2 update (one pair, 3 microbatches) with
    ``kernels.subpixel_upsample`` and one on the naive path from the same
    adapter (counted), ``SUBPIXEL_REPS`` times in turns: loss, grad_norm and
    the updated LoRA against each other, each path's ms;
    (e) ``run_online_pso`` with ``fast_init`` (``FAST_INIT``): every tower
    zero, the loss finite, counts as the formula.
    The knobs are set back to off at the end."""
    import torch

    from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_online_pso
    from pairwise_sample_optimization_tpu_torch.configs import sdxl_dmd_dpo, sdxl_turbo_dpo
    from pairwise_sample_optimization_tpu_torch.ops import qconv
    from pairwise_sample_optimization_tpu_torch.ops.upsample import set_use_subpixel
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                              PSOTrainState, lora_parameters,
                                                              make_optimizer)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    summary, launches = {}, {}
    t_start = time.perf_counter()

    # (a) the Turbo loop with the int8 reference pass
    config = _run_config(sdxl_turbo_dpo, seed, "online_turbo_int8", INT8_TURBO)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    (state, history, pipe), counts = _counted(recorder, lambda: run_online_pso(
        config, sampler="turbo", num_epochs=INT8_TURBO_EPOCHS, device="cuda"))
    wall = time.perf_counter() - t0
    t_cfg = config.train
    n_micro = t_cfg.gradient_accumulation_steps * t_cfg.distilled_train_steps
    sample = expected_launches(pipe, config.sample.num_steps)
    update = expected_update_launches(pipe.unet.config, n_micro, False, 2 * t_cfg.batch_size,
                                      pipe.latent_hw, sms, int8_ref=True)
    _check_counts("int8 Turbo loop", counts,
                  {k: INT8_TURBO_EPOCHS * (sample[k] + update[k]) for k in sample})
    if len(history) != INT8_TURBO_EPOCHS or not all(
            math.isfinite(m[k]) for m in history for k in ("loss", "grad_norm", "ratio_win")):
        raise AssertionError(f"int8 Turbo loop: history {history}")
    launches["turbo_int8"] = counts
    ocfg = OnlinePSOConfig(num_steps=config.sample.num_steps, train_batch_size=t_cfg.batch_size,
                           grad_accum=1)
    trainer = OnlinePSOTrainer(ocfg, pipe)
    g = torch.Generator().manual_seed(seed + 5)
    ids = [torch.randint(1, 49000, (t_cfg.batch_size, 77), generator=g).cuda() for _ in range(3)]
    cond = pipe.encode_prompt(*ids)
    with torch.no_grad():
        samples, _ = trainer.sample_pairs(cond, torch.Generator(device="cuda").manual_seed(seed))
    gap = _ref_logprob_gap(pipe, trainer, samples, cond)
    summary["turbo"] = {"config": INT8_TURBO, "epochs": INT8_TURBO_EPOCHS, "history": history,
                        "launches": counts, "wall_s": wall, "ref_pass": gap}
    log(f"int8 reference pass, Turbo loop at 512^2 ({INT8_TURBO_EPOCHS} epochs of one update x "
        f"{n_micro} microbatches at policy batch {2 * t_cfg.batch_size}): losses "
        f"{[round(m['loss'], 6) for m in history]}, launches {counts}; one reference pass at "
        f"batch {gap['batch']}: eps rel L2 {gap['eps_rel_l2']:.3e}, reference log-prob max gap "
        f"{gap['logprob_max_abs_gap']:.3e} (mean |log-prob| {gap['logprob_mean_abs']:.3e}), "
        f"{gap['ms']['int8']:.1f} ms int8 vs {gap['ms']['bf16']:.1f} ms bf16 (synchronized wall)")
    del state, pipe, trainer, samples, cond
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) DMD2 at 1024^2 with the int8 decode
    dmd = sdxl_dmd_dpo.get_config()
    pipe = SDXLPipeline.random(lora_rank=dmd.train.lora_rank, dtype=torch.bfloat16,
                               resolution=dmd.sample.resolution, seed=seed, remat="full",
                               device="cuda")
    for module in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model):
        module.requires_grad_(False)
    ucfg, vcfg = pipe.unet.config, pipe.vae.config
    steps = dmd.sample.num_steps
    trainer = OnlinePSOTrainer(OnlinePSOConfig(
        sampler="dmd", num_steps=steps, train_batch_size=1, grad_accum=1, compare="pareto",
        shared_noise=True, num_train_timesteps=dmd.train.distilled_train_steps), pipe)
    ids = [torch.randint(1, 49000, (INT8_DMD_PROMPTS, 77), generator=g).cuda() for _ in range(3)]
    cond = pipe.encode_prompt(*ids)
    layers = pipe.scorer.model.vision_config.layers
    qconv.set_use_int8_decode(True)
    try:
        with torch.no_grad():
            (samples, images), counts = _counted(recorder, lambda: trainer.sample_pairs(
                cond, torch.Generator(device="cuda").manual_seed(seed + 1)))
        _check_counts("DMD2 sampling with the int8 decode", counts, _generation_launches(
            ucfg, vcfg, steps, [layers], int8={"decode": False}))
        launches["dmd_int8_decode"] = counts
        z = torch.randn((INT8_DECODE_LATENTS, pipe.latent_hw, pipe.latent_hw, 4),
                        generator=torch.Generator(device="cuda").manual_seed(seed + 3),
                        device="cuda")
        decoded, decode_ms = {}, {}
        for mode, on, alpha in (("bf16", False, None), ("int8", True, None),
                                ("int8_smooth", True, INT8_SMOOTH_ALPHA)):
            qconv.set_use_int8_decode(on)
            qconv.set_int8_smooth_alpha(alpha)
            t0 = time.perf_counter()
            with torch.no_grad():
                decoded[mode], counts = _counted(recorder, lambda: pipe.decode(z))
            decode_ms[mode] = (time.perf_counter() - t0) * 1e3
            _check_counts(f"decode {mode}", counts, _generation_launches(
                ucfg, vcfg, 0, [], int8={"decode": None if not on else alpha is not None}))
            launches[f"decode_{mode}"] = counts
    finally:
        qconv.set_use_int8_decode(False)
        qconv.set_int8_smooth_alpha(None)
    ref = decoded["bf16"].double()
    decode_err = {m: float((decoded[m].double() - ref).norm() / ref.norm())
                  for m in ("int8", "int8_smooth")}
    if not all(math.isfinite(v) and v < 0.5 for v in decode_err.values()) or not all(
            bool(torch.isfinite(decoded[m]).all()) for m in decoded):
        raise AssertionError(f"int8 decode: relative L2 {decode_err}")
    summary["dmd_decode"] = {"prompts": INT8_DMD_PROMPTS, "latents": INT8_DECODE_LATENTS,
                             "pixel_rel_l2": decode_err, "ms": decode_ms,
                             "smooth_alpha": INT8_SMOOTH_ALPHA}
    log(f"int8 VAE decode at 1024^2 ({INT8_DECODE_LATENTS} latents): pixels' relative L2 to the "
        f"bf16 decode {decode_err['int8']:.3e}, with SmoothQuant alpha {INT8_SMOOTH_ALPHA} "
        f"{decode_err['int8_smooth']:.3e}; decode ms (synchronized wall, first call each) "
        f"{ {k: round(v, 1) for k, v in decode_ms.items()} }")

    # (c) PickScore with the int8 scorer override
    with torch.no_grad():
        f16 = pipe.scorer.image_features(images)
        qconv.set_use_int8_scorer(True)
        try:
            f8, counts = _counted(recorder, lambda: pipe.scorer.image_features(images))
        finally:
            qconv.set_use_int8_scorer(False)
    _check_counts("PickScore with the int8 scorer", counts, _generation_launches(
        ucfg, vcfg, 0, [layers], decodes=0, int8={"vision_layers": layers}))
    launches["pickscore_int8"] = counts
    cos = torch.nn.functional.cosine_similarity(f8.double(), f16.double(), dim=-1)
    if not bool(torch.isfinite(cos).all()) or float(cos.min()) < 0.9:
        raise AssertionError(f"int8 PickScore features: cosine to bf16 {cos.tolist()}")
    summary["pickscore"] = {"images": images.shape[0], "feature_cosine": cos.tolist()}
    log(f"PickScore with the int8 scorer override ({images.shape[0]} images at 1024^2): image "
        f"features' cosine to bf16 {[round(c, 6) for c in cos.tolist()]}")

    # (d) one DMD2 update with the subpixel upsample, against the naive path
    lora = lora_parameters(pipe.unet)
    lora0 = {k: v.detach().clone() for k, v in lora.items()}
    one = lambda tree: {k: tree[k][:1][None] for k in tree}
    batch = one(samples)
    cond1 = one({k: cond[k] for k in ("embeds", "pooled", "time_ids")})
    upd = expected_update_launches(ucfg, dmd.train.distilled_train_steps, False, 2,
                                   pipe.latent_hw, sms)
    runs, ms = {}, {"subpixel": [], "naive": []}
    try:
        for _ in range(SUBPIXEL_REPS):
            for mode in ("subpixel", "naive"):
                with torch.no_grad():
                    for k, v in lora.items():
                        v.copy_(lora0[k])
                set_use_subpixel(mode == "subpixel")
                st = PSOTrainState.create(lora, make_optimizer(lora))
                t0 = time.perf_counter()
                metrics, counts = _counted(recorder, lambda: trainer.update(st, batch, cond1))
                ms[mode].append((time.perf_counter() - t0) * 1e3)
                _check_counts(f"DMD2 update ({mode})", counts, upd)
                launches[f"dmd_update_{mode}"] = counts
                runs[mode] = (metrics, {k: v.detach().clone() for k, v in lora.items()})
    finally:
        set_use_subpixel(False)
    (m_sp, l_sp), (m_nv, l_nv) = runs["subpixel"], runs["naive"]
    step = lambda l: torch.cat([(l[k] - lora0[k]).double().reshape(-1) for k in sorted(l)])
    s_sp, s_nv = step(l_sp), step(l_nv)
    sub = {"metrics": {"subpixel": m_sp, "naive": m_nv},
           "step_cosine": float(s_sp @ s_nv / (s_sp.norm() * s_nv.norm())),
           "step_rel_l2": float((s_sp - s_nv).norm() / s_nv.norm()),
           "ms": {k: statistics.median(v) for k, v in ms.items()}, "ms_all": ms}
    if not all(math.isfinite(m[k]) for m in (m_sp, m_nv) for k in ("loss", "grad_norm")) or \
            abs(m_sp["loss"] - m_nv["loss"]) > 1e-2 or sub["step_cosine"] < 0.9:
        raise AssertionError(f"subpixel DMD2 update against the naive one: {sub}")
    summary["subpixel_update"] = sub
    log(f"DMD2 update at 1024^2 (one pair, {dmd.train.distilled_train_steps} microbatches): "
        f"subpixel {sub['ms']['subpixel']:.1f} ms vs naive {sub['ms']['naive']:.1f} ms "
        f"(synchronized wall, median of {SUBPIXEL_REPS} in turns); loss {m_sp['loss']:.6f} vs "
        f"{m_nv['loss']:.6f}, grad_norm {m_sp['grad_norm']:.6f} vs {m_nv['grad_norm']:.6f}, "
        f"LoRA step cosine {sub['step_cosine']:.6f}, rel L2 {sub['step_rel_l2']:.3e}")
    del pipe, trainer, samples, images, cond, cond1, batch, lora, lora0, runs, decoded, z
    torch.cuda.empty_cache()

    # (e) the runner with fast_init
    config = _run_config(sdxl_turbo_dpo, seed, "online_fast_init", FAST_INIT)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    (state, history, pipe), counts = _counted(recorder, lambda: run_online_pso(
        config, sampler="turbo", num_epochs=1, device="cuda"))
    wall = time.perf_counter() - t0
    t_cfg = config.train
    sample = expected_launches(pipe, config.sample.num_steps)
    update = expected_update_launches(pipe.unet.config, t_cfg.distilled_train_steps, False,
                                      2 * t_cfg.batch_size, pipe.latent_hw, sms)
    _check_counts("fast_init run", counts, {k: sample[k] + update[k] for k in sample})
    frozen = [p for n, p in pipe.unet.named_parameters() if ".lora." not in n]
    towers = (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model)
    if any(bool(p.detach().any()) for p in frozen + [p for m in towers for p in m.parameters()]) \
            or len(history) != 1 or not math.isfinite(history[0]["loss"]):
        raise AssertionError(f"fast_init run: a frozen weight not zero or history {history}")
    launches["fast_init"] = counts
    summary["fast_init"] = {"config": FAST_INIT, "history": history, "launches": counts,
                            "wall_s": wall}
    log(f"run_online_pso with fast_init at 512^2: every tower zero, loss "
        f"{history[0]['loss']:.6f}, launches {counts}, {wall:.1f} s")
    del state, pipe
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    summary["launches"] = launches
    summary["wall_s"] = time.perf_counter() - t_start
    return summary


def vae_decoder_conv_shapes(vcfg, latent_hw, batch):
    """(B, C, H, W, O) of each 3x3 conv the int8 decode runs at a latent of
    ``latent_hw``: the resnets' two and the upsamplers' (naive path)."""
    chans = list(reversed(vcfg.block_out_channels))
    hw, c, out = latent_hw, chans[0], []
    out += [(batch, c, hw, hw, c)] * 4  # the mid block's two resnets
    for level, ch in enumerate(chans):
        for _ in range(vcfg.layers_per_block + 1):
            out += [(batch, c, hw, hw, ch), (batch, ch, hw, hw, ch)]
            c = ch
        if level < len(chans) - 1:
            hw *= 2
            out.append((batch, c, hw, hw, c))
    return out


def int8_off_path_shapes(batch=8, latent_hw=64):
    """The int8 kernels' keys (as ``ShapeRecorder`` records them) of the
    512^2 VAE decode at the Turbo sampler's batch (8 images), which no path
    of this script runs (0 launches)."""
    from pairwise_sample_optimization_tpu_torch.models.vae import VAEConfig

    keys = set()
    bf16 = "torch.bfloat16"
    for b, c, h, w, o in vae_decoder_conv_shapes(VAEConfig.sdxl(), latent_hw, batch):
        keys |= {("absmax", (o, 9 * c), bf16, "rows", False), ("quantize_rows", (o, 9 * c), bf16),
                 ("absmax", (b, c, h, w), bf16, "samples", False),
                 ("quantize_nhwc", (b, c, h, w), bf16, False),
                 ("conv3x3", (b, h, w, c), (o, 3, 3, c), bf16, True)}
    return keys


INT8_TIMING = {"reps": 3, "inner": 5}
INT8_PLAIN_TIMING = {"reps": 1, "inner": 1, "warm": 1}  # the plain conv: float64 integers
QUANTIZE_OPS, ABSMAX_OPS, DEQUANT_OPS = 5, 2, 3  # fp32 operations per element


def int8_phase(entries, seed):
    """Each int8 kernel (Q1: ``int8_absmax``, ``int8_quantize``; Q2:
    ``int8_conv3x3``; Q3: ``int8_dequant``) against its plain version at
    every shape a path gave it (``entries``: the recorder's keys and their
    launches) and at ``int8_off_path_shapes`` (0 launches), on inputs drawn
    here: absmaxes, integers, scales and outputs must be equal (the plain
    versions compute the same fp32 operations: no tolerance). Per shape ms,
    bound, plain ms and a library call where one computes the same function
    (the absmax: ``torch.linalg.vector_norm`` of order inf; the conv: bf16
    ``F.conv2d`` of the same shape, the yardstick the int8 conv is for);
    per ``torch._int_mm`` shape of the int8 matmul sites the whole int8
    matmul (Q1 twice, the product, Q3) beside the bf16 ``torch.matmul``."""
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = dict(entries)
    for key in int8_off_path_shapes():
        cases.setdefault(key, 0)
    rows = {k: [] for k in INT8_KERNELS}
    sites = []
    dt = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}

    def equal(name, got, want):
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                diff = (a.double() - b.double()).abs().max().item() if a.shape == b.shape else None
                raise AssertionError(f"{name}: kernel and plain version differ (max|diff| {diff})")
        return 0.0

    def rand(shape, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * 1.7 + 0.1).to(dtype)

    for key, launches in sorted(cases.items(), key=str):
        kind = key[0]
        if kind == "int_mm":
            m, k, n = key[1:]
            x, w = rand((m, k), torch.bfloat16), rand((n, k), torch.bfloat16) * 0.05
            sites.append({"m": m, "k": k, "n": n, "launches": launches,
                          "int8_ms": timed_ms(lambda: tq.int8_matmul(x, w), **INT8_TIMING),
                          "bf16_matmul_ms": timed_ms(lambda: x @ w.t(), **INT8_TIMING),
                          "bound_int8_ms": bound(m * k * 2 + n * k * 2 + m * n * 2,
                                                 2 * m * k * n, "int8")[0]})
            continue
        if kind in ("absmax", "quantize_rows", "quantize_nhwc"):
            shape, dtype = key[1], dt[key[2]]
            x = rand(shape, dtype)
            el, n = x.element_size(), x.numel()
            div = None
            if (kind == "absmax" and key[4]) or (kind == "quantize_nhwc" and key[3]):
                div = torch.rand(shape[1], generator=gen, device="cuda") + 0.5
            if kind == "absmax":
                mode = key[3]
                fn, plain = (lambda: tq.absmax(x, mode, div)), (lambda: tq.absmax_plain(x, mode, div))
                rows_n = {"rows": shape[0], "samples": shape[0], "channels": shape[1]}[mode]
                dims = {"rows": -1, "samples": (1, 2, 3), "channels": (0, 2, 3)}[mode]
                library = (None if div is not None else
                           lambda: torch.linalg.vector_norm(x, float("inf"), dim=dims))
                b, by = bound(n * el + 4 * rows_n + (4 * shape[1] if div is not None else 0),
                              ABSMAX_OPS * n, "fp32")
                table, desc = "int8_absmax", {"x": list(shape), "mode": mode,
                                              "divisor": div is not None}
            else:
                rows_n = shape[0]
                am = rand((rows_n,), torch.float32).abs() * 3
                if kind == "quantize_rows":
                    fn, plain = (lambda: tq.quantize_rows(x, am)), (
                        lambda: tq.quantize_rows_plain(x, am))
                else:
                    fn, plain = (lambda: tq.quantize_nhwc(x, am, div)), (
                        lambda: tq.quantize_nhwc_plain(x, am, div))
                library = None
                b, by = bound(n * el + n + 8 * rows_n, QUANTIZE_OPS * n, "fp32")
                table, desc = "int8_quantize", {"x": list(shape), "layout": kind,
                                                "divisor": div is not None}
        elif kind == "conv3x3":
            (bsz, h, w_, c), (o, _, _, _), dtype, has_bias = key[1], key[2], dt[key[3]], key[4]
            xq = torch.randint(-127, 128, (bsz, h, w_, c), generator=gen, device="cuda",
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (o, 3, 3, c), generator=gen, device="cuda",
                               dtype=torch.int8)
            sx = torch.rand(bsz, generator=gen, device="cuda") * 0.02 + 1e-3
            sw = torch.rand(o, generator=gen, device="cuda") * 1e-3 + 1e-5
            bias = torch.randn(o, generator=gen, device="cuda") if has_bias else None
            fn = lambda: tq.conv3x3(xq, wq, sx, sw, bias, dtype)
            plain = lambda: tq.conv3x3_plain(xq, wq, sx, sw, bias, dtype)
            xl = rand((bsz, c, h, w_), dtype)
            wl = rand((o, c, 3, 3), dtype) * 0.02
            library = lambda: F.conv2d(xl, wl, padding=1)
            out_el = torch.empty((), dtype=dtype).element_size()
            b, by = bound(xq.numel() + wq.numel() + bsz * o * h * w_ * out_el + 4 * (bsz + 2 * o),
                          2 * bsz * h * w_ * o * 9 * c, "int8")
            table, desc = "int8_conv3x3", {"x": [bsz, h, w_, c], "w": [o, 3, 3, c],
                                           "out": key[3], "bias": has_bias}
        else:  # dequant
            (m, n_), dtype, has_bias = key[1], dt[key[2]], key[3]
            acc = torch.randint(-2**24, 2**24, (m, n_), generator=gen, device="cuda",
                                dtype=torch.int32)
            sx = torch.rand(m, generator=gen, device="cuda") * 0.02 + 1e-3
            sw = torch.rand(n_, generator=gen, device="cuda") * 1e-3 + 1e-5
            bias = torch.randn(n_, generator=gen, device="cuda") if has_bias else None
            fn = lambda: tq.dequant(acc, sx, sw, bias, dtype)
            plain = lambda: tq.dequant_plain(acc, sx, sw, bias, dtype)
            library = None
            out_el = torch.empty((), dtype=dtype).element_size()
            b, by = bound(m * n_ * (4 + out_el) + 4 * (m + 2 * n_), DEQUANT_OPS * m * n_, "fp32")
            table, desc = "int8_dequant", {"acc": [m, n_], "out": key[2], "bias": has_bias}
        err = equal(f"{table} {desc}", fn(), plain())
        row = {"shape": desc, "launches": launches, "max_abs_err": err,
               "ms": timed_ms(fn, **INT8_TIMING),
               "plain_ms": timed_ms(plain, **INT8_PLAIN_TIMING),
               "library_ms": timed_ms(library, **INT8_TIMING) if library else None,
               "bound_ms": b, "bound_by": by}
        rows[table].append(row)
        log(f"{table} {desc}: equal to the plain version; {row['ms']:.4f} ms (bound {b:.4f}, "
            f"{by}), plain {row['plain_ms']:.4f}"
            + (f", library {row['library_ms']:.4f}" if library else "") + f"; {launches} launches")
        torch.cuda.empty_cache()
    for s_ in sites:
        log(f"int8 matmul site (M, K, N) = ({s_['m']}, {s_['k']}, {s_['n']}): whole int8 matmul "
            f"{s_['int8_ms']:.4f} ms vs bf16 torch.matmul {s_['bf16_matmul_ms']:.4f} ms (int8 "
            f"operation bound {s_['bound_int8_ms']:.4f}); {s_['launches']} launches")
    return rows, sites


# ---------------------------------------------------------------------- #
# the SD1.x family: the fixed-head SD1.5 UNet, CFG-DDIM with log-probs
# ---------------------------------------------------------------------- #

SD15_PROMPTS = 2  # CFG: one UNet call of batch 4 a step
SD15_GUIDANCE = 5.0
# diffusers' "leading" spacing of 20 steps over 1000 with offset 1: 951, 901, ..., 1
SD15_TIMESTEPS = tuple(range(951, 0, -50))
SD15_GRAD_STEPS = (0, 10)  # the stored transitions whose mean log-prob is differentiated
SD15_LORA_UP_STD = 1e-3  # LoRA up drawn non-zero: every LoRA tensor gets a gradient
# a LoRA gradient through the kernels against the plain attention's: its
# relative L2 distance at most this many times the largest one between two
# plain runs whose sums differ in order (as REMAT_TOL_FACTOR)
SD15_GRAD_SPREAD_FACTOR = 4
# the small fp32 check: a 4-level SD1.x UNet whose head dims are the kernels' own
# (one fixed head over 40, 80, 160 channels), 3 CFG-DDIM steps at 32x32 latents
SD15_SMALL_TIMESTEPS = (667, 334, 1)
# (entry of the kernels line, its launch counter, head dim): the attention
# kernels' SD1.x instances, listed apart from the counter's other head dims
HEAD_DIM_ENTRIES = (("flash_attn_fwd_d40", "flash_attn_fwd", 40),
                    ("flash_attn_fwd_d160", "flash_attn_fwd", 160),
                    ("flash_attn_bwd_d40", "flash_attn_bwd", 40),
                    ("flash_attn_bwd_d80", "flash_attn_bwd", 80),
                    ("flash_attn_bwd_d160", "flash_attn_bwd", 160))
# the SD1.x shapes off the main path (0 launches; forward and backward): the
# ragged lengths of the zero-filled and masked tile edges at the new head dims
RAGGED_SD15 = (((2, 1000, 3, 40), 77), ((1, 200, 5, 160), 1000), ((1, 1, 2, 40), 1))


def attention_calls_by_head_dim(ucfg):
    """{head dim: attention calls} of one UNet forward (self and cross)."""
    chs, lpb, depths = ucfg.block_out_channels, ucfg.layers_per_block, ucfg.transformer_layers
    calls = {}
    for level, ch in enumerate(chs):
        blocks = depths[level] * (2 * lpb + 1) + (ucfg.mid_depth if level == len(chs) - 1 else 0)
        d = ucfg.heads_for(ch)[1]
        calls[d] = calls.get(d, 0) + 2 * blocks
    return {d: n for d, n in calls.items() if n}


def expected_sd15_launches(ucfg, unet_calls, backward_calls=0, batch=2 * SD15_PROMPTS,
                           latent_hw=64):
    """(launch counts, launches by (kernel, head dim)) of ``unet_calls`` UNet
    forwards at ``batch`` and ``latent_hw``, ``backward_calls`` of them
    differentiated (every attention's q, k and v need a gradient under
    LoRA): per attention call in a backward the pre kernel, the bf16
    one-kernel backward and, where ``bwd_needs_post``, the post kernel."""
    attn, gn = _unet_counts(ucfg)
    post = sum(bwd_needs_post(q, skv) for q, skv in attention_shapes(ucfg, batch, latent_hw))
    counts = {k: 0 for k in KERNELS}
    counts.update({"flash_attn_fwd": unet_calls * attn, "flash_attn_bwd_pre": backward_calls * attn,
                   "flash_attn_bwd": backward_calls * attn,
                   "flash_attn_bwd_post": backward_calls * post, "gn_stats": unet_calls * gn,
                   "gn_silu_norm": unet_calls * gn})
    by_dim = {}
    for d, n in attention_calls_by_head_dim(ucfg).items():
        by_dim[("flash_attn_fwd", d)] = unet_calls * n
        if backward_calls:
            by_dim[("flash_attn_bwd", d)] = backward_calls * n
    return counts, by_dim


def _counted_by_head_dim(recorder, fn):
    """``_counted`` and the launches by (kernel, head dim) of the same run."""
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    out, counts = _counted(recorder, fn)
    return out, counts, dict(kernel_lib.head_dim_launches)


def _path_launches(counts, by_dim):
    """A run's counts for the kernels line: each ``HEAD_DIM_ENTRIES``
    instance's launches as an entry of its own, taken out of its counter's."""
    out = dict(counts)
    for entry, name, d in HEAD_DIM_ENTRIES:
        n = by_dim.get((name, d), 0)
        out[entry] = n
        out[name] -= n
    return out


def _sd15_cfg_eps(unet, ctx, lora_scale=1.0):
    """The CFG epsilon of ``SD15_GUIDANCE``: one UNet call at twice the batch
    (unconditional contexts first), as the JAX package's test mixes it."""
    import torch

    def eps(x, t):
        u, c = unet(torch.cat([x, x]), torch.cat([t, t]), ctx, lora_scale=lora_scale).chunk(2)
        return u + SD15_GUIDANCE * (c - u)
    return eps


def _device_busy_ms(fn):
    """Device busy ms of ``fn()`` from a ``torch.profiler`` trace (kernel
    events), or None where the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sum(busy) / 1e3 if busy else None


def sd15_slice(seed, recorder):
    """The SD1.x path at full SD1.5 width (``UNetConfig.sd15``: 860 M
    parameters, 8 fixed heads: attention at head dims 40, 80 and 160),
    random bf16 weights from ``seed`` (LoRA rank 4, up drawn non-zero),
    512^2: ``SD15_PROMPTS`` prompts with CFG (guidance ``SD15_GUIDANCE``, one
    UNet call of batch 4 a step, random 77 x 768 contexts), 20 DDIM steps
    (eta 1) on ``SD15_TIMESTEPS`` over ``make_alphas_cumprod()`` through
    ``sample_ddim_cfg_trajectories``; then the gradient phase on two of its
    stored transitions and the small fp32 check. Returns the summary and
    each run's counts for the kernels line."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.ops import ddim_step_with_logprob
    from pairwise_sample_optimization_tpu_torch.ops.schedules import make_alphas_cumprod
    from pairwise_sample_optimization_tpu_torch.train.sampling import sample_ddim_cfg_trajectories

    t0 = time.perf_counter()
    ucfg = UNetConfig.sd15(lora_rank=4)
    unet = SDXLUNet(ucfg, device="cuda")
    with torch.no_grad():
        init_random_(unet, torch.Generator(device="cuda").manual_seed(seed),
                     lora_b_std=SD15_LORA_UP_STD)
    unet.eval()
    n_params = sum(p.numel() for n, p in unet.named_parameters() if ".lora." not in n)
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    b, steps, ac = SD15_PROMPTS, len(SD15_TIMESTEPS), make_alphas_cumprod()
    ctx = torch.randn((2 * b, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    init = torch.randn((b, 4, 64, 64), generator=gen, device="cuda")
    noise = torch.randn((steps, b, 4, 64, 64), generator=gen, device="cuda")
    eps_fn, seen = _sd15_cfg_eps(unet, ctx), []

    def rollout(record=False):
        def eps(x, t):
            e = eps_fn(x, t)
            if record:
                seen.append(e)
            return e
        with torch.no_grad():
            return sample_ddim_cfg_trajectories(eps, ac, SD15_TIMESTEPS, init, noise, eta=1.0)

    rollout()  # warm-up: first-call setup of cuDNN, cuBLAS and the kernels
    torch.cuda.synchronize()
    t = time.perf_counter()
    traj, counts, by_dim = _counted_by_head_dim(recorder, lambda: rollout(record=True))
    wall_ms = (time.perf_counter() - t) * 1e3
    want, want_dim = expected_sd15_launches(ucfg, steps)
    _check_counts("sd15 rollout", counts, want)
    if by_dim != want_dim:
        raise AssertionError(f"sd15 rollout: launches by head dim {by_dim} != {want_dim}")
    busy_ms = _device_busy_ms(rollout)
    for name, x in (("latents", traj.latents), ("log_probs", traj.log_probs)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"sd15 rollout: non-finite {name}")
    if traj.latents.shape != (steps + 1, b, 4, 64, 64) or traj.log_probs.shape != (steps, b):
        raise AssertionError(f"sd15 rollout shapes {traj.latents.shape} {traj.log_probs.shape}")
    # each recorded log-prob against the step recomputed from the stored
    # transition (the eps it was taken with, prev_sample given)
    prev = list(SD15_TIMESTEPS[1:]) + [-1]
    recomputed = torch.stack([ddim_step_with_logprob(
        ac, seen[j], torch.full((b,), SD15_TIMESTEPS[j], device="cuda"),
        torch.full((b,), prev[j], device="cuda"), traj.latents[j],
        prev_sample=traj.latents[j + 1])[1] for j in range(steps)])
    lp_err = check_close("sd15 recomputed log-probs", recomputed, traj.log_probs,
                         TOL["sd15_logprob"])
    summary = {"params": n_params, "prompts": b, "unet_batch": 2 * b, "steps": steps,
               "resolution": 512, "timesteps": list(SD15_TIMESTEPS), "guidance": SD15_GUIDANCE,
               "launches": counts, "launches_by_head_dim": {f"{k[0]} d{k[1]}": v
                                                            for k, v in by_dim.items()},
               "rollout_ms": wall_ms, "device_busy_ms": busy_ms,
               "busy_share": None if busy_ms is None else busy_ms / wall_ms,
               "log_probs_mean": traj.log_probs.mean(1).tolist(),
               "recomputed_log_prob_max_abs_diff": lp_err,
               "build_s": t - t0}
    log(f"sd15 rollout (UNet {n_params / 1e6:.1f} M params, {b} prompts x CFG = batch {2 * b}, "
        f"{steps} DDIM steps at 512^2): {wall_ms:.1f} ms ({wall_ms / steps:.1f} ms a step), "
        f"device busy {busy_ms if busy_ms is None else round(busy_ms, 1)} ms (share "
        f"{summary['busy_share'] if busy_ms is None else round(summary['busy_share'], 3)}); "
        f"launches {counts}, by head dim {summary['launches_by_head_dim']}; recomputed "
        f"log-probs max|diff| {lp_err:.2e}")
    del seen
    grad = sd15_grad(unet, ctx, traj, recorder)
    del unet, traj
    torch.cuda.empty_cache()
    small = sd15_small_check(seed)
    paths = {"sd15_rollout": _path_launches(counts, by_dim),
             "sd15_grad": _path_launches(grad.pop("counts"), grad.pop("counts_by_dim"))}
    return {**summary, "grad": grad, "small_fp32": small}, paths


def lora_grad_tolerance(want):
    """(atol, rtol) of a LoRA gradient of the bf16 UNet against the same
    gradient through the plain attention: ``grad_tolerance``'s bf16 rule
    (rtol 1e-2, atol 5% of the plain gradient's rms). The LoRA tensors are
    fp32, but every product upstream of them is bf16, whose roundings
    (P and dS in the kernels, O in both) follow the gradient's scale."""
    import torch

    return bwd_tolerance(want.to(torch.bfloat16))


def sd15_grad(unet, ctx, traj, recorder):
    """The gradient of the mean log-prob of the rollout's transitions
    ``SD15_GRAD_STEPS``, recomputed through the CFG eps with ``prev_sample``
    given, with respect to the LoRA tensors: through the kernels (launches
    counted: 2 UNet forwards and backwards), then twice with every attention
    on its plain version on the card (autograd of ``flash_attention_plain``),
    the second time with the keys and values in reverse order (the same
    function, its fp32 sums taken in another order: the spread that bf16
    roundings downstream of one changed ulp give). Every LoRA gradient
    finite and non-zero, no frozen weight with one; each LoRA tensor's
    relative L2 distance from the plain run's gradient at most
    ``SD15_GRAD_SPREAD_FACTOR`` times the largest spread of the two plain
    runs (the remat phase's rule), and the median distance at most that
    factor times the median spread. The share of ``lora_grad_tolerance``
    each uses is reported: elementwise, the two plain runs differ by many
    times that bf16 rule (19.7x at full SD1.5 width on an H100), so it holds no
    whole-UNet gradient."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models import layers
    from pairwise_sample_optimization_tpu_torch.ops import ddim_step_with_logprob
    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
    from pairwise_sample_optimization_tpu_torch.ops.schedules import make_alphas_cumprod

    lora = {n: p for n, p in unet.named_parameters() if ".lora." in n}
    for n, p in unet.named_parameters():
        p.requires_grad_(n in lora)
    ac, b, eps_fn = make_alphas_cumprod(), traj.latents.shape[1], _sd15_cfg_eps(unet, ctx)
    prev = list(SD15_TIMESTEPS[1:]) + [-1]

    def grads():
        for p in lora.values():
            p.grad = None
        for j in SD15_GRAD_STEPS:
            t = torch.full((b,), SD15_TIMESTEPS[j], device="cuda")
            _, lp = ddim_step_with_logprob(ac, eps_fn(traj.latents[j], t), t,
                                           torch.full((b,), prev[j], device="cuda"),
                                           traj.latents[j], prev_sample=traj.latents[j + 1])
            (lp.mean() / len(SD15_GRAD_STEPS)).backward()
        return {n: p.grad.detach().clone() for n, p in lora.items()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, counts, by_dim = _counted_by_head_dim(recorder, grads)
    kernel_ms = (time.perf_counter() - t0) * 1e3
    want_counts, want_dim = expected_sd15_launches(unet.config, len(SD15_GRAD_STEPS),
                                                   len(SD15_GRAD_STEPS))
    _check_counts("sd15 gradient", counts, want_counts)
    if by_dim != want_dim:
        raise AssertionError(f"sd15 gradient: launches by head dim {by_dim} != {want_dim}")
    frozen = [n for n, p in unet.named_parameters() if n not in lora and p.grad is not None]
    if frozen:
        raise AssertionError(f"sd15 gradient: frozen weights with a gradient: {frozen[:5]}")
    for n, g in got.items():
        if not torch.isfinite(g).all() or not g.abs().max() > 0:
            raise AssertionError(f"sd15 gradient {n}: not finite and non-zero")

    def plain(order):
        def attention(q, k, v, *, causal=False):
            assert not causal
            return tfa.flash_attention_plain(q, k[:, order(k.shape[1])], v[:, order(k.shape[1])])[0]
        return attention

    kernel_attention = layers.dot_product_attention
    plain_ms = []
    try:
        for order in (lambda n: slice(None), lambda n: torch.arange(n - 1, -1, -1, device="cuda")):
            layers.dot_product_attention = plain(order)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_ms.append((grads(), (time.perf_counter() - t0) * 1e3))
    finally:
        layers.dot_product_attention = kernel_attention
    (want, ms_plain), (again, _) = plain_ms
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    spread = {n: rel(again[n], want[n]) for n in got}
    dist = {n: rel(got[n], want[n]) for n in got}
    used = {n: tolerance_used(got[n], want[n], lora_grad_tolerance(want[n])) for n in got}
    used_plain = {n: tolerance_used(again[n], want[n], lora_grad_tolerance(want[n])) for n in got}
    limit = SD15_GRAD_SPREAD_FACTOR * max(spread.values())
    for p in unet.parameters():
        p.grad = None
    worst = max(dist, key=dist.get)
    log(f"sd15 gradient of the mean log-prob of transitions {SD15_GRAD_STEPS} over "
        f"{len(lora)} LoRA tensors (rank 4): {kernel_ms:.1f} ms through the kernels, "
        f"{ms_plain:.1f} ms with the plain attention; ||g - g_plain|| / ||g_plain|| max "
        f"{dist[worst]:.3e} ({worst}), median {statistics.median(dist.values()):.3e}; the plain "
        f"runs' spread max {max(spread.values()):.3e}, median "
        f"{statistics.median(spread.values()):.3e} (limit {limit:.3e}); share of the bf16 "
        f"grad_tolerance used: kernels max {max(used.values()):.3f} (median "
        f"{statistics.median(used.values()):.3f}), the second plain run max "
        f"{max(used_plain.values()):.3f} (median {statistics.median(used_plain.values()):.3f}); "
        f"launches {counts}")
    for n in sorted(dist, key=dist.get, reverse=True)[:8]:
        log(f"  {n}: distance {dist[n]:.3e}, spread {spread[n]:.3e}, tolerance share "
            f"{used[n]:.3f} (plain runs {used_plain[n]:.3f})")
    if dist[worst] > limit:
        raise AssertionError(f"sd15 LoRA gradient {worst}: ||g - g_plain|| / ||g_plain|| "
                             f"{dist[worst]:.3e} > {SD15_GRAD_SPREAD_FACTOR} x the plain runs' "
                             f"largest spread {max(spread.values()):.3e}")
    median_limit = SD15_GRAD_SPREAD_FACTOR * statistics.median(spread.values())
    if statistics.median(dist.values()) > median_limit:
        raise AssertionError(f"sd15 LoRA gradients: median ||g - g_plain|| / ||g_plain|| "
                             f"{statistics.median(dist.values()):.3e} > {median_limit:.3e}")
    return {"steps": list(SD15_GRAD_STEPS), "lora_tensors": len(lora), "kernel_ms": kernel_ms,
            "plain_attention_ms": ms_plain, "relative_l2_max": dist[worst],
            "relative_l2_worst": worst, "relative_l2_median": statistics.median(dist.values()),
            "plain_spread_max": max(spread.values()),
            "plain_spread_median": statistics.median(spread.values()), "limit": limit,
            "grad_tolerance_used_max": max(used.values()),
            "grad_tolerance_used_median": statistics.median(used.values()),
            "plain_grad_tolerance_used_max": max(used_plain.values()), "counts": counts,
            "counts_by_dim": by_dim,
            "launches_by_head_dim": {f"{k[0]} d{k[1]}": v for k, v in by_dim.items()}}


def sd15_small_check(seed):
    """A small fp32 SD1.x UNet (4 levels of 40, 80, 160, 160 channels, one
    fixed head: head dims 40, 80 and 160, the kernels' own) on the card
    through the kernels and on the CPU through the plain versions, same
    weights and noise: a 3-step CFG-DDIM rollout's latents and log-probs
    equal to 2e-3."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.models.layers import init_random_
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.ops.schedules import make_alphas_cumprod
    from pairwise_sample_optimization_tpu_torch.train.sampling import sample_ddim_cfg_trajectories

    ucfg = UNetConfig(block_out_channels=(40, 80, 160, 160), transformer_layers=(1, 1, 1, 0),
                      mid_transformer_layers=1, layers_per_block=1, fixed_num_heads=1,
                      cross_attention_dim=32, use_text_time=False, norm_groups=8, lora_rank=4,
                      dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed + 16)
    cpu = SDXLUNet(ucfg, device="cpu")
    with torch.no_grad():
        init_random_(cpu, gen, lora_b_std=0.05)
    gpu = copy.deepcopy(cpu).to("cuda")
    ctx = torch.randn((2 * SD15_PROMPTS, 77, 32), generator=gen)
    init = torch.randn((SD15_PROMPTS, 4, 32, 32), generator=gen)
    noise = torch.randn((len(SD15_SMALL_TIMESTEPS), SD15_PROMPTS, 4, 32, 32), generator=gen)
    outs, ac = [], make_alphas_cumprod()
    kernel_lib.reset_launch_counts()
    for unet, dev in ((cpu, "cpu"), (gpu, "cuda")):
        with torch.no_grad():
            outs.append(sample_ddim_cfg_trajectories(
                _sd15_cfg_eps(unet, ctx.to(dev)), ac, SD15_SMALL_TIMESTEPS, init.to(dev),
                noise.to(dev)))
    torch.cuda.synchronize()
    by_dim = dict(kernel_lib.head_dim_launches)
    want_dim = {("flash_attn_fwd", d): n * len(SD15_SMALL_TIMESTEPS)
                for d, n in attention_calls_by_head_dim(ucfg).items()}
    if by_dim != want_dim:
        raise AssertionError(f"sd15 small check: launches by head dim {by_dim} != {want_dim}")
    want, got = outs
    tol = TOL["attention"]["fp32"]
    errs = {"latents": check_close("sd15 small latents", got.latents.cpu(), want.latents, tol),
            "log_probs": check_close("sd15 small log_probs", got.log_probs.cpu(), want.log_probs,
                                     tol)}
    log(f"sd15 small check (fp32, head dims {sorted(attention_calls_by_head_dim(ucfg))}, "
        f"kernels on the card vs plain on the CPU, {len(SD15_SMALL_TIMESTEPS)} CFG-DDIM steps): "
        "max|diff| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; K1 launches by head dim {by_dim}")
    return {"max_abs_diff": errs, "launches_by_head_dim": {f"{k[0]} d{k[1]}": v
                                                           for k, v in by_dim.items()}}


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


def _sd15_fp32_cases(shapes):
    """fp32 cases at the SD1.x head dims (0 launches): each head dim's
    cross-attention shape the SD1.x runs recorded, in fp32."""
    import torch

    seen = {}
    for (q, k, dt), _ in shapes.items():
        if q[-1] in (40, 80, 160) and k[1] == 77 and dt == torch.bfloat16:
            seen.setdefault(q[-1], (q, k, torch.float32, 0))
    return [seen[d] for d in sorted(seen)]


def attention_phase(shapes, seed):
    import torch
    import torch.nn.functional as F

    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(q, k, dt, n) for (q, k, dt), n in shapes.items()]
    q0, k0, _, _ = max(cases, key=lambda c: c[3])
    cases.append((q0, k0, torch.float32, 0))  # the fp32 case, off the main path
    cases += [(qs, (qs[0], skv, *qs[2:]), torch.bfloat16, 0)
              for qs, skv in RAGGED + RAGGED_FWD + TP_LOCAL + RAGGED_SD15]
    cases += _sd15_fp32_cases(shapes)
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


# the backward twice at these shapes, bf16: the DMD2 loop's longest at d = 64
# and SD1.x's at d = 40 (dQ summed over 32 blocks of keys either way)
RUN_TO_RUN = (((2, 4096, 10, 64), 4096), ((4, 4096, 8, 40), 4096))


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
    each kernel's; launch-weighted means of the whole backward per head
    dim. Then the whole backward twice at each ``RUN_TO_RUN`` shape: the
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
    cases += [(qs, (qs[0], skv, *qs[2:]), torch.bfloat16, 0)
              for qs, skv in RAGGED + TP_LOCAL + RAGGED_SD15]
    cases += _sd15_fp32_cases(shapes)
    rows = {name: [] for name in ("flash_attn_bwd_pre", "flash_attn_bwd", "flash_attn_bwd_post")}
    whole_rows, by_dim = [], {}
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
            q_chunk, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms, d)
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
        # fewer timed calls of the fp32 two-kernel path (FMAs on the CUDA cores) at the long shapes
        slow = (3, 2) if big and dt == torch.float32 else ()
        t = {
            "sdpa": timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                         retain_graph=True)),
            "plain": timed_ms(lambda: tfa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                              *((3, 2) if big else (3,))),
            "whole": timed_ms(lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do), *slow),
            "pre": timed_ms(lambda: tfa.flash_attention_bwd_pre(o, do, acc)),
            "pre_plain": timed_ms(lambda: tfa.attention_di(o, do)),
            "main": timed_ms(lambda: tfa.flash_attention_bwd_main(q, k, v, do, lse, di, acc,
                                                                  q_chunk, scale), *slow),
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

    bf16_rows = [{**r, "library_ms": r["sdpa_bwd_ms"]} for r in whole_rows if r["dtype"] == "bf16"]
    for d in sorted({r["shape"]["q"][-1] for r in bf16_rows if r["launches"]}):
        at_d = [r for r in bf16_rows if r["shape"]["q"][-1] == d]
        m = _means(at_d)
        by_dim[d] = {"launches": sum(r["launches"] for r in at_d), **m}
        log(f"whole backward at d = {d}: {by_dim[d]['launches']} launches, {m['ms']:.4f} ms vs "
            f"bound {m['bound_ms']:.4f} ({m['bound_by']}), plain {m['plain_ms']:.4f}, SDPA bwd "
            f"{m['library_ms']:.4f} (launch-weighted means)")
    run_to_run = []
    for qs, skv in RUN_TO_RUN:
        ks = (qs[0], skv, *qs[2:])
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda", dtype=torch.bfloat16)
                       for s in (qs, ks, ks, qs))
        o, lse = tfa.flash_attention_fwd(q, k, v)
        first = tfa.flash_attention_bwd(q, k, v, o, lse, do)
        second = tfa.flash_attention_bwd(q, k, v, o, lse, do)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        diff = {n: check_close(f"run to run {n} {qs} kv {skv}", b_, a_, bwd_tolerance(w))
                for n, a_, b_, w in zip(("dq", "dk", "dv"), first, second, want)}
        used = max(tolerance_used(b_, a_, bwd_tolerance(w))
                   for a_, b_, w in zip(first, second, want))
        run_to_run.append({"q": list(qs), "kv": skv, "max_abs_diff": diff,
                           "tolerance_used": used})
        log(f"backward run to run at {qs} kv {skv} bf16: max|diff| between two runs "
            + ", ".join(f"{n} {e:.2e}" for n, e in diff.items())
            + f", share of bwd_tolerance {used:.3f}")
        del q, k, v, do, o, lse, first, second, want
    return rows, whole_rows, by_dim, run_to_run


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


def _means(rows):
    """Launch-weighted means per launch of the rows' times and bounds, and
    which of bytes and operations bounds most of that bound time."""
    on_path = [r for r in rows if r["launches"]]
    total = sum(r["launches"] for r in on_path)
    mean = lambda key: (sum(r[key] * r["launches"] for r in on_path) / total
                        if all(r[key] is not None for r in on_path) else None)
    bytes_share = sum(r["launches"] * r["bound_ms"] for r in on_path if r["bound_by"] == "bytes")
    return {"ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": "bytes" if bytes_share * 2 >= sum(r["launches"] * r["bound_ms"]
                                                          for r in on_path) else "operations",
            "library_ms": mean("library_ms")}


def summarize(name, rows, launches):
    """One kernel's line entry: times and bound as launch-weighted means per
    launch over the main path's shape mix (the attention forward's also by
    head dim); max_abs_err over every case."""
    counter = next((c for e, c, _ in HEAD_DIM_ENTRIES if e == name), name)
    src, replaces = KERNELS[counter]
    out = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
           **_means(rows), "shapes": rows}
    if name == "flash_attn_fwd":
        dims = sorted({r["shape"]["q"][-1] for r in rows if r["launches"]})
        out["by_head_dim"] = {d: {"launches": sum(r["launches"] for r in rows
                                                  if r["shape"]["q"][-1] == d),
                                  **_means([r for r in rows if r["shape"]["q"][-1] == d])}
                              for d in dims}
        for d, m in out["by_head_dim"].items():
            log(f"flash_attn_fwd at d = {d}: {m['launches']} launches, {m['ms']:.4f} ms vs "
                f"bound {m['bound_ms']:.4f} ({m['bound_by']}), plain {m['plain_ms']:.4f}, "
                f"sdpa {m['library_ms']:.4f} (launch-weighted means)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed-cards", type=int, default=1, metavar="N",
                    help="run the distributed phase alone, one rank on each of N > 1 cards "
                         "over NCCL (default: every phase on one card)")
    ap.add_argument("--distributed-worker", default="", metavar="DIR",
                    help="run one rank of the distributed phase, writing into DIR")
    ap.add_argument("--distributed-backend", default="gloo", choices=("gloo", "nccl"))
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
    if args.distributed_worker:
        return distributed_worker(Path(args.distributed_worker), args.seed,
                                  args.distributed_backend)
    if args.distributed_cards > torch.cuda.device_count():
        print(f"chip_smoke: {args.distributed_cards} cards asked for, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(card.splitlines()[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    device_line = json.dumps({"ok": True, "device": {"platform": "gpu",
                                                     "kind": torch.cuda.get_device_name(0),
                                                     "count": torch.cuda.device_count()}})

    t = time.perf_counter()
    build_s = kernel_lib.build()
    log(f"kernels built in {time.perf_counter() - t:.1f} s: {build_s}")
    for log_file in sorted(kernel_lib.build_dir().glob("*.log")):
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {log_file.stem}: {line.strip()}")

    if args.distributed_cards > 1:  # the distributed phase over several cards alone
        summary = distributed_slice(args.seed, ShapeRecorder(), args.distributed_cards)
        print(json.dumps({"cards": card, "build_s": build_s, "distributed": summary,
                          "seconds": time.perf_counter() - t_start}))
        log(card)
        print(device_line)
        return 0

    phase_s = {"build": time.perf_counter() - t}  # wall seconds of each phase

    def phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        return out

    small = phase("small_reference", small_reference, args.seed)
    slice_summary = phase("slice", full_slice, args.seed)
    # the main paths whose shapes the kernel phases check: each sets the
    # counts to 0 just before its run and checks them just after
    recorder = ShapeRecorder()
    train_summary, metrics_jsonl = phase("turbo_loop", train_slice, args.seed, "turbo", recorder)
    dmd_summary, dmd_metrics_jsonl = phase("dmd_loop", train_slice, args.seed, "dmd", recorder)
    eval_summary = phase("eval", eval_slice, args.seed, recorder)
    db_summary = phase("dreambooth", dreambooth_slice, args.seed, recorder)
    remat_summary = phase("remat", remat_phase, args.seed, recorder)
    full_summary = phase("full_finetune", full_finetune_slice, args.seed, recorder)
    int8_summary = phase("int8", int8_slice, args.seed, recorder)
    dist_summary = phase("distributed", distributed_slice, args.seed, recorder)
    sd15_summary, sd15_paths = phase("sd15", sd15_slice, args.seed, recorder)
    paths = {"turbo_loop": train_summary["launches"], "dmd_loop": dmd_summary["launches"],
             "dmd_eval": eval_summary["launches_all_runs"],
             "dreambooth": db_summary["launches"], "remat": remat_summary["launches"],
             "full_finetune": full_summary["launches"], "distributed": dist_summary["launches"],
             **{f"int8_{name}": counts for name, counts in int8_summary["launches"].items()},
             **{f"distributed_{name}": counts
                for name, counts in dist_summary["launches_by_run"].items()}, **sd15_paths}
    entries = list(KERNELS) + [e for e, _, _ in HEAD_DIM_ENTRIES]
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in entries}
    bwd_rows, bwd_whole, bwd_by_dim, run_to_run = phase(
        "attention_bwd_phase", attention_bwd_phase, recorder.attention_bwd, args.seed)
    int8_rows, int8_sites = phase("int8_phase", int8_phase, recorder.int8, args.seed)
    rows = {**phase("attention_phase", attention_phase, recorder.attention, args.seed),
            **bwd_rows, **phase("gn_phase", gn_phase, recorder.gn, args.seed), **int8_rows}
    for entry, name, d in HEAD_DIM_ENTRIES:  # each SD1.x instance's rows apart
        rows[entry] = [r for r in rows[name] if r["shape"]["q"][-1] == d]
        rows[name] = [r for r in rows[name] if r["shape"]["q"][-1] != d]
    function_errs = phase("function_check", attention_function_check, args.seed)
    kernels = [summarize(name, rows[name], launches[name]) for name in entries]

    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "small_reference": small, "slice": slice_summary,
              "train": train_summary, "dmd_train": dmd_summary, "eval": eval_summary,
              "dreambooth": db_summary, "remat": remat_summary, "full_finetune": full_summary,
              "int8": int8_summary, "int8_matmul_sites": int8_sites, "distributed": dist_summary,
              "sd15": sd15_summary,
              "launches_by_path": paths, "function_check": function_errs, "kernels": kernels,
              "backward": bwd_whole, "backward_by_head_dim": bwd_by_dim,
              "backward_run_to_run": run_to_run, "phase_s": phase_s,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    (out / "train_metrics.jsonl").write_text(metrics_jsonl)
    (out / "dmd_train_metrics.jsonl").write_text(dmd_metrics_jsonl)
    log(f"chip_smoke done in {record['seconds']:.1f} s; seconds by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + f"; launches by path {paths}")
    log(card.splitlines()[0])
    print(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                   if k not in ("shapes", "by_head_dim")} for kern in kernels]}))
    print(device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
