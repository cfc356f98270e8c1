#!/usr/bin/env python3
"""Where the time of one serving-slice iteration, or of one online-PSO
update, goes on the card.

    python3 scripts/profile_port_slice.py [--seed N] [--update | --eval] [--dmd]

Builds the full-width SDXL-Turbo slice of the PyTorch port (the
configuration ``chip_smoke.py`` drives: 4 prompts, 8 trajectories, 4
steps, 512^2, bf16, LoRA rank 32), runs one warm-up iteration, then one
iteration under ``torch.profiler``. With ``--update`` the iteration is one
optimizer update of the online trainer at the config's defaults (remat
"full", 2 x 3 microbatches of 4 pairs, the policy pass at batch 8, a
grad-free reference pass) on 8 pairs sampled first. With ``--dmd`` the
slice is SDXL-DMD2's at its config (``configs/sdxl_dmd_dpo.py``: 2 prompts,
4 trajectories on the lattice [999, 749, 499, 249], 1024^2, LoRA rank 16)
and the update its trainer's (4 x 3 microbatches of 1 pair, the policy
pass at batch 2, remat "full", a grad-free reference pass) on 4 pairs.
With ``--eval`` the iteration is one batch of ``cli.evaluate_sdxl_dmd2``
at its defaults: 2 prompts, DMD2 at 1024^2 with per-prompt generators,
scored by PickScore, CLIP score, HPS and the aesthetic scorer.
It prints:

- the wall-clock ms of an unprofiled iteration (host clock, ends in a
  synchronize) and the device-busy ms of the profiled one (sum of kernel
  durations; one stream, so kernels do not overlap), and the idle share
  1 - busy / wall;
- device ms by category (the port's kernels, cuDNN's layout copies,
  convolutions, matrix products, everything else) and the number of kernel
  launches;
- the top kernels by device time.

Needs one CUDA card; writes the same summary to
``chiprun_out/profile_port_slice.json``.
With ``--update`` the file is ``profile_port_update.json`` beside it, with
``--eval`` ``profile_port_eval.json``; with ``--dmd`` ``_dmd`` comes
before ``.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("K1 flash_attn_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_attn_bwd_dkv", ("flash_bwd_dkv_kernel",)),  # older checkouts; the fp32 path
    ("K3 flash_attn_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_attn_bwd_pre (Di)", ("flash_bwd_pre_kernel",)),
    ("flash_attn_bwd_post (casts)", ("flash_bwd_post_kernel",)),
    ("flash_attn_bwd (K2 + K3)", ("flash_bwd_kernel",)),
    ("K4 gn_stats", ("gn_stats_kernel",)),
    ("K5 gn_silu_norm", ("gn_norm_silu_kernel",)),
    ("cuDNN NCHW<->NHWC layout copies", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop")),
    ("matrix product", ("gemm", "cutlass", "xmma", "gemv", "matmul", "nvjet")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other (elementwise, norms, copies)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--update", action="store_true", help="profile one optimizer update")
    ap.add_argument("--eval", action="store_true", help="profile one eval batch (SDXL-DMD2)")
    ap.add_argument("--dmd", action="store_true", help="SDXL-DMD2 at 1024^2 instead of Turbo")
    args = ap.parse_args(argv)
    args.dmd = args.dmd or args.eval

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_slice: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    kernel_lib.build()
    rank, resolution, prompts = (16, 1024, 2) if args.dmd else (32, 512, 4)
    sampler = "dmd" if args.dmd else "turbo"
    pipe = SDXLPipeline.random(lora_rank=rank, dtype=torch.bfloat16, resolution=resolution,
                               seed=args.seed, lora_b_std=1.0 / rank,
                               remat="full" if args.update else "", device="cuda")
    gen = torch.Generator().manual_seed(args.seed)
    ids = [torch.randint(1, 49407, (prompts, 77), generator=gen).cuda() for _ in range(3)]
    cuda_gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def iteration():
        cond = pipe.encode_prompt(*ids)
        return pipe.sample_pairs(cond, cuda_gen, num_steps=4, sampler=sampler)

    if args.update:
        iteration = update_iteration(pipe, ids, cuda_gen, gen, args.dmd)
    elif args.eval:
        iteration = eval_iteration(pipe, ids, args.seed)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    iteration()
    # the wall time is taken without the profiler, whose host-side tracing
    # slows the host; the device time comes from the profiled iteration
    wall_ms = wall(iteration)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = wall(iteration)

    by_name, by_cat, launches = defaultdict(float), defaultdict(float), 0
    for evt in prof.events():
        # kernels only: ranges such as "Optimizer.step#AdamW.step" are also
        # listed among the device events, as user annotations
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            us = evt.time_range.elapsed_us()
            by_name[evt.name] += us / 1e3
            by_cat[category(evt.name)] += us / 1e3
            launches += 1
    if not launches:
        print("the profiler recorded no device activity: device time not measured")
        return 1
    busy_ms = sum(by_name.values())
    summary = {
        "card": card, "sampler": sampler, "resolution": resolution, "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "kernel_launches": launches,
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:25]),
    }
    print(f"iteration wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle share {summary['idle_share']:.3f}), {launches} kernel launches")
    for cat, ms in summary["by_category_ms"].items():
        print(f"  {cat:40s} {ms:9.2f} ms  {ms / busy_ms:6.1%}")
    print("top kernels:")
    for name, ms in summary["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name[:110]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    kind = "update" if args.update else "eval" if args.eval else "slice"
    name = f"profile_port_{kind}" + ("_dmd.json" if args.dmd else ".json")
    (out / name).write_text(json.dumps({"iteration": kind, **summary}, indent=1))
    return 0


def update_iteration(pipe, ids, cuda_gen, gen, dmd=False):
    """One optimizer update of the online trainer (its config's defaults) on
    the pairs of two prompt batches: Turbo 2 x 4 pairs, DMD2 2 x 2."""
    import torch

    from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                              PSOTrainState, lora_parameters,
                                                              make_optimizer)

    for module in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model):
        module.requires_grad_(False)
    ocfg = (OnlinePSOConfig(sampler="dmd", num_steps=4, train_batch_size=1, grad_accum=4,
                            compare="pareto") if dmd else
            OnlinePSOConfig(num_steps=4, train_batch_size=4, grad_accum=2))
    trainer = OnlinePSOTrainer(ocfg, pipe)
    lora = lora_parameters(pipe.unet)
    state = PSOTrainState.create(lora, make_optimizer(lora))
    parts = []
    for _ in range(2):
        cond = pipe.encode_prompt(*ids)
        samples, _ = trainer.sample_pairs(cond, cuda_gen)
        parts.append((samples, {k: cond[k] for k in ("embeds", "pooled", "time_ids")}))
    split = lambda trees: {k: torch.cat([t[k] for t in trees]).reshape(
        (ocfg.grad_accum, ocfg.train_batch_size) + trees[0][k].shape[1:]) for k in trees[0]}
    batch, cond = split([p[0] for p in parts]), split([p[1] for p in parts])
    return lambda: trainer.update(state, batch, cond, gen)


def eval_iteration(pipe, ids, seed):
    """One batch of the eval protocol: encode, DMD2 generation with one
    generator per prompt, and the four scorers (random towers, the released
    aesthetic MLP)."""
    import torch

    from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev

    pipe.scorer = None
    scorers = ev.build_scorers(list(ev.SCORERS), False, seed, pipe.device,
                               aesthetic_mlp_path="packaged")

    @torch.no_grad()
    def iteration():
        cond = pipe.encode_prompt(*ids[:2])
        gens = [ev.prompt_generator(seed, i, pipe.device) for i in range(ids[0].shape[0])]
        images = pipe.generate_dmd(cond, num_steps=4, sample_generators=gens)
        return [s.score(images) if name == "aesthetic" else s.score(images, ids[2])
                for name, s in scorers.items()]

    return iteration


if __name__ == "__main__":
    sys.exit(main())
