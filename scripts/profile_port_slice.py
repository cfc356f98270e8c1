#!/usr/bin/env python3
"""Where the time of one serving-slice iteration goes on the card.

    python3 scripts/profile_port_slice.py [--seed N]

Builds the full-width SDXL-Turbo slice of the PyTorch port (the
configuration ``chip_smoke.py`` drives: 4 prompts, 8 trajectories, 4
steps, 512^2, bf16, LoRA rank 32), runs one warm-up iteration, then one
iteration under ``torch.profiler`` and prints:

- the wall-clock ms of an unprofiled iteration (host clock, ends in a
  synchronize) and the device-busy ms of the profiled one (sum of kernel
  durations; one stream, so kernels do not overlap), and the idle share
  1 - busy / wall;
- device ms by category (the port's three kernels, cuDNN's layout copies,
  convolutions, matrix products, everything else) and the number of kernel
  launches;
- the top kernels by device time.

Needs one CUDA card; writes the same summary to
``chiprun_out/profile_port_slice.json``.
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
    ("K4 gn_stats", ("gn_stats_kernel",)),
    ("K5 gn_silu_norm", ("gn_norm_silu_kernel",)),
    ("cuDNN NCHW<->NHWC layout copies", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "fprop")),
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
    args = ap.parse_args(argv)

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
    pipe = SDXLPipeline.random(lora_rank=32, dtype=torch.bfloat16, resolution=512,
                               seed=args.seed, lora_b_std=1.0 / 32, device="cuda")
    gen = torch.Generator().manual_seed(args.seed)
    ids = [torch.randint(1, 49407, (4, 77), generator=gen).cuda() for _ in range(3)]
    cuda_gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def iteration():
        cond = pipe.encode_prompt(*ids)
        return pipe.sample_pairs(cond, cuda_gen, num_steps=4)

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
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            by_name[evt.name] += us / 1e3
            by_cat[category(evt.name)] += us / 1e3
            launches += 1
    if not launches:
        print("the profiler recorded no device activity: device time not measured")
        return 1
    busy_ms = sum(by_name.values())
    summary = {
        "card": card, "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
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
    (out / "profile_port_slice.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
