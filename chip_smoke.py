#!/usr/bin/env python3
"""Drive the PyTorch port of the PSO serving slice on one NVIDIA H100.

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
   peak memory;
5. one phase per kernel at every shape the slice gave it (recorded during
   step 4) in bf16, plus one fp32 case: the kernel against its plain
   version on the same inputs (|diff| <= atol + rtol*|plain|: attention
   2e-2 bf16 / 2e-3 fp32, GroupNorm+SiLU 3e-2 / 2e-4), and CUDA-event
   device times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call (timed here only; the port
   never calls it). Back-to-back calls on one input: an input under the
   50 MB L2 stays there, as a GroupNorm input just written by a conv does;
6. prints the ``{"kernels": [...]}`` line, then, last, the device line.

Any failure raises, and the script exits non-zero. It also exits non-zero,
printing no result, where CUDA or the port's package is missing. The full
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense): device memory
# rate, bf16 tensor-core rate, fp32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
GN_STATS_OPS, GN_NORM_OPS = 3, 8  # fp32 operations per element of K4, K5
TOL = {"attention": {"bf16": 2e-2, "fp32": 2e-3}, "gn": {"bf16": 3e-2, "fp32": 2e-4}}
KERNELS = {
    "flash_attn_fwd": ("pairwise_sample_optimization_tpu_torch/csrc/flash_attn_fwd.cu",
                       "pairwise_sample_optimization_tpu/ops/flash_attention.py:99"),
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
    """Fail unless |got - want| <= tol + tol*|want| everywhere; returns max|diff|."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max|diff| {diff.max().item():.3e} over tolerance {tol} "
                             f"({int(bad.sum())} elements)")
    return diff.max().item()


def timed_ms(fn, reps=10, inner=10):
    """Median over ``reps`` of CUDA-event device time per call for ``inner``
    calls in a row, after 3 warm-up calls. Each rep first queues ~2 ms of
    device sleep, so the host has enqueued the calls before the start event
    runs: the time is the device's, not the host's launch rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
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
    if min(counts.values()) == 0:
        raise AssertionError(f"small reference did not reach every kernel: {counts}")
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


def expected_launches(pipe, steps):
    ucfg, vcfg = pipe.unet.config, pipe.vae.config
    n, lpb = len(ucfg.block_out_channels), ucfg.layers_per_block
    blocks = sum(d * (2 * lpb + 1) for d in ucfg.transformer_layers) + ucfg.transformer_layers[-1]
    unet_resnets = n * (2 * lpb + 1) + 2
    vae_resnets = 2 + len(vcfg.block_out_channels) * (vcfg.layers_per_block + 1)
    vision_layers = pipe.scorer.model.vision_config.layers
    k1 = steps * 2 * blocks + 1 + vision_layers
    gn = steps * (2 * unet_resnets + 1) + 2 * vae_resnets + 1
    return {"flash_attn_fwd": k1, "gn_stats": gn, "gn_silu_norm": gn}


class ShapeRecorder:
    """Records the shapes the main path hands each kernel wrapper, by
    wrapping the module functions the models reach (observation only)."""

    def __init__(self):
        from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
        from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg

        self.mods, self.attention, self.gn = (tfa, tfg), {}, {}
        self.orig = (tfa.flash_attention_fwd, tfg.fused_groupnorm_silu)

    def __enter__(self):
        tfa, tfg = self.mods
        fwd, gn = self.orig

        def rec_fwd(q, k, v, scale=None):
            key = (tuple(q.shape), tuple(k.shape), q.dtype)
            self.attention[key] = self.attention.get(key, 0) + 1
            return fwd(q, k, v, scale)

        def rec_gn(x, weight, bias, num_groups, eps=1e-5):
            key = (tuple(x.shape), num_groups, eps, x.dtype, weight.dtype)
            self.gn[key] = self.gn.get(key, 0) + 1
            return gn(x, weight, bias, num_groups, eps)

        tfa.flash_attention_fwd, tfg.fused_groupnorm_silu = rec_fwd, rec_gn
        return self

    def __exit__(self, *exc):
        tfa, tfg = self.mods
        tfa.flash_attention_fwd, tfg.fused_groupnorm_silu = self.orig


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
    runs, recorder = [], None
    for i in range(iters):
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launch_counts()
        if i == 0:
            with ShapeRecorder() as recorder:
                out = run(timings)
        else:
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
    del pipe
    torch.cuda.empty_cache()
    return summary, recorder


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
    rows = []
    for qs, ks, dt, launches in cases:
        q = torch.randn(qs, generator=gen, device="cuda", dtype=dt)
        k = torch.randn(ks, generator=gen, device="cuda", dtype=dt)
        v = torch.randn(ks, generator=gen, device="cuda", dtype=dt)
        o_k, lse_k = tfa.flash_attention_fwd(q, k, v)
        o_p, lse_p = tfa.flash_attention_plain(q, k, v)
        tol = TOL["attention"][dtype_name(dt)]
        err = max(check_close(f"attention {qs} kv {ks[1]} {dtype_name(dt)}", o_k, o_p, tol),
                  check_close(f"attention lse {qs} {dtype_name(dt)}", lse_k, lse_p, tol))
        b, sq, h, d = qs
        skv = ks[1]
        bytes_moved = q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse_k.numel()
        bound_ms, bound_by = bound(bytes_moved, 4 * b * h * sq * skv * d, dtype_name(dt))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "shape": {"q": list(qs), "kv": list(ks)}, "dtype": dtype_name(dt),
            "launches": launches, "max_abs_err": err,
            "ms": timed_ms(lambda: tfa.flash_attention_fwd(q, k, v)),
            "plain_ms": timed_ms(lambda: tfa.flash_attention_plain(q, k, v)),
            "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(row)
        log(f"flash_attn_fwd {row['dtype']} q{qs} kv{skv}: max|diff| {err:.2e} (tol {tol}), "
            f"{row['ms']:.4f} ms vs bound {bound_ms:.4f} ({bound_by}), plain "
            f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, {launches} launches")
    return {"flash_attn_fwd": rows}


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
    slice_summary, recorder = full_slice(args.seed)
    launches = slice_summary["runs"][0]["launches"]
    rows = {**attention_phase(recorder.attention, args.seed),
            **gn_phase(recorder.gn, args.seed)}
    kernels = [summarize(name, rows[name], launches[name]) for name in KERNELS]

    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s, "small_reference": small, "slice": slice_summary,
              "kernels": kernels, "seconds": time.perf_counter() - t_start}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"chip_smoke done in {record['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "shapes"}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
