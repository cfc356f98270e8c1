#!/usr/bin/env python3
"""Check and time the port's bf16 flash-attention kernels at the attention
shapes of the SDXL-Turbo online loop, of the SDXL-DMD2 loop and eval at
1024^2, of the SD1.x rollout and gradient at 512^2 (head dims 40, 80, 160),
and at the ragged lengths of ``chip_smoke.RAGGED``, ``chip_smoke.RAGGED_FWD``
and ``chip_smoke.RAGGED_SD15``, on one CUDA card.

    python3 scripts/time_port_attention.py [--root DIR] [--tag NAME] [--seed N]

``--root`` is the checkout whose ``pairwise_sample_optimization_tpu_torch``
is imported and built (default: this one), so that two versions of the
kernels can be timed in one call on one card, in turns (parent, change,
change, parent). The limits, the timer and the bounds are this checkout's
``chip_smoke.py`` (``fwd_tolerance``, ``grad_tolerance``, ``timed_ms``,
``bound``, ``_bwd_bounds``). At head dims 40, 64, 80 and 160 it runs K1
and the backward; at PickScore's 80 and the VAE's 512 (forward only) K1. For each shape it
prints each check's share of its limit, K1's CUDA-event device ms beside
its bound and SDPA's forward, and for the backward: each of its kernels'
ms (this version's pre / backward / post kernels, or an older checkout's
K2 / K3), the whole backward (``flash_attention_bwd``: Di, zeroing and
casts included) beside the function's bound (five products of
2 Sq Skv 64 a head) and the TPU design's K2 / K3 bounds (four and three
products), and SDPA's backward (autograd, dQ + dK + dV); then
launch-weighted means over each path's shapes (Turbo: one epoch of the
loop; DMD2: one epoch of the loop and one 8-prompt eval run, the runs
``chip_smoke.py`` drives; SD1.x: ``chip_smoke.sd15_slice``'s rollout and
gradient, the backward's means also per head dim). Then the int8 absmax
(Q1a, ``ops/qconv.py::absmax``) at the 512^2 VAE decode's shapes of
``chip_smoke.int8_off_path_shapes`` (rows of the weights, samples of the
activations) and at the same samples with a per-channel divisor (the
SmoothQuant path), each held bit-equal to ``absmax_plain`` and timed beside
``torch.linalg.vector_norm(ord=inf)`` where no divisor is taken. Everything
goes to ``time_port_attention_<tag>.json`` in the output directory that
``chip_smoke.py`` writes its record to. It exits non-zero if any check
failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (q (B, S, H, D), kv length, launches per epoch of the online loop: K1, K2 = K3)
MAIN_PATH = (((8, 1024, 10, 64), 1024, 520, 120), ((8, 1024, 10, 64), 77, 520, 120),
             ((8, 256, 20, 64), 256, 3120, 720), ((8, 256, 20, 64), 77, 3120, 720),
             ((8, 257, 16, 80), 257, 128, 0), ((8, 4096, 1, 512), 4096, 4, 0))
# the same for one epoch of the DMD2 loop at 1024^2 (16 UNet forwards at batch
# 4 when sampling; 24 microbatches of policy, remat and reference forwards at
# batch 2 and one backward) plus one eval run of 8 prompts at batch 2 (16 UNet
# forwards; PickScore, CLIP and HPS at d = 80, the aesthetic CLIP-L at 64)
DMD_PATH = (((4, 4096, 10, 64), 4096, 160, 0), ((4, 4096, 10, 64), 77, 160, 0),
            ((4, 1024, 20, 64), 1024, 960, 0), ((4, 1024, 20, 64), 77, 960, 0),
            ((2, 4096, 10, 64), 4096, 880, 240), ((2, 4096, 10, 64), 77, 880, 240),
            ((2, 1024, 20, 64), 1024, 5280, 1440), ((2, 1024, 20, 64), 77, 5280, 1440),
            ((4, 257, 16, 80), 257, 128, 0), ((2, 257, 16, 80), 257, 384, 0),
            ((2, 257, 16, 64), 257, 96, 0), ((4, 16384, 1, 512), 16384, 4, 0),
            ((2, 16384, 1, 512), 16384, 4, 0))
# the same for ``chip_smoke.sd15_slice``: 20 rollout steps and the gradient's 2
# UNet calls at batch 4 (2 prompts with CFG), 5 transformer blocks a level and
# the mid block's one; the gradient's 2 backward calls
SD15_PATH = tuple((q, skv, 22 * n, 2 * n) for q, n in (
    ((4, 4096, 8, 40), 5), ((4, 1024, 8, 80), 5), ((4, 256, 8, 160), 5), ((4, 64, 8, 160), 1))
    for skv in (q[1], 77))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_port_attention: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[{args.tag}] {card}; kernels from {kernel_lib.CSRC}", flush=True)
    libs = [n for n in ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_fma")
            if n in kernel_lib.SOURCES]
    build_s = kernel_lib.build(libs)
    ptxas = []
    for name in libs:
        for line in kernel_lib._lib_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                ptxas.append(f"{name}: {line.strip()}")
    print(f"[{args.tag}] built in {build_s}", *ptxas, sep="\n  ", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16
    cases = ([("turbo",) + c for c in MAIN_PATH] + [("dmd",) + c for c in DMD_PATH]
             + [("sd15",) + c for c in SD15_PATH]
             + [("ragged", qs, skv, 0, 0) for qs, skv in cs.RAGGED + cs.RAGGED_FWD
                + cs.RAGGED_SD15])
    # this checkout's plan by head dim, or an older one's: bf16 at d = 64 only
    # (the two-kernel route elsewhere: no accumulator)
    by_dim = "d" in inspect.signature(getattr(tfa, "bwd_plan", lambda *a: None)).parameters
    rows, failures = [], []

    def held(what, got, want, tol):
        try:
            cs.check_close(what, got, want, tol)
        except AssertionError as e:
            failures.append(str(e))
            print(f"[{args.tag}] FAILED {e}", flush=True)

    for path, qs, skv, launches, bwd_launches in cases:
        b, sq, h, d = qs
        ks = (b, skv, h, d)
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=bf16) for s in (qs, ks, ks))
        o, lse = tfa.flash_attention_fwd(q, k, v)
        o_p, lse_p = cs.attention_plain(q, k, v)
        name = f"q{qs} kv {skv}"
        tol_o = cs.fwd_tolerance(o_p)
        held(f"K1 o {name}", o, o_p, tol_o)
        held(f"K1 lse {name}", lse, lse_p, cs.TOL["attention_lse"])
        used = {"k1_o": cs.tolerance_used(o, o_p, tol_o),
                "k1_lse": cs.tolerance_used(lse, lse_p, cs.TOL["attention_lse"])}
        del o_p, lse_p
        pair = 2 * b * h * sq * skv * d
        k1_bound = cs.bound(q.element_size() * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(),
                            2 * pair, "bf16")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "path": path, "q": list(qs), "kv": skv, "launches": launches,
            "bwd_launches": bwd_launches,
            "tolerance_used": used,
            "k1_ms": cs.timed_ms(lambda: tfa.flash_attention_fwd(q, k, v)),
            "sdpa_fwd_ms": cs.timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
        }
        line = (f"K1 {row['k1_ms']:.4f} ms (bound {k1_bound[0]:.4f} {k1_bound[1]}), "
                f"SDPA fwd {row['sdpa_fwd_ms']:.4f}")
        if d in tfa.BWD_HEAD_DIMS:
            do = torch.randn(qs, generator=gen, device="cuda", dtype=bf16)
            want = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)))
            got = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd(q, k, v, o, lse, do)))
            tol = {n: cs.grad_tolerance(n, w, skv) for n, w in want.items()}
            for n in got:
                held(f"{n} {name}", got[n], want[n], tol[n])
            used.update({n: cs.tolerance_used(got[n], want[n], tol[n]) for n in got})
            kernels, acc_q, acc_kv = {}, True, False
            if hasattr(tfa, "bwd_plan"):  # the pre / backward / post kernels
                if by_dim:
                    q_chunk, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms, d)
                elif d == 64:
                    q_chunk, dq_rows, kv_rows = tfa.bwd_plan(b * h, sq, skv, sms)
                else:
                    q_chunk, dq_rows, kv_rows = -(-sq // 64), 0, 0
                acc_q, acc_kv = bool(dq_rows), bool(kv_rows)
                acc = torch.zeros(b * h * (dq_rows + 2 * kv_rows) * d, device="cuda")
                di = tfa.flash_attention_bwd_pre(o, do, acc)
                kernels["pre"] = cs.timed_ms(lambda: tfa.flash_attention_bwd_pre(o, do, acc))
                kernels["kernel"] = cs.timed_ms(lambda: tfa.flash_attention_bwd_main(
                    q, k, v, do, lse, di, acc, q_chunk, 1.0 / math.sqrt(d)))
                if acc_q or acc_kv:
                    outs = [torch.empty_like(t) for t in (q, k, v)]
                    kernels["post"] = cs.timed_ms(
                        lambda: tfa.flash_attention_bwd_post(acc, *outs, acc_q, acc_kv))
                row["q_chunk"] = q_chunk
            else:  # an older checkout: Di in torch, then K2 and K3
                di = tfa.attention_di(o, do)
                kernels["di"] = cs.timed_ms(lambda: tfa.attention_di(o, do))
                kernels["k2"] = cs.timed_ms(
                    lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, di))
                kernels["k3"] = cs.timed_ms(
                    lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, di))
            bounds = cs._bwd_bounds(q, k, skv, acc_q, acc_kv)
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
            out = F.scaled_dot_product_attention(qg, kg, vg)
            dot = do.transpose(1, 2)
            row.update({
                "kernel_ms": kernels,
                "bwd_ms": cs.timed_ms(lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do)),
                "sdpa_bwd_ms": cs.timed_ms(
                    lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)),
                "bwd_bound_ms": bounds["function"][0], "bwd_bound_by": bounds["function"][1],
                "kernel_bound_ms": {k_: bounds[k_][0] for k_ in
                                    ("flash_attn_bwd_pre", "flash_attn_bwd",
                                     "flash_attn_bwd_post", "k2", "k3")},
            })
            line += (", kernels " + " ".join(f"{k_} {v_:.4f}" for k_, v_ in kernels.items())
                     + f", whole backward {row['bwd_ms']:.4f} (bound {bounds['function'][0]:.4f} "
                     f"{bounds['function'][1]}; K2 {bounds['k2'][0]:.4f}, K3 "
                     f"{bounds['k3'][0]:.4f}), SDPA bwd {row['sdpa_bwd_ms']:.4f}")
            del out, qg, kg, vg
        rows.append(row)
        print(f"[{args.tag}] {name}: {line}; share of limit used "
              + ", ".join(f"{n} {u:.3f}" for n, u in used.items()), flush=True)

    def mean(key, weight, subset):
        return sum(r[key] * r[weight] for r in subset) / sum(r[weight] for r in subset)

    means = {}
    for path, prefix in (("turbo", ""), ("dmd", "dmd_"), ("sd15", "sd15_")):
        at_path = [r for r in rows if r["path"] == path]
        for d in sorted({r["q"][3] for r in at_path}):
            at_d = [r for r in at_path if r["q"][3] == d]
            means.update({f"{prefix}d{d}_{key}": mean(key, "launches", at_d)
                          for key in ("k1_ms", "k1_bound_ms", "sdpa_fwd_ms")})
        means.update({f"{prefix}all_{key}": mean(key, "launches", at_path)
                      for key in ("k1_ms", "k1_bound_ms", "sdpa_fwd_ms")})
        bwd = [r for r in at_path if r["bwd_launches"]]
        means.update({prefix + key: mean(key, "bwd_launches", bwd)
                      for key in ("bwd_ms", "bwd_bound_ms", "sdpa_bwd_ms")})
        for kern in bwd[0]["kernel_ms"]:  # per call of the backward (0 where not launched)
            means[f"{prefix}{kern}_kernel_ms"] = sum(
                r["kernel_ms"].get(kern, 0.0) * r["bwd_launches"] for r in bwd) / sum(
                r["bwd_launches"] for r in bwd)
        if path == "sd15":  # the backward per head dim
            for d in sorted({r["q"][3] for r in bwd}):
                means.update({f"{prefix}d{d}_{key}": mean(key, "bwd_launches",
                                                          [r for r in bwd if r["q"][3] == d])
                              for key in ("bwd_ms", "bwd_bound_ms", "sdpa_bwd_ms")})
    print(f"[{args.tag}] launch-weighted means over each path's shapes: "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    absmax_rows = absmax_phase(cs, args, gen, failures)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_port_attention_{args.tag}.json").write_text(json.dumps(
        {"card": card, "root": args.root, "build_s": build_s, "ptxas": ptxas, "rows": rows,
         "launch_weighted_means": means, "absmax": absmax_rows, "failures": failures}, indent=1))
    if failures:
        print(f"[{args.tag}] {len(failures)} checks failed", file=sys.stderr)
    return 1 if failures else 0


def absmax_phase(cs, args, gen, failures):
    """Q1a of the checkout at the VAE decode's absmax shapes, bf16, without
    and with a divisor: bit-equal to its plain version, CUDA-event ms beside
    ``vector_norm(ord=inf)`` (no divisor) and the bytes bound."""
    import torch

    from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

    keys = sorted({(k[1], k[3]) for k in cs.int8_off_path_shapes() if k[0] == "absmax"})
    cases = [(shape, mode, False) for shape, mode in keys]
    cases += [(shape, mode, True) for shape, mode in keys if mode == "samples"]
    rows = []
    for shape, mode, divided in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.7 + 0.1).to(torch.bfloat16)
        div = (torch.rand(shape[1], generator=gen, device="cuda") + 0.5) if divided else None
        name = f"absmax {shape} {mode}" + (" with a divisor" if divided else "")
        if not torch.equal(tq.absmax(x, mode, div), tq.absmax_plain(x, mode, div)):
            failures.append(f"{name}: differs from its plain version")
            print(f"[{args.tag}] FAILED {name}: differs from its plain version", flush=True)
        dims = {"rows": -1, "samples": (1, 2, 3)}[mode]
        n_rows = shape[0]
        row = {"x": list(shape), "mode": mode, "divisor": divided,
               "ms": cs.timed_ms(lambda: tq.absmax(x, mode, div)),
               "library_ms": None if divided else cs.timed_ms(
                   lambda: torch.linalg.vector_norm(x, float("inf"), dim=dims)),
               "bound_ms": cs.bound(x.numel() * 2 + 4 * n_rows + (4 * shape[1] if divided else 0),
                                    cs.ABSMAX_OPS * x.numel(), "fp32")[0]}
        rows.append(row)
        print(f"[{args.tag}] {name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f})"
              + ("" if divided else f", vector_norm {row['library_ms']:.4f}"), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
