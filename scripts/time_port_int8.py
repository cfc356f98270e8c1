#!/usr/bin/env python3
"""Check and time the port's int8 convolution (Q2, ``ops/qconv.py::conv3x3``),
int8 quantize (Q1b / Q1c, ``quantize_rows`` / ``quantize_nhwc``) and int8
matmul sites (``int8_matmul``) at the shapes a ``chip_smoke.py`` record
lists for them, on one CUDA card.

    python3 scripts/time_port_int8.py [--root DIR] [--tag NAME] [--seed N] [--record FILE]
                                      [--split-sweep] [--ref-pass]

``--root`` is the checkout whose ``pairwise_sample_optimization_tpu_torch``
is imported and built (default: this one), so that two versions of the
kernels can be timed in one call on one card, in turns (parent, change,
change, parent). ``--record`` is a ``chip_smoke.py`` record
(``chiprun_out/chip_smoke.json``): the shapes of its ``int8_conv3x3`` and
``int8_quantize`` entries, and its ``int8_matmul_sites``, with their
launches on the paths. Each shape is held bit-equal (``torch.equal``) to
the checkout's plain version on inputs drawn here and timed with this
checkout's ``chip_smoke.timed_ms`` (CUDA events, the host's enqueueing
hidden) beside ``chip_smoke.bound``'s bound and, for the conv, bf16
``F.conv2d`` of the same shape. A matmul site is timed whole (Q1 twice and
the product, ``int8_matmul``) and as its product step on the site's own
integers and scales: ``q8_matmul`` (``qconv.matmul``) where the checkout has
it, else ``torch._int_mm`` then the dequantize kernel (``qconv.int_mm``,
``qconv.dequant``); the step's output bytes are hashed, so two checkouts'
runs can be held equal. Then the launch-weighted means over the shapes.
``--split-sweep`` (a checkout with ``matmul_plan``) also times the product
at every N tile (128 and 256) and every split of K in one wave at
the sites and ``chip_smoke.INT8_MATMUL_EDGES``, each held bit-equal: the
measurements behind the plan's rule.
``--ref-pass`` also times the int8 reference pass as ``chip_smoke.py``'s
int8 Turbo loop runs it: one forward of the full-width SDXL UNet (random
bf16 weights from ``--seed``, LoRA rank 32 at scale 0) at batch 8 and
512^2, in bf16 and inside ``qconv.int8_ref_pass``, in turns: the
synchronized wall ms (median of 3), the device ms (``chip_smoke.timed_ms``)
and the device busy ms (``chip_smoke._device_busy_ms``, a ``torch.profiler``
trace's kernel time), and each output's bytes hashed, so that two
checkouts' int8 passes can be held equal.
Everything goes to ``time_port_int8_<tag>.json`` in ``chiprun_out/``. It
exits non-zero if a check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# chip_smoke.py's int8 reference pass: policy batch 8 of 512^2 latents
REF_PASS_BATCH, REF_PASS_HW, REF_PASS_LORA_RANK, REF_PASS_REPS = 8, 64, 32, 3


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _sha256(t) -> str:
    """A tensor's bytes hashed."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return hashlib.sha256(t.contiguous().view(ints).cpu().numpy().tobytes()).hexdigest()


def ref_pass_times(cs, tq, seed):
    """The reference forward in bf16 and in int8 (see the module's
    ``--ref-pass``): per mode its wall, device and device busy ms and its
    output's hash, and the int8 output's relative L2 to the bf16 one."""
    import torch

    from pairwise_sample_optimization_tpu_torch.models import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu_torch.models.layers import init_weights_
    from pairwise_sample_optimization_tpu_torch.models.sdxl_text import compute_time_ids

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = UNetConfig.sdxl(lora_rank=REF_PASS_LORA_RANK, dtype=torch.bfloat16)
    unet = SDXLUNet(cfg, device="meta")
    unet.to_empty(device="cuda")
    init_weights_(unet, gen)
    unet.eval()
    b, hw = REF_PASS_BATCH, REF_PASS_HW
    x = torch.randn((b, 4, hw, hw), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    embeds = torch.randn((b, 77, cfg.cross_attention_dim), generator=gen,
                         device="cuda").to(torch.bfloat16)
    pooled = torch.randn((b, cfg.pooled_embed_dim), generator=gen, device="cuda").to(torch.bfloat16)
    time_ids = compute_time_ids(b, 8 * hw, device="cuda")

    def run(mode):
        with torch.no_grad(), tq.int8_ref_pass(mode == "int8"):
            return unet(x, t, embeds, pooled, time_ids, lora_scale=0.0)

    out, wall = {}, {"bf16": [], "int8": []}
    for _ in range(REF_PASS_REPS):
        for mode in wall:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[mode] = run(mode)
            torch.cuda.synchronize()
            wall[mode].append((time.perf_counter() - t0) * 1e3)
    result = {mode: {"wall_ms": statistics.median(v),
                     "device_ms": cs.timed_ms(lambda: run(mode)),
                     "device_busy_ms": cs._device_busy_ms(lambda: run(mode)),
                     "eps_sha256": _sha256(out[mode])} for mode, v in wall.items()}
    e, e8 = out["bf16"].double(), out["int8"].double()
    result["eps_rel_l2"] = float((e8 - e).norm() / e.norm())
    result["finite"] = bool(torch.isfinite(out["int8"]).all() and torch.isfinite(out["bf16"]).all())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
    ap.add_argument("--split-sweep", action="store_true")
    ap.add_argument("--ref-pass", action="store_true")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_port_int8: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
    from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[{args.tag}] {card}; kernels from {kernel_lib.CSRC}", flush=True)
    build_s = kernel_lib.build(None if args.ref_pass else ["int8_conv"])
    torch.backends.cudnn.allow_tf32 = False
    record = json.loads(Path(args.record).read_text())
    shapes = {name: [] for name in ("int8_conv3x3", "int8_quantize")}
    shapes.update({k["name"]: k["shapes"] for k in record.get("kernels", [])
                   if k["name"] in shapes})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dt = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}
    rows, failures = {"int8_conv3x3": [], "int8_quantize": [], "int8_matmul_sites": []}, []

    def held(name, got, want):
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
            failures.append(f"{name}: differs from its plain version")
            print(f"[{args.tag}] FAILED {name}: differs from its plain version", flush=True)

    for entry in shapes["int8_conv3x3"]:
        d = entry["shape"]
        (b, h, w, c), o, dtype, bias = d["x"], d["w"][0], dt[d["out"]], d["bias"]
        xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (o, 3, 3, c), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(b, generator=gen, device="cuda") * 0.02 + 1e-3
        sw = torch.rand(o, generator=gen, device="cuda") * 1e-3 + 1e-5
        bi = torch.randn(o, generator=gen, device="cuda") if bias else None
        name = f"conv3x3 {(b, h, w, c)} x {o} {d['out']} bias={bias}"
        held(name, (tq.conv3x3(xq, wq, sx, sw, bi, dtype),),
             (tq.conv3x3_plain(xq, wq, sx, sw, bi, dtype),))
        xl = torch.randn((b, c, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        wl = (torch.randn((o, c, 3, 3), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        out_el = torch.empty((), dtype=dtype).element_size()
        row = {"shape": d, "launches": entry["launches"],
               "ms": cs.timed_ms(lambda: tq.conv3x3(xq, wq, sx, sw, bi, dtype)),
               "bf16_conv2d_ms": cs.timed_ms(lambda: F.conv2d(xl, wl, padding=1)),
               "bound_ms": cs.bound(xq.numel() + wq.numel() + b * o * h * w * out_el
                                    + 4 * (b + 2 * o), 2 * b * h * w * o * 9 * c, "int8")[0]}
        rows["int8_conv3x3"].append(row)
        print(f"[{args.tag}] {name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}), bf16 "
              f"F.conv2d {row['bf16_conv2d_ms']:.4f}; {row['launches']} launches", flush=True)
        del xq, wq, xl, wl
        torch.cuda.empty_cache()

    for entry in shapes["int8_quantize"]:
        d = entry["shape"]
        shape, layout, divided = tuple(d["x"]), d["layout"], d["divisor"]
        offset = d.get("base_offset", 0)
        dtype = torch.float32 if d.get("dtype") == "torch.float32" else torch.bfloat16
        n = math.prod(shape)
        x = (torch.randn((n + offset,), generator=gen, device="cuda") * 1.7 + 0.1).to(dtype)
        x = x[offset:].view(shape)
        am = torch.rand(shape[0], generator=gen, device="cuda") * 3
        div = torch.rand(shape[1], generator=gen, device="cuda") + 0.5 if divided else None
        if layout == "quantize_rows":
            fn, plain = (lambda: tq.quantize_rows(x, am)), (lambda: tq.quantize_rows_plain(x, am))
        else:
            fn = lambda: tq.quantize_nhwc(x, am, div)
            plain = lambda: tq.quantize_nhwc_plain(x, am, div)
        name = f"{layout} {shape} divisor={divided} offset={offset}"
        held(name, fn(), plain())
        row = {"shape": d, "launches": entry["launches"], "ms": cs.timed_ms(fn),
               "bound_ms": cs.bound(n * x.element_size() + n + 8 * shape[0],
                                    cs.QUANTIZE_OPS * n, "fp32")[0]}
        rows["int8_quantize"].append(row)
        print(f"[{args.tag}] {name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}); "
              f"{row['launches']} launches", flush=True)

    fused = hasattr(tq, "matmul")
    route = "q8_matmul" if fused else "torch._int_mm + q8_dequant"
    for site in record.get("int8_matmul_sites", []):
        m, k, n = site["m"], site["k"], site["n"]
        dtype = dt[site.get("out", "torch.bfloat16")]
        x = (torch.randn((m, k), generator=gen, device="cuda") * 1.7 + 0.1).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        bias = (torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
                if site.get("bias") else None)
        (xq, sx), (wq, sw) = (tq.quantize_rows(t, tq.absmax(t, "rows")) for t in (x, w))
        b = None if bias is None else bias.float()
        if fused:
            step = lambda: tq.matmul(xq, wq, sx, sw, b, dtype)
            plain = lambda: tq.matmul_plain(xq, wq, sx, sw, b, dtype)
        else:
            step = lambda: tq.dequant(tq.int_mm(xq, wq), sx, sw, b, dtype)
            plain = lambda: tq.dequant_plain(tq.int_mm(xq, wq), sx, sw, b, dtype)
        name = f"int8 matmul site {(m, k, n)} {dtype} bias={bias is not None}"
        y = step()
        held(name, (y,), (plain(),))
        out_el = y.element_size()
        row = {"shape": {"m": m, "k": k, "n": n, "out": str(dtype), "bias": bias is not None},
               "launches": site["launches"], "route": route,
               "out_sha256": _sha256(y),
               "whole_ms": cs.timed_ms(lambda: tq.int8_matmul(x, w, bias, out_dtype=dtype)),
               "step_ms": cs.timed_ms(step),
               "bf16_matmul_ms": cs.timed_ms(lambda: x @ w.t()),
               "bound_ms": cs.bound(m * k + n * k + m * n * out_el + 4 * (m + 2 * n),
                                    2 * m * k * n, "int8")[0]}
        rows["int8_matmul_sites"].append(row)
        print(f"[{args.tag}] {name}: whole {row['whole_ms']:.4f} ms, product step ({route}) "
              f"{row['step_ms']:.4f} (bound {row['bound_ms']:.4f}), bf16 torch.matmul "
              f"{row['bf16_matmul_ms']:.4f}; {row['launches']} launches", flush=True)
        del x, w, xq, wq, y
        torch.cuda.empty_cache()

    sweep = []
    if args.split_sweep and fused:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        shapes_ = {(s_["m"], s_["k"], s_["n"], s_.get("out", "torch.bfloat16"))
                   for s_ in record.get("int8_matmul_sites", [])}
        shapes_ |= {(m, k, n, out) for m, k, n, out, _ in cs.INT8_MATMUL_EDGES}
        plan_of = tq.matmul_plan
        for m, k, n, out in sorted(shapes_):
            base = plan_of(m, k, n, sms)
            dtype = dt[out]
            xq = torch.randint(-127, 128, (m, -(-k // 16) * 16), generator=gen, device="cuda",
                               dtype=torch.int8)[:, :k]
            wq = torch.randint(-127, 128, (n, -(-k // 16) * 16), generator=gen, device="cuda",
                               dtype=torch.int8)[:, :k]
            sx, sw = (torch.rand(r, generator=gen, device="cuda") * 1e-3 + 1e-5 for r in (m, n))
            want = tq.matmul_plain(xq, wq, sx, sw, None, dtype)
            times = {}
            # every N tile the kernel has, every split of K in one wave
            for bn in (128, 256):
                tiles_n = -(-n // bn)
                tiles = base.tiles_m * tiles_n
                for s in range(1, max(1, min(base.k_steps, sms // tiles)) + 1):
                    chunk = -(-base.k_steps // s)
                    if -(-base.k_steps // chunk) != s:
                        continue
                    forced = dataclasses.replace(base, bn=bn, tiles_n=tiles_n, tiles=tiles,
                                                 splits=s, chunk=chunk, units=tiles * s,
                                                 grid=min(tiles * s, sms))
                    tq.matmul_plan = lambda *a, **kw: forced
                    try:
                        held(f"sweep {(m, k, n)} {out} bn={bn} splits={s}",
                             (tq.matmul(xq, wq, sx, sw, None, dtype),), (want,))
                        times[f"{bn}/{s}"] = cs.timed_ms(
                            lambda: tq.matmul(xq, wq, sx, sw, None, dtype))
                    finally:
                        tq.matmul_plan = plan_of
            sweep.append({"m": m, "k": k, "n": n, "out": out, "k_steps": base.k_steps,
                          "plan": f"{base.bn}/{base.splits}", "ms": times})
            print(f"[{args.tag}] sweep {(m, k, n)} {out}: {base.k_steps} k-steps, plan "
                  f"{base.bn}/{base.splits}: "
                  + ", ".join(f"{c} -> {t:.4f}" for c, t in times.items()), flush=True)
            del xq, wq, want
            torch.cuda.empty_cache()

    ref_pass = None
    if args.ref_pass:
        ref_pass = ref_pass_times(cs, tq, args.seed)
        if not ref_pass["finite"]:
            failures.append("reference pass: output not finite")
        print(f"[{args.tag}] reference pass (batch {REF_PASS_BATCH}, {8 * REF_PASS_HW}^2): "
              + "; ".join(f"{mode} wall {r['wall_ms']:.1f} ms, device {r['device_ms']:.1f}, "
                          f"busy {r['device_busy_ms'] or float('nan'):.1f}, "
                          f"eps {r['eps_sha256'][:16]}"
                          for mode, r in ref_pass.items() if mode in ("bf16", "int8"))
              + f"; int8 eps rel L2 {ref_pass['eps_rel_l2']:.5f}", flush=True)

    means = {}
    for kernel, rs in rows.items():
        total = sum(r["launches"] for r in rs)
        keys = {"int8_conv3x3": ("ms", "bound_ms", "bf16_conv2d_ms"),
                "int8_matmul_sites": ("whole_ms", "step_ms", "bound_ms", "bf16_matmul_ms")}.get(
                    kernel, ("ms", "bound_ms"))
        for key in keys:
            means[f"{kernel}_{key}"] = sum(r["launches"] * r[key] for r in rs) / max(total, 1)
    print(f"[{args.tag}] launch-weighted means: "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_port_int8_{args.tag}.json").write_text(json.dumps(
        {"card": card, "root": args.root, "build_s": build_s, "record": args.record, "rows": rows,
         "launch_weighted_means": means, "split_sweep": sweep, "ref_pass": ref_pass,
         "failures": failures}, indent=1))
    if failures:
        print(f"[{args.tag}] {len(failures)} checks failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
