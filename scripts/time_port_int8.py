#!/usr/bin/env python3
"""Check and time the port's int8 convolution (Q2, ``ops/qconv.py::conv3x3``)
and int8 quantize (Q1b / Q1c, ``quantize_rows`` / ``quantize_nhwc``) at the
shapes a ``chip_smoke.py`` record lists for them, on one CUDA card.

    python3 scripts/time_port_int8.py [--root DIR] [--tag NAME] [--seed N] [--record FILE]

``--root`` is the checkout whose ``pairwise_sample_optimization_tpu_torch``
is imported and built (default: this one), so that two versions of the
kernels can be timed in one call on one card, in turns (parent, change,
change, parent). ``--record`` is a ``chip_smoke.py`` record
(``chiprun_out/chip_smoke.json``): the shapes of its ``int8_conv3x3`` and
``int8_quantize`` entries and their launches on the paths. Each shape is
held bit-equal (``torch.equal``) to the checkout's plain version on inputs
drawn here and timed with this checkout's ``chip_smoke.timed_ms`` (CUDA
events, the host's enqueueing hidden) beside ``chip_smoke.bound``'s bound
and, for the conv, bf16 ``F.conv2d`` of the same shape; then the
launch-weighted means over the shapes. Everything goes to
``time_port_int8_<tag>.json`` in ``chiprun_out/``. It exits non-zero if a
check failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


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
    ap.add_argument("--record", default=str(ROOT / "chiprun_out" / "chip_smoke.json"))
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
    build_s = kernel_lib.build(["int8_conv"])
    torch.backends.cudnn.allow_tf32 = False
    record = json.loads(Path(args.record).read_text())
    shapes = {k["name"]: k["shapes"] for k in record["kernels"]
              if k["name"] in ("int8_conv3x3", "int8_quantize")}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dt = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}
    rows, failures = {"int8_conv3x3": [], "int8_quantize": []}, []

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

    means = {}
    for kernel, rs in rows.items():
        total = sum(r["launches"] for r in rs)
        for key in ("ms", "bound_ms") + (("bf16_conv2d_ms",) if kernel == "int8_conv3x3" else ()):
            means[f"{kernel}_{key}"] = sum(r["launches"] * r[key] for r in rs) / max(total, 1)
    print(f"[{args.tag}] launch-weighted means: "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_port_int8_{args.tag}.json").write_text(json.dumps(
        {"card": card, "root": args.root, "build_s": build_s, "record": args.record, "rows": rows,
         "launch_weighted_means": means, "failures": failures}, indent=1))
    if failures:
        print(f"[{args.tag}] {len(failures)} checks failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
