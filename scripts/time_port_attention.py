#!/usr/bin/env python3
"""Check and time the port's bf16 flash-attention kernels (K1 forward, K2
dK/dV, K3 dQ) at the online loop's attention shapes and the ragged lengths
of ``chip_smoke.RAGGED`` and ``chip_smoke.RAGGED_FWD``, on one CUDA card.

    python3 scripts/time_port_attention.py [--root DIR] [--tag NAME] [--seed N]

``--root`` is the checkout whose ``pairwise_sample_optimization_tpu_torch``
is imported and built (default: this one), so that two versions of the
kernels can be timed in one call on one card, in turns (parent, change,
change, parent). The limits, the timer and the bound are this checkout's
``chip_smoke.py`` (``fwd_tolerance``, ``grad_tolerance``, ``timed_ms``,
``bound``). At head dim 64 it runs K1, K2 and K3; at PickScore's 80 and the
VAE's 512 (forward only) K1. For each shape it prints each kernel's share
of its limit, its CUDA-event device ms beside the bound, SDPA's forward
beside K1 and SDPA's backward (autograd, dQ + dK + dV) beside K2 + K3, and
launch-weighted means over the loop's shapes; everything goes to
``time_port_attention_<tag>.json`` in the output directory that
``chip_smoke.py`` writes its record to. It exits non-zero if any check
failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (q (B, S, H, D), kv length, launches per epoch of the online loop: K1, K2 = K3)
MAIN_PATH = (((8, 1024, 10, 64), 1024, 520, 120), ((8, 1024, 10, 64), 77, 520, 120),
             ((8, 256, 20, 64), 256, 3120, 720), ((8, 256, 20, 64), 77, 3120, 720),
             ((8, 257, 16, 80), 257, 128, 0), ((8, 4096, 1, 512), 4096, 4, 0))


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
    build_s = kernel_lib.build(["flash_attn_fwd", "flash_attn_bwd"])
    ptxas = []
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        for line in kernel_lib._lib_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                ptxas.append(f"{name}: {line.strip()}")
    print(f"[{args.tag}] built in {build_s}", *ptxas, sep="\n  ", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16
    cases = list(MAIN_PATH) + [(qs, skv, 0, 0) for qs, skv in cs.RAGGED + cs.RAGGED_FWD]
    rows, failures = [], []

    def held(what, got, want, tol):
        try:
            cs.check_close(what, got, want, tol)
        except AssertionError as e:
            failures.append(str(e))
            print(f"[{args.tag}] FAILED {e}", flush=True)

    for qs, skv, launches, bwd_launches in cases:
        b, sq, h, d = qs
        ks = (b, skv, h, d)
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=bf16) for s in (qs, ks, ks))
        o, lse = tfa.flash_attention_fwd(q, k, v)
        o_p, lse_p = tfa.flash_attention_plain(q, k, v)
        name = f"q{qs} kv {skv}"
        tol_o = cs.fwd_tolerance(o_p)
        held(f"K1 o {name}", o, o_p, tol_o)
        held(f"K1 lse {name}", lse, lse_p, cs.TOL["attention_lse"])
        used = {"k1_o": cs.tolerance_used(o, o_p, tol_o),
                "k1_lse": cs.tolerance_used(lse, lse_p, cs.TOL["attention_lse"])}
        del o_p, lse_p
        el, pair = q.element_size(), 2 * b * h * sq * skv * d
        inputs = el * (2 * q.numel() + 2 * k.numel())
        k1_bound = cs.bound(inputs + 4 * lse.numel(), 2 * pair, "bf16")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "q": list(qs), "kv": skv, "launches": launches, "bwd_launches": bwd_launches,
            "tolerance_used": used,
            "k1_ms": cs.timed_ms(lambda: tfa.flash_attention_fwd(q, k, v)),
            "sdpa_fwd_ms": cs.timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
        }
        line = (f"K1 {row['k1_ms']:.4f} ms (bound {k1_bound[0]:.4f} {k1_bound[1]}), "
                f"SDPA fwd {row['sdpa_fwd_ms']:.4f}")
        if d in tfa.BWD_HEAD_DIMS:
            do = torch.randn(qs, generator=gen, device="cuda", dtype=bf16)
            di = tfa.attention_di(o, do)
            dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, di)
            dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, di)
            want = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)))
            got = {"dq": dq, "dk": dk, "dv": dv}
            tol = {n: cs.grad_tolerance(n, w, skv) for n, w in want.items()}
            for n in got:
                held(f"{n} {name}", got[n], want[n], tol[n])
            used.update({n: cs.tolerance_used(got[n], want[n], tol[n]) for n in got})
            k2_bound = cs.bound(inputs + 8 * lse.numel() + el * 2 * k.numel(), 4 * pair, "bf16")
            k3_bound = cs.bound(inputs + 8 * lse.numel() + el * q.numel(), 3 * pair, "bf16")
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
            out = F.scaled_dot_product_attention(qg, kg, vg)
            dot = do.transpose(1, 2)
            row.update({
                "k2_ms": cs.timed_ms(lambda: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, di)),
                "k3_ms": cs.timed_ms(lambda: tfa.flash_attention_bwd_dq(q, k, v, do, lse, di)),
                "sdpa_bwd_ms": cs.timed_ms(
                    lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)),
                "k2_bound_ms": k2_bound[0], "k2_bound_by": k2_bound[1],
                "k3_bound_ms": k3_bound[0], "k3_bound_by": k3_bound[1],
            })
            line += (f", K2 {row['k2_ms']:.4f} (bound {k2_bound[0]:.4f}), K3 {row['k3_ms']:.4f} "
                     f"(bound {k3_bound[0]:.4f} {k3_bound[1]}), K2+K3 "
                     f"{row['k2_ms'] + row['k3_ms']:.4f}, SDPA bwd {row['sdpa_bwd_ms']:.4f}")
            del out, qg, kg, vg
        rows.append(row)
        print(f"[{args.tag}] {name}: {line}; share of limit used "
              + ", ".join(f"{n} {u:.3f}" for n, u in used.items()), flush=True)

    def mean(key, weight, subset):
        return sum(r[key] * r[weight] for r in subset) / sum(r[weight] for r in subset)

    means = {}
    for d in sorted({r["q"][3] for r in rows if r["launches"]}):
        at_d = [r for r in rows if r["q"][3] == d and r["launches"]]
        means.update({f"d{d}_{key}": mean(key, "launches", at_d)
                      for key in ("k1_ms", "k1_bound_ms", "sdpa_fwd_ms")})
    on_path = [r for r in rows if r["launches"]]
    means.update({f"all_{key}": mean(key, "launches", on_path)
                  for key in ("k1_ms", "k1_bound_ms", "sdpa_fwd_ms")})
    bwd = [r for r in rows if r["bwd_launches"]]
    means.update({key: mean(key, "bwd_launches", bwd)
                  for key in ("k2_ms", "k2_bound_ms", "k3_ms", "k3_bound_ms", "sdpa_bwd_ms")})
    print(f"[{args.tag}] launch-weighted means over the loop's shapes: "
          + ", ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_port_attention_{args.tag}.json").write_text(json.dumps(
        {"card": card, "root": args.root, "build_s": build_s, "ptxas": ptxas, "rows": rows,
         "launch_weighted_means": means, "failures": failures}, indent=1))
    if failures:
        print(f"[{args.tag}] {len(failures)} checks failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
