"""Text-to-image generation with the SDXL-Turbo or SDXL-DMD2 sampler.

    python -m pairwise_sample_optimization_tpu_torch.cli.generate \
        --prompt "a corgi on a beach" [--prompt ...] [--model_dir DIR] \
        [--lora_path pytorch_lora_weights.safetensors] [--sampler turbo|dmd] \
        [--num_steps 4] [--resolution 512] [--seed 0] [--out generated] \
        [--tiny] [--device cpu]

Counterpart of the JAX package's ``cli/generate.py``: one image per prompt,
written as ``<out>/000.png``, ``001.png``, ... . The weights come from a
local diffusers checkpoint (``--model_dir``, through
``SDXLPipeline.from_torch_dir``), else they are random from ``--seed``,
with a warning; ``--lora_path`` loads a diffusers or peft LoRA file into the
UNet (``checkpoints.import_lora_safetensors``). ``--sampler turbo`` is
SDXL-Turbo's Euler-ancestral sampler, ``dmd`` SDXL-DMD2's fixed lattice.
``--tiny`` selects the toy models at 32x32 (a CPU run of seconds); the
device is CUDA unless ``--device cpu`` is given. The PNGs are written with
the standard library (the JAX package falls back to ``images.npy`` where
PIL is missing; the port never needs to).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..checkpoints import import_lora_safetensors
from ..data import make_clip_tokenizers
from ..device import resolve_device
from ..pipeline import SDXLPipeline
from ..utils import get_logger
from ..utils.png import save_pngs

logger = get_logger("pso.generate")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", default="", help="local diffusers SDXL checkpoint dir")
    p.add_argument("--lora_path", default="", help="pytorch_lora_weights.safetensors")
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--bpe_path", default=os.environ.get("PSO_BPE_PATH", ""))
    p.add_argument("--prompt", action="append", required=True,
                   help="repeatable; one image per prompt")
    p.add_argument("--sampler", choices=["turbo", "dmd"], default="turbo")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--resolution", type=int, default=0, help="0 = 512, or 32 with --tiny")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="generated")
    p.add_argument("--tiny", action="store_true", help="toy models (CPU runs)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(lora_rank=args.lora_rank, dtype=torch.float32 if args.tiny else torch.bfloat16,
              resolution=args.resolution or (32 if args.tiny else 512), tiny=args.tiny,
              seed=args.seed, device=dev, with_scorer=False)
    if args.model_dir:
        pipe = SDXLPipeline.from_torch_dir(args.model_dir, **kw)
    else:
        logger.warning("no --model_dir: random weights from seed %d", args.seed)
        pipe = SDXLPipeline.random(**kw)
    if args.lora_path:
        import_lora_safetensors(args.lora_path, pipe.unet)
        logger.info("loaded the LoRA from %s", args.lora_path)
    tok1, tok2 = make_clip_tokenizers(args.bpe_path, pipe.te1.config.vocab_size)
    ids = lambda tok: torch.as_tensor(tok(args.prompt), dtype=torch.long, device=dev)
    cond = pipe.encode_prompt(ids(tok1), ids(tok2))
    generate = pipe.generate if args.sampler == "turbo" else pipe.generate_dmd
    images = generate(cond, torch.Generator(device=dev).manual_seed(args.seed),
                      num_steps=args.num_steps)
    paths = save_pngs(images, args.out, name="{i:03d}.png")
    for path in paths:
        logger.info("wrote %s", path)
    return paths


if __name__ == "__main__":
    main()
