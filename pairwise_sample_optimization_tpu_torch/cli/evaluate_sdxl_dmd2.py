"""PickaPic-protocol evaluation of SDXL-DMD2 (+ PSO LoRA).

    python -m pairwise_sample_optimization_tpu_torch.cli.evaluate_sdxl_dmd2 \
        [--tiny] [--device cpu] [--prompts_json imagereward] [--max_prompts N] \
        [--scorers pickscore,clip,hps,aesthetic] [--aesthetic_mlp_path packaged] \
        [--output_json FILE] [--timing]

Counterpart of the JAX package's ``cli/evaluate_sdxl_dmd2.py``: 4-step DMD2
generation on the fixed lattice [999, 749, 499, 249] at guidance 0, one
image per prompt, each prompt's noise drawn from a generator seeded by
(``--seed``, its global index) so that the batch size never changes an
image; the prompts are sharded round-robin over processes (the last shard
padded, the scores gathered back into dataset order and truncated; one
process today); the images scored by PickScore, CLIP score, HPS and the
LAION aesthetic model; the means reported. It prints the timing line (with
``--timing``) and then the summary as JSON, and writes ``--output_json``
with ``n_prompts``, ``<scorer>_mean`` and ``per_prompt``.

Weights are random, made from ``--seed`` (the towers' architectures are
true; the aesthetic MLP can be the released one, ``--aesthetic_mlp_path
packaged``). ``--tiny`` selects the toy models at 32x32 (a CPU run of
seconds); the device is CUDA unless ``--device cpu`` is given.

Not ported yet, and refused when asked for: pretrained weights
(``--model_dir``, the scorer weight paths), ``--lora_path``, HF datasets,
the ImageReward scorer, the JAX package's scorer offload and chunking
(``--offload_scorers``, ``--score_chunk``, ``--vae_decode_chunk``) and
``--gelu_exact``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

from ..data import PromptDataset, make_clip_tokenizers
from ..device import resolve_device
from ..models.clip import CLIPTextConfig, CLIPVisionConfig
from ..pipeline import SDXLPipeline
from ..rewards import AestheticScorer, CLIPScorer, HPSScorer, PickScoreScorer
from ..utils import get_logger

logger = get_logger("pso.eval")

SCORERS = ("pickscore", "clip", "hps", "aesthetic")
# flag -> its default; any other value is refused until the port has it
_UNPORTED = {
    "model_dir": "", "lora_path": "", "hf_dataset": "", "pickscore_dir": "", "clip_dir": "",
    "hps_path": "", "aesthetic_clip_dir": "", "imagereward_path": "", "wordpiece_vocab": "",
    "offload_scorers": False, "score_chunk": 0, "vae_decode_chunk": -1, "gelu_exact": False,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true", help="toy models (CPU runs)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--bpe_path", default=os.environ.get("PSO_BPE_PATH", ""))
    p.add_argument("--prompts_json", default="",
                   help='eval prompts: json, newline .txt, or a packaged set ("4k", '
                        '"imagereward"); "" = the built-in 16')
    p.add_argument("--split", default="test_unique")
    p.add_argument("--caption_column", default="caption")
    p.add_argument("--max_prompts", type=int, default=0, help="0 = all")
    p.add_argument("--resolution", type=int, default=0, help="0 = 1024, or 32 with --tiny")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scorers", default="pickscore,clip,aesthetic",
                   help="comma list of " + ",".join(SCORERS))
    p.add_argument("--aesthetic_mlp_path", default="",
                   help='sac+logos+ava1-l14-linearMSE.pth; "packaged" = the port\'s copy')
    p.add_argument("--clip_resize_max_size", action="store_true",
                   help="open_clip's ResizeMaxSize transform for the CLIP scorer")
    p.add_argument("--output_json", default="")
    p.add_argument("--timing", action="store_true",
                   help="per-batch generation and scoring wall time, each phase ending in a "
                        "device synchronize, and prompts/min")
    # not ported yet: parsed so launch scripts parse, refused unless default
    for flag in ("model_dir", "lora_path", "hf_dataset", "pickscore_dir", "clip_dir", "hps_path",
                 "aesthetic_clip_dir", "imagereward_path", "wordpiece_vocab"):
        p.add_argument(f"--{flag}", default="", help="not ported yet")
    p.add_argument("--offload_scorers", action="store_true", help="not ported yet")
    p.add_argument("--gelu_exact", action="store_true", help="not ported yet")
    p.add_argument("--score_chunk", type=int, default=0, help="not ported yet")
    p.add_argument("--vae_decode_chunk", type=int, default=-1, help="not ported yet")
    return p.parse_args(argv)


def check_args(args) -> list:
    """Refuse what the port does not implement; returns the scorer names."""
    for flag, default in _UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag} is not ported yet")
    wanted = [s for s in args.scorers.split(",") if s]
    if "imagereward" in wanted:
        raise NotImplementedError("the ImageReward scorer is not ported yet")
    unknown = [s for s in wanted if s not in SCORERS]
    if unknown or not wanted:
        raise ValueError(f"unknown scorers {unknown}; have {SCORERS}")
    return wanted


def shard_prompts(prompts, rank: int, world: int):
    """Round-robin shard of ``prompts`` for process ``rank``, padded with its
    last prompt to ceil(n / world) so every process runs as many batches."""
    shard = list(prompts[rank::world])
    per = -(-len(prompts) // world)
    while len(shard) < per:
        shard.append(shard[-1] if shard else "")
    return shard


def gather_round_robin(shards, n_total: int) -> np.ndarray:
    """Inverse of :func:`shard_prompts`: per-rank score arrays (each of the
    padded shard length) -> scores in dataset order, pads dropped."""
    world = len(shards)
    return np.asarray([shards[i % world][i // world] for i in range(n_total)])


def prompt_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of the prompt at global ``index``: its noise depends on
    (seed, index) only."""
    state = int(np.random.SeedSequence([seed, index]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def build_scorers(wanted, tiny: bool, seed: int, device, clip_max_size: bool = False,
                  aesthetic_mlp_path: str = ""):
    """Random-weight scorers, each from its own seed: PickScore, CLIP score
    and HPS on the CLIP-H dual encoder (ViT-H/14), the aesthetic scorer on
    CLIP-L/14. ``tiny``: toy towers (the aesthetic one with a 768-wide
    embedding, so the released MLP loads)."""
    dtype = torch.float32 if tiny else torch.bfloat16
    text = CLIPTextConfig.tiny(dtype) if tiny else CLIPTextConfig.vit_h14(dtype)
    vision = CLIPVisionConfig.tiny(dtype) if tiny else CLIPVisionConfig.vit_h14(dtype)
    aes_vision = (dataclasses.replace(CLIPVisionConfig.tiny(dtype), projection_dim=768)
                  if tiny else CLIPVisionConfig.vit_l14(dtype))
    make = {
        "pickscore": lambda: PickScoreScorer.random(text, vision, seed=seed + 1, device=device),
        "clip": lambda: CLIPScorer.random(text, vision, seed=seed + 2, device=device,
                                          preprocess="max_size" if clip_max_size else "resize"),
        "hps": lambda: HPSScorer.random(text, vision, seed=seed + 3, device=device),
        "aesthetic": lambda: AestheticScorer.random(aes_vision, seed=seed + 4,
                                                    mlp_path=aesthetic_mlp_path, device=device),
    }
    scorers = {name: make[name]() for name in wanted}
    for s in scorers.values():
        for module in ((s.vision, s.mlp) if isinstance(s, AestheticScorer) else (s.model,)):
            module.requires_grad_(False)
    return scorers


def _timing_summary(timing):
    # the first batch carries every first-call setup; steady state = the rest
    steady = lambda xs: xs[1:] or xs
    batches, prompts = steady(timing["batch_s"]), steady(timing["batch_prompts"])
    return {
        "first_batch_s": timing["batch_s"][0],
        "steady_batch_s": float(np.mean(batches)),
        "prompts_per_min": 60.0 * float(np.sum(prompts)) / float(np.sum(batches)),
        "gen_s": float(np.mean(steady(timing["gen_s"]))),
        "score_s": {n: float(np.mean(steady(v))) for n, v in timing["score_s"].items()},
    }


def main(argv=None):
    args = parse_args(argv)
    rank, world = 0, 1  # one process: distributed evaluation is not ported yet
    wanted = check_args(args)
    dev = resolve_device(args.device)
    resolution = args.resolution or (32 if args.tiny else 1024)

    # ---- prompts, sharded round-robin with the pad math ----
    dataset = PromptDataset(args.prompts_json or None, caption_key=args.caption_column,
                            split=args.split if args.prompts_json else None)
    prompts = dataset.prompts
    if args.max_prompts:
        if args.max_prompts > len(prompts):
            warnings.warn(f"--max_prompts {args.max_prompts} exceeds the {len(prompts)} prompts "
                          f"of the source; evaluating all {len(prompts)}", stacklevel=2)
        prompts = prompts[:args.max_prompts]
    n_total = len(prompts)
    shard = shard_prompts(prompts, rank, world)
    per = len(shard)

    # ---- models (random weights from the seed) ----
    logger.warning("no pretrained weights -- random towers from seed %d", args.seed)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    pipe = SDXLPipeline.random(lora_rank=args.lora_rank, dtype=dtype, resolution=resolution,
                               tiny=args.tiny, seed=args.seed, device=dev, with_scorer=False)
    for module in (pipe.unet, pipe.vae, pipe.te1, pipe.te2):
        module.requires_grad_(False)
    scorers = build_scorers(wanted, args.tiny, args.seed, dev, args.clip_resize_max_size,
                            args.aesthetic_mlp_path)
    tok1, tok2, tok_r = make_clip_tokenizers(args.bpe_path, pipe.te1.config.vocab_size,
                                             with_reward=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- generation + scoring, each prompt's noise keyed by its global index ----
    results = {name: [] for name in scorers}
    timing = None
    if args.timing:
        timing = {"batch_s": [], "batch_prompts": [], "gen_s": [],
                  "score_s": {n: [] for n in scorers}}
    bs = args.batch_size
    ids = lambda tok, batch: torch.as_tensor(tok(batch), dtype=torch.long, device=dev)
    with torch.no_grad():
        for start in range(0, per, bs):
            batch = shard[start:start + bs]
            batch = batch + [batch[-1]] * (bs - len(batch))
            t_batch = time.perf_counter()
            cond = pipe.encode_prompt(ids(tok1, batch), ids(tok2, batch))
            gens = [prompt_generator(args.seed, rank + world * (start + j), dev)
                    for j in range(bs)]
            images = pipe.generate_dmd(cond, num_steps=args.num_steps, sample_generators=gens)
            if timing is not None:
                sync()
                timing["gen_s"].append(time.perf_counter() - t_batch)
            reward_ids = ids(tok_r, batch)
            for name, scorer in scorers.items():
                t_score = time.perf_counter()
                s = scorer.score(images) if name == "aesthetic" else scorer.score(images,
                                                                                  reward_ids)
                results[name].append(s.float().cpu().numpy())
                if timing is not None:
                    timing["score_s"][name].append(time.perf_counter() - t_score)
            if timing is not None:
                timing["batch_s"].append(time.perf_counter() - t_batch)
                timing["batch_prompts"].append(min(bs, per - start))  # pads not counted
            done = min(start + bs, per)
            if done % (10 * bs) < bs or done == per:
                logger.info("[%d/%d] prompts evaluated", done, per)

    # ---- gather (one process: the shard itself) -> dataset order -> means ----
    summary, per_prompt = {}, {}
    for name, chunks in results.items():
        local = np.concatenate(chunks)[:per]
        gathered = gather_round_robin([local], n_total)
        per_prompt[name] = [float(x) for x in gathered]
        summary[f"{name}_mean"] = float(np.mean(gathered))
        logger.info("%s on eval set: %.8f", name, summary[f"{name}_mean"])
    timing_summary = _timing_summary(timing) if timing and timing["batch_s"] else None
    if timing_summary:
        logger.info("timing: %s", timing_summary)

    if rank == 0 and args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"n_prompts": n_total, **summary,
                       **({"timing": timing_summary} if timing_summary else {}),
                       "per_prompt": {"prompts": prompts, **per_prompt}}, f, indent=2)
    if timing_summary:
        print(json.dumps({"timing": timing_summary}))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
