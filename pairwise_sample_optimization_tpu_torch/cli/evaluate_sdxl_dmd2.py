"""PickaPic-protocol evaluation of SDXL-DMD2 (+ PSO LoRA).

    python -m pairwise_sample_optimization_tpu_torch.cli.evaluate_sdxl_dmd2 \
        [--tiny] [--device cpu] [--prompts_json imagereward] [--max_prompts N] \
        [--model_dir DIR] [--lora_path pytorch_lora_weights.safetensors] \
        [--scorers pickscore,clip,hps,aesthetic,imagereward] [--aesthetic_mlp_path packaged] \
        [--pickscore_dir D] [--clip_dir D] [--hps_path F] [--aesthetic_clip_dir D] \
        [--imagereward_path F] [--wordpiece_vocab vocab.txt] [--output_json FILE] [--timing] \
        [--offload_scorers] [--score_chunk N] [--vae_decode_chunk N] [--gelu_exact] \
        [--hf_dataset SAVE_TO_DISK_DIR --split test_unique --caption_column caption]

Counterpart of the JAX package's ``cli/evaluate_sdxl_dmd2.py``: 4-step DMD2
generation on the fixed lattice [999, 749, 499, 249] at guidance 0, one
image per prompt, each prompt's noise drawn from a generator seeded by
(``--seed``, its global index) so that the batch size never changes an
image; the prompts are sharded round-robin over processes (the last shard
padded, the scores gathered back into dataset order and truncated; one
process today); the images scored by PickScore, CLIP score, HPS, the
LAION aesthetic model and ImageReward; the means reported. It prints the
timing line (with ``--timing``) and then the summary as JSON, and writes
``--output_json`` with ``n_prompts``, ``<scorer>_mean`` and ``per_prompt``.

Weights: the SDXL towers from a local diffusers checkpoint
(``--model_dir``) and the PSO adapter from ``--lora_path``; the scorers'
released weights from ``--pickscore_dir`` and ``--clip_dir`` (HF
``CLIPModel``), ``--hps_path`` (open_clip's ``HPS_v2_compressed.pt``),
``--aesthetic_clip_dir`` (HF CLIP-L/14) and ``--aesthetic_mlp_path``
(``packaged`` = the port's copy of the released MLP), ``--imagereward_path``
(ImageReward-v1.0's ``.pt``). What is not given is random, made from
``--seed`` (the architectures are true). ImageReward tokenizes with a BERT
WordPiece vocabulary (``--wordpiece_vocab``); without one it is skipped,
with a warning. ``--tiny`` selects the toy models at 32x32 (a CPU run of
seconds; ImageReward with a vocabulary of letters); the device is CUDA
unless ``--device cpu`` is given.

Memory options, as the JAX package's: ``--score_chunk N`` generates N
prompts (rounded up to whole batches) before the scorers run over them,
each scorer once a chunk, the images buffered on the device meanwhile (at
most ``SCORE_CHUNK_CAP_BYTES`` of fp32 images: a larger chunk is refused);
``--offload_scorers`` keeps every scorer in pinned host memory but for its
own turn on a chunk; ``--vae_decode_chunk N`` decodes N images a VAE call
(-1: one at a time at 1024^2 and above, else the whole batch);
``--gelu_exact`` takes the exact erf GELU in bf16 too. None of them changes
a score: the images, the scorers' batches and their arithmetic are the same.

Prompts: ``--prompts_json`` (a JSON list or dict of splits, a ``.txt``, or a
packaged set), or ``--hf_dataset``, the ``--caption_column`` of the
``--split`` of a local HuggingFace ``datasets`` ``save_to_disk`` export
(``data/arrow_disk.py``; a hub name needs the network and is refused).
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

from ..checkpoints import (import_lora_safetensors, load_clip_dual, load_clip_vision,
                           load_imagereward)
from ..data import PromptDataset, WordPieceTokenizer, make_clip_tokenizers
from ..device import resolve_device
from ..models.bert import BertConfig
from ..models.clip import CLIPTextConfig, CLIPVisionConfig
from ..models.layers import set_gelu_exact
from ..models.vit import ViTConfig
from ..pipeline import SDXLPipeline
from ..rewards import (AestheticScorer, CLIPScorer, HPSScorer, ImageRewardScorer,
                       PickScoreScorer)
from ..utils import get_logger
from ..utils.offload import HostOffload

logger = get_logger("pso.eval")

SCORERS = ("pickscore", "clip", "hps", "aesthetic", "imagereward")
# the most the fp32 images that --score_chunk buffers may take (85 prompts at 1024^2)
SCORE_CHUNK_CAP_BYTES = 2**30
_SCORER_MODULES = ("model", "vision", "vit", "bert", "mlp")
# the toy ImageReward's vocabulary (--tiny), the JAX package's
TINY_WORDPIECE = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [chr(c) for c in range(97, 123)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true", help="toy models (CPU runs)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--bpe_path", default=os.environ.get("PSO_BPE_PATH", ""))
    p.add_argument("--prompts_json", default="",
                   help='eval prompts: json, newline .txt, or a packaged set ("4k", '
                        '"imagereward"); "" = the built-in 16')
    p.add_argument("--hf_dataset", default="",
                   help="a local HF datasets save_to_disk dir (a hub name needs the network)")
    p.add_argument("--split", default="test_unique")
    p.add_argument("--caption_column", default="caption")
    p.add_argument("--max_prompts", type=int, default=0, help="0 = all")
    p.add_argument("--resolution", type=int, default=0, help="0 = 1024, or 32 with --tiny")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scorers", default="pickscore,clip,aesthetic",
                   help="comma list of " + ",".join(SCORERS))
    p.add_argument("--model_dir", default="", help="local diffusers SDXL checkpoint dir")
    p.add_argument("--lora_path", default="", help="pytorch_lora_weights.safetensors")
    p.add_argument("--pickscore_dir", default="",
                   help="HF CLIPModel dir or file (yuvalkirstain/PickScore_v1)")
    p.add_argument("--clip_dir", default="", help="HF CLIPModel dir or file (laion CLIP-ViT-H-14)")
    p.add_argument("--hps_path", default="", help="HPS_v2_compressed.pt (open_clip layout)")
    p.add_argument("--aesthetic_mlp_path", default="",
                   help='sac+logos+ava1-l14-linearMSE.pth; "packaged" = the port\'s copy')
    p.add_argument("--aesthetic_clip_dir", default="",
                   help="HF CLIPModel dir or file (openai/clip-vit-large-patch14)")
    p.add_argument("--imagereward_path", default="", help="ImageReward-v1.0 .pt checkpoint")
    p.add_argument("--wordpiece_vocab", default="", help="BERT vocab.txt for ImageReward")
    p.add_argument("--clip_resize_max_size", action="store_true",
                   help="open_clip's ResizeMaxSize transform for the CLIP scorer")
    p.add_argument("--output_json", default="")
    p.add_argument("--timing", action="store_true",
                   help="per-batch generation and scoring wall time, each phase ending in a "
                        "device synchronize, and prompts/min")
    p.add_argument("--offload_scorers", action="store_true",
                   help="keep every scorer in pinned host memory but for its own scoring "
                        "calls (the scores do not change)")
    p.add_argument("--score_chunk", type=int, default=0,
                   help="generate N prompts (whole batches) before each scorer runs over them "
                        "once (0: every batch), the images buffered on the device: at most "
                        f"{SCORE_CHUNK_CAP_BYTES / 2**30:g} GiB of fp32 images (N x 3 x H x W x "
                        "4 bytes; 85 prompts at 1024^2), a larger N is refused")
    p.add_argument("--vae_decode_chunk", type=int, default=-1,
                   help="decode N images a VAE call (-1: 1 at 1024^2 and above, else all)")
    p.add_argument("--gelu_exact", action="store_true",
                   help="the exact erf GELU in bf16 too (strict parity with erf scorers)")
    return p.parse_args(argv)


def score_chunk(args, resolution: int) -> int:
    """Prompts a scoring chunk holds: ``--score_chunk`` rounded up to whole
    batches (0: one batch), refused where its fp32 images would pass
    ``SCORE_CHUNK_CAP_BYTES``."""
    bs = args.batch_size
    chunk = -(-args.score_chunk // bs) * bs if args.score_chunk > 0 else bs
    nbytes = chunk * 3 * resolution * resolution * 4
    if args.score_chunk > 0 and nbytes > SCORE_CHUNK_CAP_BYTES:
        raise ValueError(f"--score_chunk {args.score_chunk} would buffer {nbytes / 2**30:.2f} GiB "
                         f"of {resolution}^2 fp32 images; the cap is "
                         f"{SCORE_CHUNK_CAP_BYTES / 2**30:g} GiB "
                         f"({SCORE_CHUNK_CAP_BYTES // (3 * resolution * resolution * 4)} prompts)")
    return chunk


def check_args(args) -> list:
    """The scorer names; an unknown one is refused."""
    wanted = [s for s in args.scorers.split(",") if s]
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
                  aesthetic_mlp_path: str = "", weights=None):
    """The scorers in ``wanted``, each random from its own seed, then loaded
    from ``weights`` (scorer name -> path: ``pickscore``, ``clip`` and
    ``hps`` into the CLIP-H dual encoder, ``aesthetic`` the CLIP-L/14 tower,
    ``imagereward`` the BLIP ViT-L/16, BERT and head) where it names one:
    PickScore, CLIP score and HPS on the CLIP-H dual encoder (ViT-H/14), the
    aesthetic scorer on CLIP-L/14, ImageReward on BLIP. ``tiny``: toy towers
    (the aesthetic one with a 768-wide embedding, so the released MLP
    loads)."""
    dtype = torch.float32 if tiny else torch.bfloat16
    weights = weights or {}
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
        "imagereward": lambda: ImageRewardScorer.random(
            ViTConfig.tiny(dtype) if tiny else ViTConfig.blip_large(dtype),
            BertConfig.tiny(dtype) if tiny else BertConfig.blip_base(dtype), seed=seed + 5,
            device=device),
    }
    load = {
        "pickscore": lambda s, path: load_clip_dual(path, s.model),
        "clip": lambda s, path: load_clip_dual(path, s.model),
        "hps": lambda s, path: load_clip_dual(path, s.model),
        "aesthetic": lambda s, path: load_clip_vision(path, s.vision),
        "imagereward": lambda s, path: load_imagereward(path, s),
    }
    scorers = {}
    for name in wanted:
        scorers[name] = make[name]()
        if weights.get(name):
            load[name](scorers[name], weights[name])
            logger.info("loaded the %s weights from %s", name, weights[name])
    for s in scorers.values():
        for module in scorer_modules(s):
            module.requires_grad_(False)
    return scorers


def scorer_modules(scorer) -> list:
    """The scorer's towers and heads."""
    return [getattr(scorer, n) for n in _SCORER_MODULES if hasattr(scorer, n)]


def imagereward_tokenizer(tiny: bool, vocab_path: str):
    """ImageReward's WordPiece tokenizer: the toy vocabulary under ``tiny``,
    else the BERT ``vocab.txt`` at ``vocab_path``; None without one."""
    if tiny:
        return WordPieceTokenizer(vocab=TINY_WORDPIECE)
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer(vocab_path)
    return None


def _timing_summary(timing, chunk: int):
    # the first scoring chunk (a batch unless --score_chunk) carries every
    # first-call setup; steady state = the rest
    steady = lambda xs: xs[1:] or xs
    chunks, prompts = steady(timing["batch_s"]), steady(timing["batch_prompts"])
    return {
        "first_batch_s": timing["batch_s"][0],
        "steady_batch_s": float(np.mean(chunks)),
        "score_chunk": chunk,
        "prompts_per_min": 60.0 * float(np.sum(prompts)) / float(np.sum(chunks)),
        "gen_s": float(np.mean(steady(timing["gen_s"]))),
        "stage_s": {n: float(np.mean(steady(v))) if v else 0.0
                    for n, v in timing["stage_s"].items()},
        "score_s": {n: float(np.mean(steady(v))) for n, v in timing["score_s"].items()},
    }


def main(argv=None):
    args = parse_args(argv)
    rank, world = 0, 1  # one process: distributed evaluation is not ported yet
    wanted = check_args(args)
    dev = resolve_device(args.device)
    resolution = args.resolution or (32 if args.tiny else 1024)
    chunk = score_chunk(args, resolution)
    set_gelu_exact(args.gelu_exact)

    # ---- prompts, sharded round-robin with the pad math ----
    dataset = PromptDataset(args.prompts_json or None, caption_key=args.caption_column,
                            split=args.split if (args.hf_dataset or args.prompts_json) else None,
                            hf_dataset=args.hf_dataset or None)
    prompts = dataset.prompts
    if args.max_prompts:
        if args.max_prompts > len(prompts):
            warnings.warn(f"--max_prompts {args.max_prompts} exceeds the {len(prompts)} prompts "
                          f"of the source; evaluating all {len(prompts)}", stacklevel=2)
        prompts = prompts[:args.max_prompts]
    n_total = len(prompts)
    shard = shard_prompts(prompts, rank, world)
    per = len(shard)

    # ---- models: the checkpoints given, random weights from the seed otherwise ----
    kw = dict(lora_rank=args.lora_rank, dtype=torch.float32 if args.tiny else torch.bfloat16,
              resolution=resolution, tiny=args.tiny, seed=args.seed, device=dev,
              with_scorer=False)
    if args.model_dir:
        pipe = SDXLPipeline.from_torch_dir(args.model_dir, **kw)
    else:
        logger.warning("no --model_dir: random SDXL towers from seed %d", args.seed)
        pipe = SDXLPipeline.random(**kw)
    if args.lora_path:
        import_lora_safetensors(args.lora_path, pipe.unet)
        logger.info("loaded the PSO LoRA from %s", args.lora_path)
    pipe.decode_chunk = (args.vae_decode_chunk if args.vae_decode_chunk >= 0 else
                         int(resolution >= 1024 and not args.tiny))
    for module in (pipe.unet, pipe.vae, pipe.te1, pipe.te2):
        module.requires_grad_(False)
    ir_tok = imagereward_tokenizer(args.tiny, args.wordpiece_vocab)
    if "imagereward" in wanted and ir_tok is None:
        logger.warning("ImageReward needs --wordpiece_vocab (a BERT vocab.txt); skipping it")
        wanted.remove("imagereward")
    weights = {"pickscore": args.pickscore_dir, "clip": args.clip_dir, "hps": args.hps_path,
               "aesthetic": args.aesthetic_clip_dir, "imagereward": args.imagereward_path}
    scorers = build_scorers(wanted, args.tiny, args.seed, dev, args.clip_resize_max_size,
                            args.aesthetic_mlp_path, weights)
    tok1, tok2, tok_r = make_clip_tokenizers(args.bpe_path, pipe.te1.config.vocab_size,
                                             with_reward=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --offload_scorers: each scorer on the host but for its turn on a chunk
    offloads = {n: HostOffload(scorer_modules(s)) for n, s in scorers.items()}
    if args.offload_scorers:
        for o in offloads.values():
            o.to_host()

    # ---- generation + scoring, each prompt's noise keyed by its global index;
    # a chunk's batches are generated first, then each scorer runs over them ----
    results = {name: [] for name in scorers}
    timing = None
    if args.timing:
        timing = {"batch_s": [], "batch_prompts": [], "gen_s": [],
                  "stage_s": {n: [] for n in scorers}, "score_s": {n: [] for n in scorers}}
    bs = args.batch_size
    ids = lambda tok, batch: torch.as_tensor(tok(batch), dtype=torch.long, device=dev)
    with torch.no_grad():
        for cstart in range(0, per, chunk):
            t_chunk = time.perf_counter()
            buffered = []  # per batch: (images, prompts)
            for start in range(cstart, min(cstart + chunk, per), bs):
                batch = shard[start:start + bs]
                batch = batch + [batch[-1]] * (bs - len(batch))
                t_gen = time.perf_counter()
                cond = pipe.encode_prompt(ids(tok1, batch), ids(tok2, batch))
                gens = [prompt_generator(args.seed, rank + world * (start + j), dev)
                        for j in range(bs)]
                buffered.append((pipe.generate_dmd(cond, num_steps=args.num_steps,
                                                   sample_generators=gens), batch))
                if timing is not None:
                    sync()
                    timing["gen_s"].append(time.perf_counter() - t_gen)
            for name, scorer in scorers.items():
                t_stage = time.perf_counter()
                if args.offload_scorers:
                    offloads[name].to_device()
                    if timing is not None:
                        sync()
                        timing["stage_s"][name].append(time.perf_counter() - t_stage)
                t_score = time.perf_counter()
                for images, batch in buffered:
                    if name == "aesthetic":
                        s = scorer.score(images)
                    elif name == "imagereward":
                        s = scorer.score(images, *(torch.as_tensor(a, dtype=torch.long,
                                                                   device=dev)
                                                   for a in ir_tok(batch)))
                    else:
                        s = scorer.score(images, ids(tok_r, batch))
                    results[name].append(s.float().cpu().numpy())
                if timing is not None:
                    timing["score_s"][name].append(time.perf_counter() - t_score)
                if args.offload_scorers:
                    offloads[name].to_host()
            if timing is not None:
                timing["batch_s"].append(time.perf_counter() - t_chunk)
                timing["batch_prompts"].append(min(chunk, per - cstart))  # pads not counted
            done = min(cstart + chunk, per)
            if chunk > bs or done % (10 * bs) < bs or done == per:
                logger.info("[%d/%d] prompts evaluated", done, per)

    # ---- gather (one process: the shard itself) -> dataset order -> means ----
    summary, per_prompt = {}, {}
    for name, chunks in results.items():
        local = np.concatenate(chunks)[:per]
        gathered = gather_round_robin([local], n_total)
        per_prompt[name] = [float(x) for x in gathered]
        summary[f"{name}_mean"] = float(np.mean(gathered))
        logger.info("%s on eval set: %.8f", name, summary[f"{name}_mean"])
    timing_summary = _timing_summary(timing, chunk) if timing and timing["batch_s"] else None
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
