"""DreamBooth (offline) PSO on SDXL-Turbo.

    python -m pairwise_sample_optimization_tpu_torch.cli.train_pso_sdxl_turbo_dreambooth \
        --instance_data_dir DIR_OF_PNGS --instance_prompt "a photo of sks dog" \
        --class_prompt "a photo of dog" [--max_train_steps 1600] [--tiny] [--device cpu]

Counterpart of the JAX package's ``cli/train_pso_sdxl_turbo_dreambooth.py``
with its flags and defaults, plus ``--device`` (CUDA unless ``cpu`` is
given; without a card a CUDA run raises). The winners are the user's
instance images; the losers are images the model generates for the class
prompt at step 0 (4-step Turbo, ``--sample_batch_size`` at a time, trimmed to
``--num_negatives``). Instance, negative and class images are encoded once
into VAE moments (``--sample_batch_size`` images a call); each step draws
latents mean + exp(logvar / 2) n, times the VAE's scaling factor, for the
picks of numpy's ``default_rng`` seeded from (seed, s) at step s; the
lattice indices, the noise and the latent draws of step s come from a
``torch.Generator`` on the device seeded from (seed, s). Every draw of a
step is a function of the seed and the step, so a run resumed from a
checkpoint continues as the uninterrupted run would have. This departs
from the JAX CLI on purpose: it seeds one ``default_rng(seed + start_step)``
per run, so for the same seed the port picks other instances and
negatives than the JAX CLI does, and a resumed JAX run draws other picks
than its uninterrupted run.

Data-parallel (``torchrun --nproc_per_node=N``, one card a rank): each rank
draws its own picks, latents, lattice indices and noise (rank 0 the
one-process run's; the others from seeds that take their rank, as the JAX
CLI offsets its picks per process), the gradients are averaged over the
ranks before the clip, and ``--scale_lr`` multiplies by the world size too.
Every rank makes the same negatives and encode caches; rank 0 alone
generates the class images, writes checkpoints, LoRA files and metrics,
and validates, the other ranks waiting for it.

- ``--with_prior_preservation`` with ``--class_data_dir``: class images are
  generated into the directory as PNGs until it holds
  ``--num_class_images``; they join the win half with the class prompt;
- steps: ``--max_train_steps``, else ``--num_train_epochs`` times
  ceil(instance images x ``--repeats`` / (batch x accumulation));
- adapters: LoRA of ``--rank`` on the UNet's attention projections;
  ``--use_dora`` makes them DoRA (a trainable magnitude per output; the
  ``pso`` reference pass then runs as its own forward at a static LoRA
  scale of 0); ``--train_text_encoder`` also trains a LoRA (DoRA) of the
  same rank on both text encoders' attention projections, the prompts
  encoded anew with gradients in every microbatch, at
  ``--text_encoder_lr`` with ``--adam_weight_decay_text_encoder``;
- the optimizer (``make_dreambooth_optimizer``, the JAX CLI's
  ``_make_optimizer``): one global-norm clip at ``--max_grad_norm`` over
  every trained tensor, then AdamW (``--use_8bit_adam``: the 8-bit one),
  the UNet and the text encoders in two groups when their learning rates
  or weight decays differ, with the six diffusers schedules
  (``--lr_scheduler``); or ``--optimizer prodigy`` over all of them at
  ``--learning_rate`` (the text encoders' lr is overridden), a
  non-constant schedule multiplying its update; ``--scale_lr`` multiplies
  the learning rates by accumulation x batch x world size;
- checkpoints every ``--checkpointing_steps`` and at the last step:
  ``checkpoint-<step>/`` (the train state) and
  ``lora-<step>/pytorch_lora_weights.safetensors`` (diffusers layout, every
  trained adapter; ``--output_kohya_format`` adds
  ``pytorch_lora_weights_kohya.safetensors``),
  ``--checkpoints_total_limit`` of them kept; ``--resume_from_checkpoint
  DIR|latest``;
- validation every ``--validation_steps``: the 25 fixed prompts,
  ``--num_validation_images`` each, under ``gen_<step>/p_XXX/``, encoded
  through the live text-encoder adapters;
- ``--gradient_checkpointing`` rematerializes UNet blocks in the backward,
  as ``--gradient_checkpointing_mode`` says (``full``, or a selective mode
  of ``models/unet.py``);
- ``--tiny``: the toy models at 32x32 (unless ``--resolution`` is given),
  fp32, a CPU run of seconds. Otherwise SDXL-Turbo's widths in bf16 with an
  fp32 LoRA, from ``--pretrained_model_dir`` (a local diffusers
  checkpoint) or random weights from ``--seed`` (zero-filled, the LoRA
  too, under ``--fast_init``: for throughput and compile checks).

``--use_wandb`` logs to wandb too where it imports and starts (else a
warning, and ``metrics.jsonl`` alone), as the JAX CLI does.

Refused before any model is built, with ``NotImplementedError``: JPEG,
WebP and BMP files in the instance or class directory (the port reads
PNG). The
JAX CLI's parity-inert flags (``--snr_gamma``, ``--gamma_pso``,
``--neg_generate_freq``) are accepted and do nothing, as there.

The train state's LoRA parameters keep the UNet's names; the text
encoders' are prefixed ``te1.`` / ``te2.``. ``main`` returns
``(state, history, pipeline)``: history holds each step's
metrics (``loss``, ``win_loss``, ``lose_loss``, ``implicit_acc`` and its
synchronized wall time ``time/step_s``). ``metrics.jsonl`` gets the metrics
of the first step and every tenth, the set-up times (``time/encode_s``,
``time/negatives_s``, ``time/class_images_s``) and each validation's
``time/validation_s``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..checkpoints import (KOHYA_FILE, LORA_FILE, export_kohya_lora_safetensors,
                           export_sdxl_lora_safetensors, latest_checkpoint, prune_checkpoints,
                           restore_train_state, save_train_state)
from ..data import make_clip_tokenizers
from ..data.dreambooth import DreamBoothDataset, image_files
from ..device import resolve_device
from ..models.sdxl_text import compute_time_ids, time_ids_from_records
from ..parallel import (barrier, broadcast_train_state_, maybe_initialize_distributed, rank,
                        rank_entropy, shutdown_distributed, world_size)
from ..pipeline import SDXLPipeline
from ..train import (DreamBoothPSOConfig, DreamBoothPSOTrainer, PSOTrainState, lora_parameters,
                     make_lr_schedule, make_optimizer)
from ..train.db_validation import dreambooth_validation_prompts, run_dreambooth_validation
from ..train.dreambooth_pso import sample_lattice_timesteps
from ..train.prodigy import Prodigy
from ..utils import MetricLogger, PhaseTimer, get_logger
from ..utils.png import save_pngs

logger = get_logger("pso.dreambooth")

TINY_RESOLUTION = 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # model / data
    p.add_argument("--pretrained_model_dir", default="")
    p.add_argument("--bpe_path", default=os.environ.get("PSO_BPE_PATH", ""))
    p.add_argument("--instance_data_dir", required=True)
    p.add_argument("--instance_prompt", required=True)
    p.add_argument("--class_prompt", default="")
    p.add_argument("--output_dir", default="dreambooth-pso-output")
    p.add_argument("--resolution", type=int, default=None,
                   help="default 512 (32 with --tiny)")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--center_crop", action="store_true",
                   help="center crop instead of the default random crops")
    p.add_argument("--random_flip", action="store_true")
    # train
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale the lr by accumulation x batch x world size")
    p.add_argument("--text_encoder_lr", type=float, default=5e-6)
    p.add_argument("--train_text_encoder", action="store_true",
                   help="also train a LoRA on both text encoders")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="default: num_train_epochs x steps per epoch")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--rank", type=int, default=16, help="LoRA rank")
    p.add_argument("--use_dora", action="store_true", help="weight-decomposed LoRA (DoRA)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="rematerialize every UNet block in the backward")
    p.add_argument("--gradient_checkpointing_mode", default="full",
                   choices=["full", "resnets", "dots", "lowres", "lowres_dots"],
                   help="the remat mode under --gradient_checkpointing (models/unet.py)")
    p.add_argument("--seed", type=int, default=0)
    # optimizer
    p.add_argument("--optimizer", default="AdamW", help='"AdamW" or "prodigy" (any case)')
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="AdamW with block-quantized int8 moments")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--adam_weight_decay_text_encoder", type=float, default=1e-3)
    p.add_argument("--prodigy_beta3", type=float, default=None, help="default sqrt(beta2)")
    p.add_argument("--prodigy_decouple", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--prodigy_use_bias_correction", type=lambda s: s.lower() != "false",
                   default=True)
    p.add_argument("--prodigy_safeguard_warmup", type=lambda s: s.lower() != "false",
                   default=True)
    # lr schedule
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear", "cosine",
                            "cosine_with_restarts", "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    # prior preservation
    p.add_argument("--with_prior_preservation", action="store_true",
                   help="class images from --class_data_dir (generated there when fewer "
                        "than --num_class_images) join the win half with the class prompt")
    p.add_argument("--class_data_dir", default="")
    p.add_argument("--num_class_images", type=int, default=100)
    p.add_argument("--sample_batch_size", type=int, default=4,
                   help="images a call when generating and encoding")
    p.add_argument("--resume_from_checkpoint", default="",
                   help="a checkpoint dir, or 'latest' to take the newest in output_dir")
    # scheduler space
    p.add_argument("--scheduler_space", choices=["euler_edm", "edm", "ddpm"],
                   default="euler_edm")
    p.add_argument("--prediction_type", choices=["epsilon", "v_prediction"], default="epsilon")
    p.add_argument("--direct_timestep_indexing", action="store_true",
                   help="lattice values as timesteps instead of the descending-table indexing")
    # PSO
    p.add_argument("--loss_type", choices=["pso", "pso_db"], default="pso_db")
    p.add_argument("--beta_pso", type=float, default=5.0)
    p.add_argument("--neg_defactor", type=float, default=1.0)
    p.add_argument("--num_negatives", type=int, default=20)
    p.add_argument("--prior_loss_weight", type=float, default=0.5)
    p.add_argument("--distill_train_timesteps", type=int, default=4)
    # checkpoints and validation
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--validation_steps", type=int, default=500)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--unique_token", default="sks")
    p.add_argument("--class_name", default="",
                   help="default: the last word of --class_prompt")
    p.add_argument("--is_object", action="store_true",
                   help="the object prompt list (else the live-subject list)")
    p.add_argument("--skip_validation", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--output_kohya_format", action="store_true",
                   help="also export the LoRA in kohya-ss's layout")
    p.add_argument("--tiny", action="store_true", help="toy models (CPU runs)")
    p.add_argument("--fast_init", action="store_true",
                   help="zero-fill the weights instead of drawing them when there is no "
                        "--pretrained_model_dir (throughput and compile checks)")
    p.add_argument("--device", default="cuda")
    # parity-inert, as in the JAX CLI
    p.add_argument("--snr_gamma", type=float, default=None, help="parity-inert")
    p.add_argument("--gamma_pso", type=float, default=1.0, help="parity-inert")
    p.add_argument("--neg_generate_freq", type=int, default=800, help="parity-inert")
    return p.parse_args(argv)


def check_args(args) -> None:
    """Refuse an optimizer the port does not implement."""
    if args.optimizer.lower() not in ("adamw", "prodigy"):
        raise ValueError(f"Unsupported optimizer {args.optimizer!r}: choose AdamW or prodigy")


def make_dreambooth_optimizer(args, lora, total_steps: int):
    """The optimizer of the JAX CLI's ``_make_optimizer`` for ``lora`` (the
    train state's parameters by name; the text encoders' under ``te1.`` /
    ``te2.``): Prodigy over all of them, or AdamW (8-bit with
    ``--use_8bit_adam``) in one group, or two (the UNet; the text encoders)
    when the text encoders' learning rate or weight decay differ; one
    global-norm clip over every tensor."""
    lr, te_lr = args.learning_rate, args.text_encoder_lr
    if args.scale_lr:
        scale = args.gradient_accumulation_steps * args.train_batch_size * world_size()
        lr, te_lr = lr * scale, te_lr * scale
    sched = lambda base: make_lr_schedule(args.lr_scheduler, base, args.lr_warmup_steps,
                                          total_steps, num_cycles=args.lr_num_cycles,
                                          power=args.lr_power)
    if args.optimizer.lower() == "prodigy":
        if args.use_8bit_adam:
            logger.warning("--use_8bit_adam has no effect with prodigy")
        if lr <= 0.1:
            logger.warning("prodigy usually wants --learning_rate around 1.0 (got %g)", lr)
        if args.train_text_encoder and te_lr != lr:
            logger.warning("prodigy: overriding --text_encoder_lr to --learning_rate")
        return Prodigy(lora, learning_rate=lr, betas=(args.adam_beta1, args.adam_beta2),
                       beta3=args.prodigy_beta3, eps=args.adam_epsilon,
                       weight_decay=args.adam_weight_decay, decouple=args.prodigy_decouple,
                       use_bias_correction=args.prodigy_use_bias_correction,
                       safeguard_warmup=args.prodigy_safeguard_warmup,
                       max_grad_norm=args.max_grad_norm,
                       schedule=None if args.lr_scheduler == "constant" else sched(lr))
    te = lambda k: k.startswith(("te1.", "te2."))
    groups = [{"params": {k: p for k, p in lora.items() if not te(k)}, "lr": lr,
               "weight_decay": args.adam_weight_decay, "schedule": sched(lr)}]
    te_params = {k: p for k, p in lora.items() if te(k)}
    if te_params:
        if te_lr != lr or args.adam_weight_decay_text_encoder != args.adam_weight_decay:
            groups.append({"params": te_params, "lr": te_lr, "schedule": sched(te_lr),
                           "weight_decay": args.adam_weight_decay_text_encoder})
        else:
            groups[0]["params"].update(te_params)
    return make_optimizer(groups, beta1=args.adam_beta1, beta2=args.adam_beta2,
                          eps=args.adam_epsilon, max_grad_norm=args.max_grad_norm,
                          use_8bit=args.use_8bit_adam)


def _step_seed(seed: int, step: int) -> int:
    """The seed of this rank's generator at ``step``."""
    return int(np.random.SeedSequence(rank_entropy([seed, step, 3])).generate_state(1)[0])


def main(argv=None):
    args = parse_args(argv)
    check_args(args)
    dev = resolve_device(args.device)
    maybe_initialize_distributed(device=dev)
    is_main = rank() == 0
    resolution = args.resolution or (TINY_RESOLUTION if args.tiny else 512)
    use_prior = bool(args.with_prior_preservation and args.class_data_dir)
    if use_prior and os.path.isdir(args.class_data_dir):
        image_files(args.class_data_dir)  # refuses unread file types before any model is built
    os.makedirs(args.output_dir, exist_ok=True)
    dataset = DreamBoothDataset(args.instance_data_dir, args.instance_prompt, resolution,
                                args.repeats, center_crop=args.center_crop,
                                random_flip=args.random_flip, seed=args.seed)
    mlog = MetricLogger(args.output_dir, "dreambooth_pso", use_wandb=args.use_wandb)
    timer = PhaseTimer(dev)

    # ---- pipeline ----
    kw = dict(lora_rank=args.rank, dtype=torch.float32 if args.tiny else torch.bfloat16,
              resolution=resolution, tiny=args.tiny, seed=args.seed,
              remat=args.gradient_checkpointing_mode if args.gradient_checkpointing else "",
              device=dev, with_scorer=False,
              te_lora_rank=args.rank if args.train_text_encoder else 0, use_dora=args.use_dora)
    if args.pretrained_model_dir:
        pipe = SDXLPipeline.from_torch_dir(args.pretrained_model_dir, **kw)
    else:
        logger.warning("no --pretrained_model_dir: %s weights", "zero-filled" if args.fast_init
                       else f"random weights from seed {args.seed}")
        pipe = SDXLPipeline.random(**kw, fast_init=args.fast_init)
    for module in (pipe.vae, pipe.te1, pipe.te2):
        module.requires_grad_(False)
    lora = lora_parameters(pipe.unet)
    adapters = {"unet": pipe.unet}
    if args.train_text_encoder:
        adapters.update(te1=pipe.te1, te2=pipe.te2)
        for which in ("te1", "te2"):
            lora.update({f"{which}.{k}": p
                         for k, p in lora_parameters(adapters[which]).items()})
    tok1, tok2 = make_clip_tokenizers(args.bpe_path, pipe.te1.config.vocab_size)

    def encode_text(prompts):
        ids = lambda tok: torch.as_tensor(tok(prompts), dtype=torch.long, device=dev)
        cond = pipe.encode_prompt(ids(tok1), ids(tok2))
        return {k: cond[k] for k in ("embeds", "pooled", "time_ids")}

    # ---- instance images -> VAE moments ----
    bs = max(1, args.sample_batch_size)
    with timer.phase("encode"):
        inst_mean, inst_logvar = pipe.encode_images(np.stack(dataset.pixel_values), chunk=bs)
    inst_time_pool = time_ids_from_records(dataset.original_sizes, dataset.crop_top_lefts,
                                           resolution, device=dev)

    per_step = args.train_batch_size * args.gradient_accumulation_steps
    steps_per_epoch = max(1, -(-dataset.num_source // per_step))
    total_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch

    # ---- negatives: the model's own images of the class prompt at step 0 ----
    class_prompt = args.class_prompt or args.instance_prompt
    neg_cond = encode_text([class_prompt])

    def generate_images(n, seed, note):
        """``n`` images of the class prompt, ``bs`` at a time (the last batch
        generated whole and trimmed)."""
        batch = min(bs, max(n, 1))
        cond = {k: v.expand(batch, *v.shape[1:]) for k, v in neg_cond.items()}
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for _ in range(-(-n // batch)):
            out.append(pipe.generate(cond, gen, num_steps=4))
            logger.info("generated %d/%d %s", min(batch * len(out), n), n, note)
        return torch.cat(out)[:n]

    with timer.phase("negatives"):
        negatives = generate_images(args.num_negatives, args.seed + 1, "negatives")
    with timer.phase("encode"):
        neg_mean, neg_logvar = pipe.encode_images(negatives, chunk=bs)
    del negatives

    # ---- prior preservation: class images join the win half ----
    num_class_pool = 0
    if use_prior:
        os.makedirs(args.class_data_dir, exist_ok=True)
        existing = image_files(args.class_data_dir)
        missing = args.num_class_images - len(existing)
        if missing > 0 and is_main:
            logger.info("generating %d class images", missing)
            with timer.phase("class_images"):
                save_pngs(generate_images(missing, args.seed + 2, "class images"),
                          args.class_data_dir, name="class-{i:05d}.png", first=len(existing))
        barrier()  # every rank reads the class images rank 0 wrote
        class_ds = DreamBoothDataset(args.class_data_dir, class_prompt, resolution)
        num_class_pool = len(class_ds)
        with timer.phase("encode"):
            class_mean, class_logvar = pipe.encode_images(np.stack(class_ds.pixel_values),
                                                          chunk=bs)
        class_time_pool = time_ids_from_records(class_ds.original_sizes, class_ds.crop_top_lefts,
                                                resolution, device=dev)

    # ---- trainer, optimizer, state ----
    cfg = DreamBoothPSOConfig(loss_type=args.loss_type, beta=args.beta_pso,
                              neg_defactor=args.neg_defactor,
                              prior_loss_weight=args.prior_loss_weight,
                              distill_train_timesteps=args.distill_train_timesteps,
                              scheduler_space=args.scheduler_space,
                              prediction_type=args.prediction_type,
                              descending_table=not args.direct_timestep_indexing,
                              grad_accum=args.gradient_accumulation_steps,
                              train_text_encoder=args.train_text_encoder,
                              # DoRA cannot ride the per-sample-scale fusion
                              fuse_ref_pass=not args.use_dora)
    trainer = DreamBoothPSOTrainer(cfg, pipe)
    state = PSOTrainState.create(lora, make_dreambooth_optimizer(args, lora, total_steps))
    start_step = 0
    if args.resume_from_checkpoint:
        path = (latest_checkpoint(args.output_dir) if args.resume_from_checkpoint == "latest"
                else args.resume_from_checkpoint)
        if path:
            extra = restore_train_state(path, state)
            start_step = int(extra.get("step", state.step))
            logger.info("resumed from %s at step %d", path, start_step)
        else:
            logger.warning("no checkpoint found to resume from; starting fresh")
    broadcast_train_state_(state)  # every rank starts from rank 0's state

    ga, b = args.gradient_accumulation_steps, args.train_batch_size
    prompts = [args.instance_prompt] * b + ([class_prompt] * b if use_prior else [])
    b_eff = len(prompts)
    if args.train_text_encoder:  # encoded in every microbatch, through the live adapters
        inst_ids = {"input_ids_one": torch.as_tensor(tok1(prompts), dtype=torch.long, device=dev),
                    "input_ids_two": torch.as_tensor(tok2(prompts), dtype=torch.long, device=dev)}
    else:
        inst_cond = encode_text(prompts)
    scaling = pipe.vae.config.scaling_factor

    def draw_latents(mean, logvar, idx, gen):
        m = mean[torch.as_tensor(idx, device=dev)]
        lv = logvar[torch.as_tensor(idx, device=dev)]
        noise = torch.randn(m.shape, generator=gen, device=dev)
        return ((m + torch.exp(0.5 * lv) * noise) * scaling).float()

    def per_micro(x):  # (ga * b_eff, ...) -> (ga, b_eff, ...)
        return x.reshape((ga, b_eff) + x.shape[1:])

    def win_half(inst, cls):  # two (ga * b, ...) pools -> (ga, [instance b | class b], ...)
        return torch.cat([inst.reshape((ga, b) + inst.shape[1:]),
                          cls.reshape((ga, b) + cls.shape[1:])], dim=1)

    # ---- validation ----
    class_name = args.class_name or (class_prompt.split()[-1] if class_prompt else "thing")
    val_prompts = dreambooth_validation_prompts(args.unique_token, class_name, args.is_object)

    def val_generate(prompt, gen, n):  # the text encoders' live adapters, when trained
        return pipe.generate(encode_text([prompt] * n), gen, num_steps=4)

    def save_all(step1):
        path = save_train_state(args.output_dir, step1, state, {"step": step1})
        lora_dir = os.path.join(args.output_dir, f"lora-{step1}")
        os.makedirs(lora_dir, exist_ok=True)
        export_sdxl_lora_safetensors(adapters, os.path.join(lora_dir, LORA_FILE))
        if args.output_kohya_format:
            export_kohya_lora_safetensors(adapters, os.path.join(lora_dir, KOHYA_FILE))
        if args.checkpoints_total_limit:
            prune_checkpoints(args.output_dir, int(args.checkpoints_total_limit))
        logger.info("saved %s and %s", path, lora_dir)

    mlog.log_metrics({f"time/{k}_s": v for k, v in timer.totals.items()}, start_step)
    history = []
    n_draw, n_neg = ga * b, ga * b_eff
    try:
        for step in range(start_step, total_steps):
            with timer.phase("step"):
                gen = torch.Generator(device=dev).manual_seed(_step_seed(args.seed, step))
                rng = np.random.default_rng(rank_entropy([args.seed, step, 4]))
                inst_idx = rng.choice(len(dataset), n_draw, replace=len(dataset) < n_draw)
                neg_idx = rng.choice(args.num_negatives, n_neg,
                                     replace=args.num_negatives < n_neg)
                inst_lat = draw_latents(inst_mean, inst_logvar, inst_idx, gen)
                tw_inst = inst_time_pool[torch.as_tensor(inst_idx, device=dev)]
                if use_prior:
                    class_idx = rng.choice(num_class_pool, n_draw,
                                           replace=num_class_pool < n_draw)
                    win_lat = win_half(inst_lat, draw_latents(class_mean, class_logvar,
                                                              class_idx, gen))
                    time_ids_win = win_half(
                        tw_inst, class_time_pool[torch.as_tensor(class_idx, device=dev)])
                else:
                    win_lat, time_ids_win = per_micro(inst_lat), per_micro(tw_inst)
                batch = {
                    "instance_latents": win_lat,
                    "negative_latents": per_micro(draw_latents(neg_mean, neg_logvar, neg_idx,
                                                               gen)),
                    "time_ids_win": time_ids_win,
                    "time_ids_lose": per_micro(compute_time_ids(n_neg, resolution, device=dev)),
                }
                if args.train_text_encoder:
                    batch.update({k: v.expand(ga, *v.shape) for k, v in inst_ids.items()})
                else:
                    batch["cond"] = {k: v.expand(ga, *v.shape) for k, v in inst_cond.items()}
                idx = sample_lattice_timesteps(ga * b_eff, cfg.num_train_timesteps,
                                               cfg.distill_train_timesteps, gen,
                                               dev).reshape(ga, b_eff)
                noise = torch.randn(win_lat.shape, generator=gen, device=dev)
                metrics = trainer.update(state, batch, idx, noise)
            metrics["time/step_s"] = timer.last["step"]
            history.append(metrics)
            if (step + 1) % 10 == 0 or step == start_step:
                mlog.log_metrics(metrics, step + 1)
            if (args.checkpointing_steps and (step + 1) % args.checkpointing_steps == 0) or (
                    step + 1 == total_steps):
                if is_main:
                    save_all(step + 1)
                barrier()
            if (not args.skip_validation and args.validation_steps
                    and (step + 1) % args.validation_steps == 0):
                if is_main:
                    with timer.phase("validation"):
                        root = run_dreambooth_validation(val_generate, val_prompts,
                                                         args.output_dir, step + 1,
                                                         args.num_validation_images,
                                                         seed=args.seed, device=dev)
                    mlog.log_metrics({"time/validation_s": timer.last["validation"]}, step + 1)
                    logger.info("validation images at %s", root)
                barrier()
    finally:
        mlog.close()
    return state, history, pipe


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
