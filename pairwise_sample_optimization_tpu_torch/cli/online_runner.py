"""The online-PSO run loop for SDXL-Turbo and SDXL-DMD2 on one device.

Counterpart of the JAX package's ``cli/online_runner.py::run_online_pso``:
build the pipeline (a local diffusers checkpoint under
``pretrained.model_dir``, else architecture-true random weights from the
seed; a separate VAE under ``pretrained.vae_dir``, such as the fp16-fix
VAE), the PickScore scorer (its HF ``CLIPModel`` weights under
``pretrained.pickscore_dir``, else random), tokenizers, prompt loader,
trainer, optimizer and train state; resume from ``resume_from``; then per
epoch sample ``num_batches_per_epoch`` pair batches, log the reward
mean/std, run the epoch's shuffled DPO updates, log each update's metrics
with the phase times, validate every ``validation_steps`` updates, and
checkpoint at step 1 and every ``checkpointing_steps``: the train state
under ``checkpoint-<step>`` and the adapter for diffusers as
``lora-<step>/pytorch_lora_weights.safetensors``, as the JAX runner
writes them.

Validation (:func:`run_validation`) generates 4-step images of the first
``val_max_prompts`` validation prompts with the live adapter, logs their
mean PickScore and CLIP score as ``val/pickscore`` and ``val/clip_score``
(with its wall time, ``time/validation_s``), and writes the first five
images to ``val-<step>/`` as PNGs.

The DMD2 sampler (``sampler="dmd"``) takes strict-dominance preference
(``compare="pareto"``) and ``sample.shared_noise``, as the JAX runner
does; the Turbo sampler per-sample random-axis preference.

Memory options, as the JAX runner takes them:

- ``use_lora=False``: full finetuning. Every UNet weight is trained (in
  fp32 masters under ``param_dtype="float32"``, computing in the
  ``mixed_precision`` dtype), by the per-tensor AdamW
  (``train.foreach_adamw``; with ``train.use_8bit_adam`` the per-tensor
  8-bit AdamW, ``train.quantized_adam.ForeachAdam8bit``); the reference
  pass runs a separate frozen copy in the compute dtype
  (``pipeline.reference_unet``), unfused; sampling and
  validation run the live weights; checkpoints hold the whole UNet and no
  LoRA file is written;
- ``param_dtype="bfloat16"``: the UNet's weights stored in bf16 (trained
  or not), cast to the compute dtype at use; ``"float32"`` keeps fp32
  masters for a fully trained UNet. The other towers, and a frozen UNet
  under ``"float32"``, are stored in the compute dtype (with bf16 compute,
  what a cast at use would give);
- ``offload_aux_during_update``: the VAE, the PickScore scorer and both
  text encoders wait in pinned host memory while the update runs
  (``utils.offload.HostOffload``; ``time/offload_s`` and ``time/reload_s``
  log the moves, ``offload_bytes`` their size);
- ``activation_checkpoint``: any of ``models.unet.REMAT_MODES``;
- ``vae_decode_chunk``: latents a VAE decoder call (0: the whole batch);
- ``kernels.gelu_exact``: the exact erf GELU in bf16 too.

Validation prompts come from ``val_dataset``: ``hf:<dir>`` reads the
``val_split_name`` split of a local ``datasets`` ``save_to_disk`` export
(``data/arrow_disk.py``; a hub name needs the network and is refused where
validation would fire). ``profile_dir`` traces the second epoch of the
invocation, or the only one, with ``torch.profiler``
(``<profile_dir>/epoch-<n>.json``); ``use_wandb`` logs to wandb too where
it imports and starts, as the JAX runner does.

Not ported yet, and refused when asked for (by :func:`check_config`):
meshes beyond one device, ``fast_init`` and the JAX package's int8 options.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoints import (LORA_FILE, export_lora_safetensors, latest_checkpoint, load_clip_dual,
                           load_torch_state_dict, load_weights, prune_checkpoints,
                           restore_train_state, save_train_state, tower_weight_file)
from ..data import PromptDataset, PromptLoader, make_clip_tokenizers
from ..device import resolve_device
from ..models.layers import set_gelu_exact
from ..models.unet import frozen_copy
from ..pipeline import SAMPLERS, SDXLPipeline
from ..rewards import CLIPScorer
from ..train import (OnlinePSOConfig, OnlinePSOTrainer, PSOTrainState, all_parameters,
                     lora_parameters, make_optimizer)
from ..utils import MetricLogger, PhaseTimer, get_logger, profile_to
from ..utils.offload import HostOffload
from ..utils.png import save_pngs

logger = get_logger("pso.online")

# knob -> its default; any other value is refused until the port has it
_UNPORTED = {
    "mesh.data": (-1, 1), "mesh.model": (1,), "mesh.fsdp": (False,),
    "fast_init": (False,), "train.int8_ref_pass": (False,),
    "kernels.subpixel_upsample": (False,), "kernels.int8_vae_decode": (False,),
    "kernels.int8_smooth_alpha": (0.0,),
}
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VAL_IMAGES = 5  # validation images saved per validation, as the JAX runner saves


def _get(config, dotted: str):
    node = config
    for part in dotted.split("."):
        node = node[part]
    return node


def check_config(config, sampler: str) -> None:
    """Refuse knobs the port does not implement. The remat mode is the
    UNet's to check (``models/unet.py``)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; have {SAMPLERS}")
    for key, allowed in _UNPORTED.items():
        if _get(config, key) not in allowed:
            raise NotImplementedError(f"{key}={_get(config, key)!r} is not ported yet "
                                      f"(allowed: {allowed})")
    if config.param_dtype not in PARAM_DTYPES:
        raise ValueError(f"param_dtype={config.param_dtype!r}: use one of {list(PARAM_DTYPES)}")
    if config.train.distilled_train_steps != config.sample.num_steps - 1:
        raise ValueError(f"train.distilled_train_steps ({config.train.distilled_train_steps}) "
                         f"must equal sample.num_steps - 1 ({config.sample.num_steps - 1})")


def run_dir(config, sampler: str = "turbo") -> str:
    """The directory a run writes its metrics and checkpoints to."""
    return os.path.join(config.output_dir, config.run_name or f"online_{sampler}")


def _epoch_seed(seed: int, epoch: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, epoch, stream]).generate_state(1)[0])


def build_pipeline(config, dtype, tiny: bool, dev) -> SDXLPipeline:
    """The pipeline of ``config.pretrained``: the diffusers checkpoint, the
    separate VAE and the PickScore weights where given, random from the
    seed otherwise."""
    p = config.pretrained
    # the UNet's weights in param_dtype where they are trained or bf16 is asked
    # for; the other towers (and a frozen fp32 UNet) are stored in the compute
    # dtype, which gives the numbers a cast at use would
    unet_dtype = (PARAM_DTYPES[config.param_dtype]
                  if not config.use_lora or config.param_dtype == "bfloat16" else None)
    kw = dict(lora_rank=config.train.lora_rank if config.use_lora else 0, dtype=dtype,
              resolution=config.sample.resolution, tiny=tiny, seed=config.seed,
              remat=config.activation_checkpoint, device=dev, unet_param_dtype=unet_dtype)
    if p.model_dir:
        pipe = SDXLPipeline.from_torch_dir(p.model_dir, **kw)
    else:
        logger.warning("no pretrained model_dir -- random weights from seed %d", config.seed)
        pipe = SDXLPipeline.random(**kw)
    if p.vae_dir:
        path = tower_weight_file(p.vae_dir)
        if path is None:
            raise FileNotFoundError(f"no VAE weights at {p.vae_dir!r}")
        load_weights(pipe.vae, load_torch_state_dict(path, dev))
        logger.info("loaded VAE weights from %s", path)
    if p.pickscore_dir:
        load_clip_dual(p.pickscore_dir, pipe.scorer.model)
        logger.info("loaded PickScore weights from %s", p.pickscore_dir)
    pipe.decode_chunk = int(config.vae_decode_chunk)
    return pipe


def validation_prompts(config):
    """The first ``val_max_prompts`` prompts of ``val_dataset``: the
    ``val_split_name`` split of a local ``datasets`` export given as
    ``hf:<save_to_disk dir>``, a local prompts file where the path exists,
    else the built-in set (the JAX runner's order)."""
    src = str(config.val_dataset)
    if src.startswith("hf:"):
        try:
            dataset = PromptDataset(hf_dataset=src[3:], split=config.val_split_name)
        except NotImplementedError as e:  # a hub name
            raise NotImplementedError(f"val_dataset={src!r}: {e}") from None
    else:
        dataset = PromptDataset(src if os.path.exists(src) else None,
                                split=config.val_split_name)
    return dataset.prompts[:config.val_max_prompts]


@torch.no_grad()
def run_validation(pipe, clip_scorer, prompts, tokenizers, sampler: str, seed: int,
                   batch_size: int, image_dir: Optional[str] = None):
    """4-step images of ``prompts`` with the pipeline's live adapter, in
    chunks of ``batch_size`` (the last padded with its last prompt), scored
    by the pipeline's PickScore and ``clip_scorer`` -> {"val/pickscore",
    "val/clip_score"}: the means over the prompts. Each chunk's noise comes
    from a generator seeded by (``seed``, the chunk's start). The first
    ``VAL_IMAGES`` images go to ``image_dir`` as PNGs (the JAX runner takes
    them from the first chunk only, so fewer where a chunk is smaller)."""
    tok1, tok2, tok_r = tokenizers
    ids = lambda tok, chunk: torch.as_tensor(tok(chunk), dtype=torch.long, device=pipe.device)
    generate = pipe.generate if sampler == "turbo" else pipe.generate_dmd
    ps, cs = [], []
    for start in range(0, len(prompts), batch_size):
        chunk = prompts[start:start + batch_size]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch_size - real)
        cond = pipe.encode_prompt(ids(tok1, chunk), ids(tok2, chunk))
        gen = torch.Generator(device=pipe.device).manual_seed(_epoch_seed(seed, start, 2))
        images = generate(cond, gen, num_steps=4)
        if image_dir and start < VAL_IMAGES:
            save_pngs(images[:min(real, VAL_IMAGES - start)], image_dir, first=start)
        r_ids = ids(tok_r, chunk)
        ps.append(pipe.scorer.score(images, r_ids).float())
        cs.append(clip_scorer.score(images, r_ids).float())
    n = len(prompts)
    return {"val/pickscore": float(torch.cat(ps)[:n].mean()),
            "val/clip_score": float(torch.cat(cs)[:n].mean())}


def run_online_pso(config, sampler: str = "turbo", num_epochs: Optional[int] = None,
                   device="cuda"):
    """Run ``num_epochs`` epochs (default ``config.num_epochs``) from the
    start or from the checkpoint under ``config.resume_from``, writing to
    :func:`run_dir`. Returns (state, metrics history: one dict per update,
    the pipeline whose UNet carries the trained adapter, or the trained
    weights and the frozen reference copy under full finetuning)."""
    check_config(config, sampler)
    dev = resolve_device(device)
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    tiny = bool(config.tiny_model)
    epochs = config.num_epochs if num_epochs is None else num_epochs
    full_ft = not config.use_lora
    set_gelu_exact(config.kernels.gelu_exact)

    # ---- models ----
    pipe = build_pipeline(config, dtype, tiny, dev)
    aux = (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model)
    for module in aux:
        module.requires_grad_(False)
    offload = HostOffload(aux) if config.offload_aux_during_update else None
    tok1, tok2, tok_r = make_clip_tokenizers(
        config.pretrained.bpe_path, vocab_size=pipe.te1.config.vocab_size, with_reward=True)
    loader = PromptLoader(PromptDataset(config.prompt_json or None), config.sample.batch_size,
                          tok1, tok2, reward_tokenizer=tok_r, seed=config.seed)

    # ---- trainer, optimizer, state ----
    ocfg = OnlinePSOConfig(
        sampler=sampler, num_steps=config.sample.num_steps, beta=config.train.beta,
        eps=config.train.eps, train_batch_size=config.train.batch_size,
        grad_accum=config.train.gradient_accumulation_steps,
        num_inner_epochs=config.train.num_inner_epochs,
        compare="sample" if sampler == "turbo" else "pareto",
        clamp_mode=config.train.clamp_mode,
        shared_noise=bool(config.sample.get("shared_noise", True)),
        num_train_timesteps=config.train.distilled_train_steps,
        # policy and reference run different weights under full finetuning
        fuse_ref_pass=bool(config.train.fuse_ref_pass) and not full_ft,
        full_finetune=full_ft)
    if full_ft:
        pipe.reference_unet = frozen_copy(pipe.unet)
    trainer = OnlinePSOTrainer(ocfg, pipe)
    trainable = all_parameters(pipe.unet) if full_ft else lora_parameters(pipe.unet)
    tx = make_optimizer(trainable, learning_rate=config.train.learning_rate,
                        beta1=config.train.adam_beta1, beta2=config.train.adam_beta2,
                        eps=config.train.adam_epsilon, weight_decay=config.train.adam_weight_decay,
                        max_grad_norm=config.train.max_grad_norm,
                        state_dtype=config.train.optimizer_state_dtype,
                        use_8bit=config.train.use_8bit_adam, per_tensor=full_ft)
    state = PSOTrainState.create(trainable, tx)
    start_epoch = 0
    if config.resume_from:
        ckpt = latest_checkpoint(config.resume_from)
        if ckpt:
            extra = restore_train_state(ckpt, state)
            # continue the epoch numbering: restarting at 0 would replay the
            # epoch-keyed random streams of epochs already trained
            start_epoch = int(extra.get("epoch", 0)) + 1
            logger.info("resumed from %s (step %d, epoch %d)", ckpt, state.step, start_epoch)

    # ---- validation: its prompts where it will fire; the CLIP scorer when it
    # first fires (at full width ~2 GB a run without validation need not hold) ----
    per_epoch = (config.sample.batch_size * config.sample.num_batches_per_epoch
                 // (config.train.batch_size * config.train.gradient_accumulation_steps)
                 * config.train.num_inner_epochs)
    steps = range(state.step + 1, state.step + 1 + per_epoch * epochs)
    val_prompts, clip_scorer = None, None
    if config.validation_steps and any(s % config.validation_steps == 0 for s in steps):
        val_prompts = validation_prompts(config)

    def validate(step):
        nonlocal clip_scorer
        if clip_scorer is None:
            s = pipe.scorer.model
            clip_scorer = CLIPScorer.random(s.text_config, s.vision_config, seed=config.seed + 2,
                                            device=dev)
            clip_scorer.model.requires_grad_(False)
        t0 = time.perf_counter()
        metrics = run_validation(pipe, clip_scorer, val_prompts, (tok1, tok2, tok_r), sampler,
                                 config.seed, max(config.sample.batch_size, 1),
                                 os.path.join(out_dir, f"val-{step}"))
        # the means are host floats: the device work is done
        metrics["time/validation_s"] = time.perf_counter() - t0
        metrics_logger.log_metrics(metrics, step)

    out_dir = run_dir(config, sampler)
    metrics_logger = MetricLogger(out_dir, config.run_name, use_wandb=config.use_wandb,
                                  config=config.to_dict())
    timer = PhaseTimer(dev)
    history = []
    # trace the second epoch of this invocation where there is one (the first
    # pays the one-off costs), else the only one, as the JAX runner does
    profile_epoch = start_epoch + (1 if epochs > 1 else 0)
    try:
        for epoch in range(start_epoch, start_epoch + epochs):
            with profile_to(config.profile_dir if epoch == profile_epoch else None, dev,
                            f"epoch-{epoch}"):
                gen = torch.Generator(device=dev).manual_seed(_epoch_seed(config.seed, epoch, 0))
                shuffle_gen = torch.Generator().manual_seed(_epoch_seed(config.seed, epoch, 1))
                # ---------------- sampling ----------------
                all_samples, all_cond = [], []
                with timer.phase("sample"):
                    for b_idx, batch in enumerate(loader.epoch()):
                        ids = [torch.as_tensor(batch[k], dtype=torch.long, device=dev)
                               for k in ("input_ids_one", "input_ids_two", "reward_input_ids")]
                        cond = pipe.encode_prompt(*ids)
                        samples, _ = trainer.sample_pairs(cond, gen)
                        all_samples.append(samples)
                        all_cond.append({k: cond[k] for k in ("embeds", "pooled", "time_ids")})
                        logger.info("epoch %d: sampled pair batch %d/%d", epoch, b_idx + 1,
                                    config.sample.num_batches_per_epoch)
                        if b_idx + 1 == config.sample.num_batches_per_epoch:
                            break
                samples = {k: torch.cat([s[k] for s in all_samples]) for k in all_samples[0]}
                cond = {k: torch.cat([c[k] for c in all_cond]) for k in all_cond[0]}
                rewards = samples["rewards"].float()
                metrics_logger.log_metrics({"epoch": epoch, "reward_mean": rewards.mean(),
                                            "reward_std": rewards.std(unbiased=False)}, state.step)

                # ---------------- training ----------------
                global_step = state.step
                moves = {}
                if offload is not None:
                    with timer.phase("offload"):
                        offload.to_host()
                with timer.phase("train"):
                    state, step_metrics = trainer.train_epoch(state, samples, cond, shuffle_gen)
                if offload is not None:
                    with timer.phase("reload"):
                        offload.to_device()
                    moves = {"offload_bytes": offload.nbytes()}
                for m in step_metrics:
                    global_step += 1
                    metrics_logger.log_metrics({**m, **moves, **timer.summary()}, global_step)
                    history.append(m)
                    if config.validation_steps and global_step % config.validation_steps == 0:
                        validate(global_step)
                    if config.checkpointing_steps and (
                            global_step % config.checkpointing_steps == 0 or global_step == 1):
                        # the state after the whole epoch, under the update's step
                        # number, as the JAX runner saves it
                        path = save_train_state(out_dir, global_step, state, {"epoch": epoch})
                        if not full_ft:  # the adapter for diffusers beside it
                            lora_dir = os.path.join(out_dir, f"lora-{global_step}")
                            os.makedirs(lora_dir, exist_ok=True)
                            export_lora_safetensors(pipe.unet, os.path.join(lora_dir, LORA_FILE))
                        prune_checkpoints(out_dir, int(config.num_checkpoint_limit))
                        logger.info("saved state to %s", path)
                timer.reset()
    finally:
        metrics_logger.close()
    return state, history, pipe
