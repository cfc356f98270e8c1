"""The online-PSO run loop for SDXL-Turbo on one device.

Counterpart of the JAX package's ``cli/online_runner.py::run_online_pso``:
build the pipeline (architecture-true random weights from the seed), the
PickScore scorer, tokenizers, prompt loader, trainer, optimizer and train
state; resume from ``resume_from``; then per epoch sample
``num_batches_per_epoch`` pair batches, log the reward mean/std, run the
epoch's shuffled DPO updates, log each update's metrics with the phase
times, and checkpoint at step 1 and every ``checkpointing_steps``.

Not ported yet, and refused by :func:`check_config` when asked for: the
DMD2 sampler, validation, pretrained checkpoints, the LoRA safetensors
export, meshes beyond one device, and the JAX package's memory and int8
options.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..checkpoints import (latest_checkpoint, prune_checkpoints, restore_train_state,
                           save_train_state)
from ..data import PromptDataset, PromptLoader, make_clip_tokenizers
from ..device import resolve_device
from ..pipeline import SDXLPipeline
from ..train import (OnlinePSOConfig, OnlinePSOTrainer, PSOTrainState, lora_parameters,
                     make_optimizer)
from ..utils import MetricLogger, PhaseTimer, get_logger

logger = get_logger("pso.online")

# knob -> its default; any other value is refused until the port has it
_UNPORTED = {
    "mesh.data": (-1, 1), "mesh.model": (1,), "mesh.fsdp": (False,),
    "param_dtype": ("float32",), "offload_aux_during_update": (False,),
    "use_wandb": (False,), "fast_init": (False,),
    "profile_dir": ("",), "use_lora": (True,), "train.int8_ref_pass": (False,),
    "train.use_8bit_adam": (False,), "train.optimizer_state_dtype": ("", "float32"),
    "kernels.subpixel_upsample": (False,), "kernels.int8_vae_decode": (False,),
    "kernels.int8_smooth_alpha": (0.0,), "kernels.gelu_exact": (False,),
    "pretrained.model_dir": ("",), "pretrained.vae_dir": ("",),
    "pretrained.pickscore_dir": ("",),
}


def _get(config, dotted: str):
    node = config
    for part in dotted.split("."):
        node = node[part]
    return node


def check_config(config, sampler: str) -> None:
    """Refuse knobs the port does not implement. The remat mode is the
    UNet's to check (``models/unet.py``)."""
    if sampler != "turbo":
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet (turbo only)")
    for key, allowed in _UNPORTED.items():
        if _get(config, key) not in allowed:
            raise NotImplementedError(f"{key}={_get(config, key)!r} is not ported yet "
                                      f"(allowed: {allowed})")
    if config.train.distilled_train_steps != config.sample.num_steps - 1:
        raise ValueError(f"train.distilled_train_steps ({config.train.distilled_train_steps}) "
                         f"must equal sample.num_steps - 1 ({config.sample.num_steps - 1})")


def run_dir(config, sampler: str = "turbo") -> str:
    """The directory a run writes its metrics and checkpoints to."""
    return os.path.join(config.output_dir, config.run_name or f"online_{sampler}")


def _epoch_seed(seed: int, epoch: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, epoch, stream]).generate_state(1)[0])


def run_online_pso(config, sampler: str = "turbo", num_epochs: Optional[int] = None,
                   device="cuda"):
    """Run ``num_epochs`` epochs (default ``config.num_epochs``) from the
    start or from the checkpoint under ``config.resume_from``, writing to
    :func:`run_dir`. Returns (state, metrics history: one dict per update,
    the pipeline whose UNet carries the trained adapter)."""
    check_config(config, sampler)
    dev = resolve_device(device)
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    tiny = bool(config.tiny_model)
    epochs = config.num_epochs if num_epochs is None else num_epochs

    # ---- models ----
    logger.warning("no pretrained model_dir -- random weights from seed %d", config.seed)
    pipe = SDXLPipeline.random(lora_rank=config.train.lora_rank, dtype=dtype,
                               resolution=config.sample.resolution, tiny=tiny, seed=config.seed,
                               remat=config.activation_checkpoint, device=dev)
    for module in (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model):
        module.requires_grad_(False)
    tok1, tok2, tok_r = make_clip_tokenizers(
        config.pretrained.bpe_path, vocab_size=pipe.te1.config.vocab_size, with_reward=True)
    loader = PromptLoader(PromptDataset(config.prompt_json or None), config.sample.batch_size,
                          tok1, tok2, reward_tokenizer=tok_r, seed=config.seed)

    # ---- trainer, optimizer, state ----
    ocfg = OnlinePSOConfig(
        sampler=sampler, num_steps=config.sample.num_steps, beta=config.train.beta,
        eps=config.train.eps, train_batch_size=config.train.batch_size,
        grad_accum=config.train.gradient_accumulation_steps,
        num_inner_epochs=config.train.num_inner_epochs, compare="sample",
        clamp_mode=config.train.clamp_mode,
        num_train_timesteps=config.train.distilled_train_steps,
        fuse_ref_pass=bool(config.train.fuse_ref_pass))
    trainer = OnlinePSOTrainer(ocfg, pipe)
    lora = lora_parameters(pipe.unet)
    tx = make_optimizer(lora, learning_rate=config.train.learning_rate,
                        beta1=config.train.adam_beta1, beta2=config.train.adam_beta2,
                        eps=config.train.adam_epsilon, weight_decay=config.train.adam_weight_decay,
                        max_grad_norm=config.train.max_grad_norm,
                        state_dtype=config.train.optimizer_state_dtype,
                        use_8bit=config.train.use_8bit_adam)
    state = PSOTrainState.create(lora, tx)
    start_epoch = 0
    if config.resume_from:
        ckpt = latest_checkpoint(config.resume_from)
        if ckpt:
            extra = restore_train_state(ckpt, state)
            # continue the epoch numbering: restarting at 0 would replay the
            # epoch-keyed random streams of epochs already trained
            start_epoch = int(extra.get("epoch", 0)) + 1
            logger.info("resumed from %s (step %d, epoch %d)", ckpt, state.step, start_epoch)

    # ---- validation is not ported: refuse a run in which it would fire ----
    per_epoch = (config.sample.batch_size * config.sample.num_batches_per_epoch
                 // (config.train.batch_size * config.train.gradient_accumulation_steps)
                 * config.train.num_inner_epochs)
    steps = range(state.step + 1, state.step + 1 + per_epoch * epochs)
    if config.validation_steps and any(s % config.validation_steps == 0 for s in steps):
        raise NotImplementedError(
            f"validation_steps={config.validation_steps} would run validation within steps "
            f"{steps.start}..{steps.stop - 1}; validation is not ported yet (set it to 0)")

    out_dir = run_dir(config, sampler)
    metrics_logger = MetricLogger(out_dir)
    timer = PhaseTimer(dev)
    history = []
    try:
        for epoch in range(start_epoch, start_epoch + epochs):
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
            with timer.phase("train"):
                state, step_metrics = trainer.train_epoch(state, samples, cond, shuffle_gen)
            for m in step_metrics:
                global_step += 1
                metrics_logger.log_metrics({**m, **timer.summary()}, global_step)
                history.append(m)
                if config.checkpointing_steps and (
                        global_step % config.checkpointing_steps == 0 or global_step == 1):
                    # the state after the whole epoch, under the update's step
                    # number, as the JAX runner saves it
                    path = save_train_state(out_dir, global_step, state, {"epoch": epoch})
                    prune_checkpoints(out_dir, int(config.num_checkpoint_limit))
                    logger.info("saved state to %s", path)
            timer.reset()
    finally:
        metrics_logger.close()
    return state, history, pipe
