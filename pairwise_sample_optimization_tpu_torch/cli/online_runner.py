"""The online-PSO run loop for SDXL-Turbo and SDXL-DMD2, on one device or
data-parallel over a ``torch.distributed`` group.

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

The opt-in int8 and subpixel options, as the JAX runner sets them at the
start of a run (process-wide): ``kernels.subpixel_upsample``
(``ops.upsample.set_use_subpixel``), ``kernels.int8_vae_decode`` and
``kernels.int8_smooth_alpha`` (``ops.qconv``; an alpha of 0 is off), and
``train.int8_ref_pass`` for the trainer. ``fast_init`` zero-fills the
random towers (the scorer too) instead of drawing them: for benches and
compile checks.

Validation prompts come from ``val_dataset``: ``hf:<dir>`` reads the
``val_split_name`` split of a local ``datasets`` ``save_to_disk`` export
(``data/arrow_disk.py``; a hub name needs the network and is refused where
validation would fire). ``profile_dir`` traces the second epoch of the
invocation, or the only one, with ``torch.profiler``
(``<profile_dir>/epoch-<n>.json``); ``use_wandb`` logs to wandb too where
it imports and starts, as the JAX runner does.

Data parallelism, as the JAX runner's: launched as ``torchrun
--nproc_per_node=N`` (or with the JAX package's ``PSO_COORDINATOR`` /
``PSO_NUM_PROCESSES`` / ``PSO_PROCESS_ID``), each process runs on its own
card (``cuda:LOCAL_RANK``); the world is laid out as the mesh
``mesh.data`` x ``mesh.model`` (``parallel/mesh.py``: rank = d * model +
m). ``sample.batch_size`` and ``train.batch_size`` are per data index,
each data index's prompt stream is seeded ``seed + d``, and an update
averages the gradients of the global microbatch over the data axis
(``train/online_pso.py``). The trained tensors and the optimizer state are
broadcast from the data axis's first rank after build or resume, the
rewards gathered before their mean and std are logged, and rank 0 alone
logs metrics, writes the validation images, checkpoints, exports the LoRA
and prunes, the other ranks waiting for it.

The weights are placed on the mesh in the JAX runner's order:

- ``mesh.model > 1``: tensor parallelism of the UNet's attention and GEGLU
  feed-forward over the model axis (``parallel/tp.py``; the trained UNet
  and, under full finetuning, the frozen reference copy); the VAE, the
  text towers and the scorer replicated. The LoRA adapter (or the trained
  weights) and their optimizer moments are sliced with the weights;
  checkpoints and LoRA files hold whole tensors (gathered to rank 0), and a
  run resumes at any ``mesh.model``;
- ``mesh.fsdp``: FSDP of the frozen weights over the data axis
  (``parallel/fsdp.py``): the UNet's frozen weights (the reference copy
  under full finetuning), the VAE, both text towers and the scorer; the
  trained tensors and the optimizer state replicated. It does not combine
  with ``mesh.model > 1``.

Under either, every rank runs the validation (a sharded forward needs all
of them); rank 0 writes its images and logs it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoints import (LORA_FILE, export_lora_safetensors, latest_checkpoint, load_clip_dual,
                           load_torch_state_dict, load_weights, prune_checkpoints,
                           restore_train_state, save_train_state, tower_weight_file,
                           train_state_blob)
from ..data import PromptDataset, PromptLoader, make_clip_tokenizers
from ..device import resolve_device
from ..models.layers import set_gelu_exact
from ..models.unet import frozen_copy
from ..ops import qconv
from ..ops.upsample import set_use_subpixel
from ..parallel import (MeshSpec, barrier, broadcast_train_state_, data_group, host_fold,
                        init_mesh, maybe_initialize_distributed, model_group, model_index,
                        process_allgather, rank, world_size)
from ..parallel.fsdp import shard_module_fsdp
from ..parallel.tp import shard_unet_tp
from ..pipeline import SAMPLERS, SDXLPipeline
from ..rewards import CLIPScorer
from ..train import (OnlinePSOConfig, OnlinePSOTrainer, PSOTrainState, all_parameters,
                     lora_parameters, make_optimizer)
from ..utils import MetricLogger, PhaseTimer, get_logger, profile_to
from ..utils.offload import HostOffload
from ..utils.png import save_pngs

logger = get_logger("pso.online")

PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VAL_IMAGES = 5  # validation images saved per validation, as the JAX runner saves


def mesh_spec(config) -> MeshSpec:
    return MeshSpec(int(config.mesh.data), int(config.mesh.model), bool(config.mesh.fsdp))


def train_timesteps(config) -> int:
    """The trained transitions: ``train.distilled_train_steps``, where 0 or
    a missing key reads as ``sample.num_steps - 1`` (as the JAX package's
    ``run_online_pso`` reads it)."""
    return int(config.train.get("distilled_train_steps", 0)) or config.sample.num_steps - 1


def check_config(config, sampler: str, world: int = 1) -> None:
    """Refuse an unknown sampler or ``param_dtype``, a mesh that does not
    cover the ``world`` processes, FSDP with ``mesh.model > 1``, and
    :func:`train_timesteps` other than the sampled transitions. The remat
    mode is the UNet's to check (``models/unet.py``)."""
    mesh_spec(config).resolve(world)
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; have {SAMPLERS}")
    if config.param_dtype not in PARAM_DTYPES:
        raise ValueError(f"param_dtype={config.param_dtype!r}: use one of {list(PARAM_DTYPES)}")
    if train_timesteps(config) != config.sample.num_steps - 1:
        raise ValueError(f"train.distilled_train_steps ({train_timesteps(config)}) "
                         f"must equal sample.num_steps - 1 ({config.sample.num_steps - 1})")


def check_cli_train_steps(config) -> None:
    """The CLI entry points take ``train.distilled_train_steps`` only as
    ``sample.num_steps - 1`` itself (0 is refused there, as the JAX
    package's CLIs assert); :func:`run_online_pso` also reads 0 as that."""
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
        logger.warning("no pretrained model_dir -- %s weights", "zero-filled" if config.fast_init
                       else f"random weights from seed {config.seed}")
        pipe = SDXLPipeline.random(**kw, fast_init=bool(config.fast_init))
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
    weights and the frozen reference copy under full finetuning). Under a
    process group every rank calls it; each returns its own pipeline and
    the same state and history."""
    dev = resolve_device(device)
    maybe_initialize_distributed(device=dev)
    world, is_main = world_size(), rank() == 0
    check_config(config, sampler, world)
    mesh = init_mesh(mesh_spec(config))
    use_tp, use_fsdp = mesh.model > 1, mesh.fsdp and mesh.data > 1
    dtype = torch.bfloat16 if config.mixed_precision == "bf16" else torch.float32
    tiny = bool(config.tiny_model)
    epochs = config.num_epochs if num_epochs is None else num_epochs
    set_gelu_exact(config.kernels.gelu_exact)
    set_use_subpixel(config.kernels.subpixel_upsample)
    qconv.set_use_int8_decode(config.kernels.int8_vae_decode)
    alpha = float(config.kernels.int8_smooth_alpha)
    qconv.set_int8_smooth_alpha(alpha if alpha > 0.0 else None)

    # ---- models ----
    pipe = build_pipeline(config, dtype, tiny, dev)
    aux = (pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model)
    for module in aux:
        module.requires_grad_(False)
    full_ft = not config.use_lora
    if full_ft:
        pipe.reference_unet = frozen_copy(pipe.unet)

    # ---- place the weights on the mesh (the JAX runner's order) ----
    if use_tp:  # the UNet width-sharded over the model axis, the rest replicated
        for unet in (pipe.unet, pipe.reference_unet):
            if unet is not None:
                shard_unet_tp(unet, model_index(), mesh.model, model_group())
    elif use_fsdp:  # the frozen suite sharded over the data axis
        frozen_unet = pipe.reference_unet if full_ft else pipe.unet
        for module in (frozen_unet,) + aux:
            shard_module_fsdp(module, data_group())
    offload = HostOffload(aux) if config.offload_aux_during_update else None
    tok1, tok2, tok_r = make_clip_tokenizers(
        config.pretrained.bpe_path, vocab_size=pipe.te1.config.vocab_size, with_reward=True)
    # per-data-index prompt streams; train.batch_size is per data index too
    loader = PromptLoader(PromptDataset(config.prompt_json or None), config.sample.batch_size,
                          tok1, tok2, reward_tokenizer=tok_r, seed=host_fold(config.seed))

    # ---- trainer, optimizer, state ----
    ocfg = OnlinePSOConfig(
        sampler=sampler, num_steps=config.sample.num_steps, beta=config.train.beta,
        eps=config.train.eps, train_batch_size=config.train.batch_size,
        grad_accum=config.train.gradient_accumulation_steps,
        num_inner_epochs=config.train.num_inner_epochs,
        compare="sample" if sampler == "turbo" else "pareto",
        clamp_mode=config.train.clamp_mode,
        shared_noise=bool(config.sample.get("shared_noise", True)),
        num_train_timesteps=train_timesteps(config),
        # policy and reference run different weights under full finetuning
        fuse_ref_pass=bool(config.train.fuse_ref_pass) and not full_ft,
        full_finetune=full_ft, int8_ref_pass=bool(config.train.int8_ref_pass))
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
    # every rank starts from its data axis's first rank's state (the weights
    # are the same seed's; the model ranks hold different slices)
    broadcast_train_state_(state, data_group())

    # ---- validation: its prompts where it will fire; the CLIP scorer when it
    # first fires (at full width ~2 GB a run without validation need not hold) ----
    per_epoch = (config.sample.batch_size * config.sample.num_batches_per_epoch
                 // (config.train.batch_size * config.train.gradient_accumulation_steps)
                 * config.train.num_inner_epochs)
    steps = range(state.step + 1, state.step + 1 + per_epoch * epochs)
    val_prompts, clip_scorer = None, None
    if config.validation_steps and any(s % config.validation_steps == 0 for s in steps):
        val_prompts = validation_prompts(config)

    # a sharded forward needs every rank: then all of them validate
    validators = world > 1 and (use_tp or use_fsdp)

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
                                 os.path.join(out_dir, f"val-{step}") if is_main else None)
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
            with profile_to(config.profile_dir if epoch == profile_epoch and is_main else None,
                            dev, f"epoch-{epoch}"):
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
                rewards = process_allgather(samples["rewards"].float(),
                                            data_group()).flatten(0, 1)
                metrics_logger.log_metrics({"epoch": epoch, "reward_mean": rewards.mean(),
                                            "reward_std": rewards.std(unbiased=False)}, state.step)

                # ---------------- training ----------------
                global_step = state.step
                moves = {}
                if offload is not None:
                    with timer.phase("offload"):
                        offload.to_host()
                with timer.phase("train"):
                    state, step_metrics = trainer.train_epoch(state, samples, cond, shuffle_gen,
                                                              len(all_samples))
                if offload is not None:
                    with timer.phase("reload"):
                        offload.to_device()
                    moves = {"offload_bytes": offload.nbytes()}
                for m in step_metrics:
                    global_step += 1
                    metrics_logger.log_metrics({**m, **moves, **timer.summary()}, global_step)
                    history.append(m)
                    validating = bool(config.validation_steps
                                      and global_step % config.validation_steps == 0)
                    saving = bool(config.checkpointing_steps and (
                        global_step % config.checkpointing_steps == 0 or global_step == 1))
                    if validating and (is_main or validators):
                        validate(global_step)
                    # whole tensors: under tensor parallelism every rank gathers them
                    blob = train_state_blob(state) if saving and use_tp else None
                    if is_main and saving:
                        # the state after the whole epoch, under the update's step
                        # number, as the JAX runner saves it
                        path = save_train_state(out_dir, global_step, state, {"epoch": epoch},
                                                blob)
                        if not full_ft:  # the adapter for diffusers beside it
                            lora_dir = os.path.join(out_dir, f"lora-{global_step}")
                            os.makedirs(lora_dir, exist_ok=True)
                            export_lora_safetensors(blob["lora"] if blob else pipe.unet,
                                                    os.path.join(lora_dir, LORA_FILE))
                        prune_checkpoints(out_dir, int(config.num_checkpoint_limit))
                        logger.info("saved state to %s", path)
                    if validating or saving:  # the other ranks wait for rank 0's work
                        barrier()
                timer.reset()
    finally:
        metrics_logger.close()
    return state, history, pipe
