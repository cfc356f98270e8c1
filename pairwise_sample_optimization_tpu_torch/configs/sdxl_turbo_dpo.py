"""Online PSO SDXL-Turbo config: the JAX package's
``configs/sdxl_turbo_dpo.py`` knob tree, without its TPU kernel-routing
knobs (on CUDA the port always takes its kernels).

The memory knobs are the JAX package's: ``use_lora=False`` (full
finetuning), ``param_dtype``, ``activation_checkpoint`` (every remat mode),
``offload_aux_during_update``, ``vae_decode_chunk`` and
``kernels.gelu_exact``; ``profile_dir`` (a ``torch.profiler`` trace of
one epoch) and ``use_wandb`` run as there. Knobs the port does not
implement yet are kept so launch scripts parse, and
``cli.online_runner.check_config`` refuses a non-default value: ``mesh.*``
beyond one device, ``mesh.fsdp``, ``fast_init``, ``train.int8_ref_pass``
and the int8 and subpixel ``kernels.*`` options.
"""

from . import Config


def get_config() -> Config:
    c = Config()

    # ---- general ----
    c.run_name = ""
    c.seed = 0
    c.logdir = "logging"
    c.output_dir = "output"
    c.num_epochs = 10000
    c.checkpointing_steps = 100
    c.num_checkpoint_limit = 10
    # compute dtype of the towers; LoRA and Adam state stay fp32
    c.mixed_precision = "bf16"  # "bf16" | "no"
    # storage dtype of the UNet's weights: "float32" keeps fp32 masters of a
    # fully trained UNet (use_lora=False), "bfloat16" stores it in bf16; the
    # other towers are stored in the compute dtype
    c.param_dtype = "float32"
    # UNet activation checkpointing: "full" | "resnets" | "dots" | "lowres" |
    # "lowres_dots" | "" or "none" (off); see models/unet.py
    c.activation_checkpoint = "full"
    # the VAE, the scorer and the text encoders in pinned host memory while
    # the update runs
    c.offload_aux_during_update = False
    # latents a VAE decoder call (0: the whole batch)
    c.vae_decode_chunk = 0
    c.tiny_model = False  # toy 2-level models end to end (CPU tests)
    c.fast_init = False
    c.profile_dir = ""
    c.resume_from = ""  # run dir or exact checkpoint-<step> dir
    c.use_lora = True  # False: train every UNet weight (full finetuning)
    c.use_wandb = False

    # ---- validation: 4-step images of the first val_max_prompts prompts of
    # val_dataset ("hf:<local save_to_disk dir>" with val_split_name, a local
    # prompts file, else the built-in set) every validation_steps updates ----
    c.val_dataset = "pickapic_test_unique"
    c.val_split_name = "test_unique"
    c.val_max_prompts = 500
    c.validation_steps = 100

    # ---- pretrained: a local diffusers checkpoint dir (unet/, vae/,
    # text_encoder/, text_encoder_2/), a separate VAE (dir or file) and an HF
    # CLIPModel for PickScore; empty: architecture-true random weights ----
    c.pretrained = p = Config()
    p.model_dir = ""
    p.vae_dir = ""
    p.pickscore_dir = ""
    p.bpe_path = ""

    # ---- mesh (one device) ----
    c.mesh = m = Config()
    m.data = -1
    m.model = 1
    m.fsdp = False

    # ---- sampling ----
    c.sample = s = Config()
    s.num_steps = 4
    s.eta = 1.0
    s.guidance_scale = 0.0
    s.batch_size = 4
    s.num_batches_per_epoch = 4
    s.resolution = 512

    # ---- training ----
    c.train = t = Config()
    t.lora_rank = 32
    t.distilled_train_steps = 3  # == sample.num_steps - 1
    t.batch_size = 4
    t.learning_rate = 1e-5
    t.adam_beta1 = 0.9
    t.adam_beta2 = 0.999
    t.adam_weight_decay = 1e-6
    t.adam_epsilon = 1e-8
    t.gradient_accumulation_steps = 2
    t.max_grad_norm = 1.0
    t.num_inner_epochs = 1
    t.beta = 50.0
    t.eps = 0.1
    t.clamp_mode = "ratio"  # "ratio" (reference parity) | "logratio" | "none"
    t.optimizer_state_dtype = ""  # "" (fp32) | "bfloat16" (bf16 first moments)
    # block-quantized int8-moment AdamW (takes precedence over the state dtype)
    t.use_8bit_adam = False
    # fuse policy and reference passes into one 4x-batch call with a
    # per-sample LoRA scale (False: a separate grad-free reference pass)
    t.fuse_ref_pass = False
    t.int8_ref_pass = False

    # ---- kernel options of the JAX package (the int8 and subpixel ones not
    # ported) ----
    c.kernels = k = Config()
    k.subpixel_upsample = False
    k.int8_vae_decode = False
    k.int8_smooth_alpha = 0.0
    k.gelu_exact = False  # the exact erf GELU in bf16 too

    # ---- data ----
    # training prompts: a JSON list of {caption: ...}, a .txt, "4k" for the
    # packaged PickaPic set, or "" for the built-in 16 prompts
    c.prompt_json = ""
    c.prompt_fn = "simple_animals"  # legacy registry (unused)
    c.reward_fn = "pick_score"  # the runner scores with PickScore

    # ---- schema parity with the reference config (parsed, never consumed) ----
    c.per_prompt_stat_tracking = ppst = Config()
    ppst.buffer_size = 16
    ppst.min_count = 16
    s.eval_batch_size = 10
    s.eval_epoch = 10
    s.save_interval = 100
    t.timestep_fraction = 1.0
    t.adv_clip_max = 5
    t.clip_range = 1e-4
    t.save_interval = 100
    c.kl_ratio = 0.01
    return c
