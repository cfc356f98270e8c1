"""Online PSO SDXL-Turbo config: the JAX package's
``configs/sdxl_turbo_dpo.py`` knob tree, without its TPU kernel-routing
knobs (on CUDA the port always takes its kernels).

Knobs the port does not implement yet are kept so launch scripts parse,
and ``cli.online_runner.check_config`` refuses a non-default value:
``param_dtype``, ``mesh.*`` beyond one device, ``mesh.fsdp``,
``offload_aux_during_update``, ``use_wandb``, ``fast_init``,
``profile_dir``, ``use_lora=False``, ``train.int8_ref_pass``,
``train.use_8bit_adam``, ``train.optimizer_state_dtype``, the
``kernels.*`` options and non-empty ``pretrained.*_dir``.
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
    # compute and storage dtype of the frozen towers; LoRA and Adam state stay fp32
    c.mixed_precision = "bf16"  # "bf16" | "no"
    # storage dtype of the frozen towers in the JAX package; the port stores
    # them in the compute dtype (mixed_precision), and refuses "bfloat16"
    c.param_dtype = "float32"
    # UNet activation checkpointing: "full" | "" or "none" (off); the
    # selective modes ("resnets", "dots", "lowres", "lowres_dots") are not
    # ported and the UNet refuses them
    c.activation_checkpoint = "full"
    c.offload_aux_during_update = False
    c.tiny_model = False  # toy 2-level models end to end (CPU tests)
    c.fast_init = False
    c.profile_dir = ""
    c.resume_from = ""  # run dir or exact checkpoint-<step> dir
    c.use_lora = True
    c.use_wandb = False

    # ---- validation (not ported: a validation step that would fire raises) ----
    c.val_dataset = "pickapic_test_unique"
    c.val_split_name = "test_unique"
    c.val_max_prompts = 500
    c.validation_steps = 100

    # ---- pretrained (empty: architecture-true random weights from seed) ----
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
    t.optimizer_state_dtype = ""  # only "" (fp32) is ported
    t.use_8bit_adam = False
    # fuse policy and reference passes into one 4x-batch call with a
    # per-sample LoRA scale (False: a separate grad-free reference pass)
    t.fuse_ref_pass = False
    t.int8_ref_pass = False

    # ---- kernel options of the JAX package (none ported) ----
    c.kernels = k = Config()
    k.subpixel_upsample = False
    k.int8_vae_decode = False
    k.int8_smooth_alpha = 0.0
    k.gelu_exact = False

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
