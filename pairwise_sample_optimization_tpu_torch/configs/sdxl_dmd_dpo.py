"""Online PSO SDXL-DMD2 config: the JAX package's ``configs/sdxl_dmd_dpo.py``
on top of ``sdxl_turbo_dpo``: 1024^2, the fixed 4-step lattice
[999, 749, 499, 249], strict-dominance preference, LoRA rank 16.

Left out, as the Turbo config leaves it out: the JAX package's TPU
routing knob ``kernels.fused_groupnorm`` (on CUDA the port always takes its
GroupNorm+SiLU kernels). ``kernels.subpixel_upsample`` runs as in the JAX
package but stays off by default here, where the JAX config turns it on:
the port's default waits for a measurement on the card.
``vae_decode_chunk`` is 0, as the JAX config sets it.
"""

from . import Config, sdxl_turbo_dpo


def get_config() -> Config:
    config = sdxl_turbo_dpo.get_config()
    config.sample.resolution = 1024
    config.sample.num_steps = 4
    config.sample.batch_size = 2
    config.train.batch_size = 1
    config.train.distilled_train_steps = 3  # == sample.num_steps - 1
    config.train.lora_rank = 16
    config.train.gradient_accumulation_steps = 4
    config.train.fuse_ref_pass = False
    # the reference's quirk: each transition's noise is one draw shared by
    # the batch (per trajectory side of a pair, see train/online_pso.py)
    config.sample.shared_noise = True
    config.vae_decode_chunk = 0
    return config
