"""Online PSO on SDXL-Turbo.

    python -m pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo \
        [--tiny] [--device cpu] [--epochs N] [key=value ...]

Runs ``cli.online_runner.run_online_pso`` with the
``configs/sdxl_turbo_dpo.py`` defaults and dotted overrides such as
``train.beta=25 sample.batch_size=2``. ``--tiny`` selects the toy 2-level
models at 16x16 with one pair batch of 2 prompts per epoch (a CPU run of a
few seconds); the device is CUDA unless ``--device cpu`` is given.

Data-parallel over N cards of one machine:

    torchrun --nproc_per_node=N -m \
        pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo [key=value ...]

Each rank runs on ``cuda:LOCAL_RANK`` (NCCL); ``sample.batch_size`` and
``train.batch_size`` are per data index. With ``--device cpu`` the ranks
talk over gloo. ``mesh.model=M`` (M dividing N) adds tensor parallelism of
the UNet over groups of M consecutive ranks; ``mesh.fsdp=True`` shards the
frozen weights over the N ranks instead, e.g.

    torchrun --nproc_per_node=4 -m \
        pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo mesh.model=2
"""

from __future__ import annotations

import argparse

from ..configs.sdxl_turbo_dpo import get_config
from ..parallel import shutdown_distributed
from .online_runner import check_cli_train_steps, run_online_pso

TINY_OVERRIDES = (
    "tiny_model=True", "sample.resolution=16", "sample.batch_size=2",
    "sample.num_batches_per_epoch=1", "train.batch_size=2",
    "train.gradient_accumulation_steps=1", "train.lora_rank=4", "mixed_precision=no",
)


def build_config(tiny: bool = False, overrides=()):
    config = get_config()
    for item in (TINY_OVERRIDES if tiny else ()) + tuple(overrides):
        config.override(item)
    if not config.run_name:
        t = config.train
        eff_bs = t.gradient_accumulation_steps * t.batch_size
        spe = config.sample.num_batches_per_epoch * config.sample.batch_size
        config.run_name = (f"SDXL_Turbo{config.sample.num_steps}_PS_{spe}sample_perhost"
                           f"_lorarank{t.lora_rank}_lr{t.learning_rate}_beta{t.beta}_bs{eff_bs}")
    return config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="toy models (CPU runs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=None, help="default: config.num_epochs")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = ap.parse_args(argv)
    config = build_config(args.tiny, args.overrides)
    check_cli_train_steps(config)
    run_online_pso(config, sampler="turbo", num_epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
