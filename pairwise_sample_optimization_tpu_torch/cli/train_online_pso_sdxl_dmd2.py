"""Online PSO on SDXL-DMD2: 1024^2, the fixed distillation lattice, DDPM
re-noise transitions, strict-dominance preference.

    python -m pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 \
        [--tiny] [--device cpu] [--epochs N] [key=value ...]

Runs ``cli.online_runner.run_online_pso(sampler="dmd")`` with the
``configs/sdxl_dmd_dpo.py`` defaults and dotted overrides such as
``train.beta=25 sample.shared_noise=False``. ``--tiny`` selects the toy
2-level models at 16x16 with one pair batch of 2 prompts per epoch (a CPU
run of a few seconds); the device is CUDA unless ``--device cpu`` is given.
``train.distilled_train_steps`` must equal ``sample.num_steps - 1``
(``online_runner.check_cli_train_steps`` refuses any other value, 0 too,
before any work; ``run_online_pso`` itself reads 0 as that).

Data-parallel over N cards of one machine:

    torchrun --nproc_per_node=N -m \
        pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 [key=value ...]

Each rank runs on ``cuda:LOCAL_RANK`` (NCCL); ``sample.batch_size`` and
``train.batch_size`` are per data index. With ``--device cpu`` the ranks
talk over gloo. ``mesh.model=M`` (M dividing N) adds tensor parallelism of
the UNet over groups of M consecutive ranks; ``mesh.fsdp=True`` shards the
frozen weights over the N ranks instead, e.g.

    torchrun --nproc_per_node=4 -m \
        pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 mesh.model=2
"""

from __future__ import annotations

import argparse

from ..configs.sdxl_dmd_dpo import get_config
from ..parallel import shutdown_distributed
from .online_runner import check_cli_train_steps, run_online_pso
from .train_online_pso_sdxl_turbo import TINY_OVERRIDES


def build_config(tiny: bool = False, overrides=()):
    config = get_config()
    for item in (TINY_OVERRIDES if tiny else ()) + tuple(overrides):
        config.override(item)
    if not config.run_name:
        t = config.train
        config.run_name = (f"SDXL_DMD{config.sample.num_steps}_PS_lorarank{t.lora_rank}"
                           f"_lr{t.learning_rate}_beta{t.beta}")
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
    run_online_pso(config, sampler="dmd", num_epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
