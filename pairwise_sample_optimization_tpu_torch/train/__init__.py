"""Trajectory sampling, the PSO losses, the train state, the online and the
DreamBooth trainers."""

from .dreambooth_pso import DreamBoothPSOConfig, DreamBoothPSOTrainer
from .losses import dreambooth_pso_loss, pareto_compare, pso_pairwise_loss, sample_compare
from .online_pso import OnlinePSOConfig, OnlinePSOTrainer
from .sampling import (Trajectory, sample_ddim_cfg_trajectories, sample_dmd_trajectories,
                       sample_turbo_trajectories)
from .train_state import (PSOTrainState, all_parameters, lora_parameters, make_lr_schedule,
                          make_optimizer)
