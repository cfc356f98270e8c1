"""Trajectory sampling, the PSO losses, the train state and the online trainer."""

from .losses import pareto_compare, pso_pairwise_loss, sample_compare
from .online_pso import OnlinePSOConfig, OnlinePSOTrainer
from .sampling import Trajectory, sample_turbo_trajectories
from .train_state import PSOTrainState, lora_parameters, make_lr_schedule, make_optimizer
