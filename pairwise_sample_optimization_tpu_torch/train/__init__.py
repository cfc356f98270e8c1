"""Trajectory sampling (the trainer is not ported yet)."""

from .sampling import Trajectory, sample_turbo_trajectories
