"""Metrics logging, phase timers and device traces."""

from .logging import MetricLogger, get_logger
from .timers import PhaseTimer, profile_to

__all__ = ["MetricLogger", "PhaseTimer", "get_logger", "profile_to"]
