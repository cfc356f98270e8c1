"""Metrics logging and phase timers."""

from .logging import MetricLogger, get_logger
from .timers import PhaseTimer

__all__ = ["MetricLogger", "PhaseTimer", "get_logger"]
