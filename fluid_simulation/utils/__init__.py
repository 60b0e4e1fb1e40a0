"""Utilities: structured logging, timers, and profiler hooks."""

from fluid_simulation.utils.logging import get_logger, StepLogger
from fluid_simulation.utils.profiling import Timer, trace_ctx

__all__ = ["get_logger", "StepLogger", "Timer", "trace_ctx"]
