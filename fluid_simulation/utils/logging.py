"""Logging/observability.

The reference's observability is ``std::cout`` (startup banner
simulation.cpp:51-53, density sum every 100 steps :73-77, final min/max
:81-90). This module reproduces those signals through a real logger and adds
per-step structured stats.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np


def get_logger(name: str = "fluid_simulation",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s",
                                         datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class StepLogger:
    """Periodic progress reporting like the reference's console output."""

    def __init__(self, every: int = 100, logger: Optional[logging.Logger] = None):
        self.every = every
        self.log = logger or get_logger()

    def banner(self, params):
        # "starting 3-D simulation: WxHxD steps = N" (simulation.cpp:51-53)
        self.log.info("starting 3-D simulation: %dx%dx%d",
                      params.width, params.height, params.depth)

    def step(self, i: int, density_sum: float, max_div: float = float("nan")):
        if (i + 1) % self.every == 0 and i > 0:
            self.log.info("step %d  density sum = %.6g  max|div| = %.3g",
                          i + 1, density_sum, max_div)

    def final_stats(self, state):
        # final min/max block (simulation.cpp:81-90)
        for name, f in (("density", state.dens), ("velocity x", state.vx),
                        ("velocity y", state.vy), ("velocity z", state.vz)):
            arr = np.asarray(f)
            self.log.info("%s  min = %.6g  max = %.6g",
                          name, arr.min(), arr.max())
