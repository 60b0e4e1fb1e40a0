"""Model layer: complete simulation setups built from the ops layer.

- ``windtunnel`` — the flagship model: the reference's full scene loop
  (inlet forcing -> diffuse -> project -> advect -> project -> density pass,
  simulation.cpp:49-150) as one jitted step under ``lax.scan``.
- ``sweep`` — vmapped batch of scenes for parallel design sweeps
  (BASELINE config 4).
"""

from fluid_simulation.models.windtunnel import (
    FluidState,
    WindTunnel,
    init_state,
    simulation_step,
    simulate,
)
from fluid_simulation.models.sweep import design_sweep

__all__ = [
    "FluidState",
    "WindTunnel",
    "init_state",
    "simulation_step",
    "simulate",
    "design_sweep",
]
