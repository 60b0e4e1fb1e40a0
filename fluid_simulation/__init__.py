"""fluid_simulation — a JAX (XLA + Pallas) 3-D incompressible wind-tunnel
fluid framework for the GPU.

Re-implements every capability of the reference C++/OpenMP solver
(Ghundi/fluid_simulation) as a pure-functional JAX program: Stam-style stable
fluids (inlet forcing -> diffuse -> project -> advect -> project) over a padded
``(D+2, H+2, W+2)`` float32 grid with a voxelized obstacle mask, plus geometry
ingestion (STL), frame dump I/O in the reference's exact binary contract,
visualization (slice viewer, iso-surface + streamlines), checkpoint/resume,
batched design sweeps (``vmap``) and multi-device spatial sharding
(``shard_map`` + halo exchange).

Quick start::

    from fluid_simulation import WindTunnel, SimParams
    wt = WindTunnel(SimParams(width=128, height=64, depth=64))
    final_state, stats = wt.simulate(steps=100)
"""

from fluid_simulation.config import SimParams, SceneParams
from fluid_simulation.models.windtunnel import (
    WindTunnel,
    FluidState,
    init_state,
    simulation_step,
    simulate,
)

__version__ = "0.1.0"

__all__ = [
    "SimParams",
    "SceneParams",
    "WindTunnel",
    "FluidState",
    "init_state",
    "simulation_step",
    "simulate",
]
