"""Pure-functional solver operators (the jnp oracle).

Each operator mirrors one reference routine, quirks included — these quirks are
observable behavior, not bugs to fix silently (see SURVEY.md §7):

- ``bounds.set_bounds``     <-> ``Simulation::setBounds``    (simulation.cpp:183-246)
- ``linsolve.linear_solver``<-> ``Simulation::linearSolver`` (simulation.cpp:251-273)
- ``linsolve.diffuse``      <-> ``Simulation::diffuse``      (simulation.cpp:278-284)
- ``project.project``       <-> ``Simulation::project``      (simulation.cpp:289-362)
- ``advect.advect``         <-> ``Simulation::advect``       (simulation.cpp:367-424)
"""

from fluid_simulation.ops.bounds import set_bounds
from fluid_simulation.ops.linsolve import linear_solver, diffuse, diffusion_coeffs
from fluid_simulation.ops.project import project
from fluid_simulation.ops.advect import advect

__all__ = [
    "set_bounds",
    "linear_solver",
    "diffuse",
    "diffusion_coeffs",
    "project",
    "advect",
]
