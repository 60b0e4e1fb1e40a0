"""Multi-device scaling: device meshes and the spatially-sharded solver.

The reference's only parallelism is OpenMP worksharing in one address space
(simulation.cpp:98). The multi-device analogs (SURVEY.md §2 "parallelism
strategies", §5 "long-context analog"):

- **spatial domain decomposition** over the z axis (the CFD analog of
  sequence/context parallelism): each device owns a z-slab plus a 1-cell
  ghost layer, exchanged with ``lax.ppermute`` between relaxation
  half-sweeps;
- **batch parallelism** over scenes (the data-parallel analog) via a
  ``batch`` mesh axis + ``vmap``.

The sharded step is numerically identical to the single-device step up to
compiler FMA-contraction (verified at ulp level in tests/test_sharding.py on
a virtual 8-device CPU mesh).
"""

from fluid_simulation.parallel.mesh import make_mesh
from fluid_simulation.parallel.sharded import (
    ShardedWindTunnel, simulate_sharded, split_padded, stitch_padded)

__all__ = ["make_mesh", "ShardedWindTunnel", "simulate_sharded",
           "split_padded", "stitch_padded"]
