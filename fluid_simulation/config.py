"""Typed configuration for solver, scene, and viewers.

The reference hardcodes everything (grid in ``simulation.cpp:431-435``, physics
defaults in ``simulation.h:59-64``, viewer dims hand-synced in three places —
``GUI/config.py:8-11``, ``gui.py:32-34``, ``make_pngs.py:7-8``). Here a single
frozen dataclass is shared by the solver, the dump writer (which records it in
a JSON sidecar) and every viewer, so dimensions can never go out of sync.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters (hashable -> usable as a jit static arg).

    Defaults mirror the reference ctor defaults (``simulation.h:59-64``):
    ``speed=30, dt=0.05, diff=2e-5, visc=1.5e-5, acc=15``. ``visc`` is carried
    for API parity but — like the reference, where it is never read — compat
    mode diffuses velocity with ``diff`` (``simulation.cpp:278-284``).
    """

    width: int = 128   # interior cells along x (simulation.cpp:432)
    height: int = 64   # interior cells along y
    depth: int = 64    # interior cells along z

    dt: float = 0.05
    diff: float = 2.0e-5
    visc: float = 1.5e-5
    acc: int = 15              # linear-solver sweeps per solve
    speed: float = 30.0        # inlet x-velocity (simulation.cpp:105)
    inlet_density: float = 0.001  # added per step on the x=1 plane (simulation.cpp:64-67)

    # 'jacobi'       — Jacobi relaxation (fully parallel, deterministic)
    # 'rbgs'         — red-black Gauss-Seidel (default; tracks 1-thread GS closely)
    # 'gs_wavefront' — hyperplane-ordered Gauss-Seidel, numerically identical to
    #                  the reference's sequential sweep (simulation.cpp:258-270);
    #                  O(W+H+D) sequential stages, for parity tests only.
    solver: str = "rbgs"

    # 'compat' — replicate reference step() semantics exactly (sequential
    #            per-component advection chain, simulation.cpp:125-127).
    # 'fast'   — simultaneous trilinear advection: one shared backtrace
    #            through the projected field (standard stable-fluids).
    # 'split'  — operator-split advection: three 1-D lerp passes per field
    #            (ops/advect.py::advect_split_jnp).
    mode: str = "compat"

    # Use the compat velocity-diffusion coefficient (diff) or honor visc.
    use_visc_for_velocity: bool = False

    # Vorticity confinement strength (0 = off). Extension beyond the reference
    # (BASELINE.json config 3); standard Fedkiw et al. confinement force.
    vorticity: float = 0.0

    # 'reference' — x- inlet mirror / x+ outflow / mirrored y,z for their own
    #               components only (simulation.cpp:183-215).
    # 'noslip'    — all tangential+normal velocity zero at y/z walls
    #               (BASELINE.json config 3).
    wall_mode: str = "reference"

    # Compute dtype for the fields ('float32' | 'bfloat16'). The reference is
    # f32; bf16 carries ~3 decimal digits.
    dtype: str = "float32"

    # Run each red-black sweep as one fused GPU kernel
    # (kernels/rbgs_sweep.py). It runs whenever JAX's backend is the GPU;
    # on the CPU (tests) the jnp sweep runs.
    use_pallas: bool = True

    # Compute the max-|divergence| residual in StepStats (an extra stencil
    # pass per step; the reference computes no residual at all). Density sums
    # are always collected.
    div_stats: bool = True

    # Collect the per-step density sum in StepStats. The reference only sums
    # density on the host every 100 steps (simulation.cpp:73-77), so
    # throughput-focused runs can turn the per-step reduction off
    # (StepStats.density_sum becomes NaN; end-of-run stats via
    # WindTunnel.density_sum()/field_ranges() are unaffected).
    step_stats: bool = True

    # Sharded runs only: advection z-reads exchange this many neighbor slabs
    # per side instead of all-gathering the full field, with an automatic
    # runtime fallback to all-gather whenever a backtrace reaches further
    # (exact either way; parallel/sharded.py::_z_lerp_dispatch). 0 = always
    # all-gather.
    advect_halo_slabs: int = 1

    # Set automatically by WindTunnel when the obstacle field is empty: every
    # obstacle-mask multiply is then an exact multiply-by-1.0 identity, so
    # the full-array passes are skipped statically (numerically identical —
    # x*1.0 == x for every f32 including -0/inf/NaN). Never set it for a
    # scene that has solids.
    empty_scene: bool = False

    # Set by design_sweep's vmap and map routes: the step runs over a
    # geometry batch. It selects the inlet formulation
    # (models/windtunnel.py::_apply_inlets) that keeps the routes bitwise
    # equal to each other.
    batched: bool = False

    @property
    def interior_shape(self) -> Tuple[int, int, int]:
        """(D, H, W) — z-major so x is the fastest/lane axis."""
        return (self.depth, self.height, self.width)

    @property
    def padded_shape(self) -> Tuple[int, int, int]:
        """(D+2, H+2, W+2) incl. the 1-cell ghost shell (simulation.cpp:35)."""
        return (self.depth + 2, self.height + 2, self.width + 2)

    @property
    def n_cells(self) -> int:
        return self.width * self.height * self.depth

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SimParams":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Obstacle placement, mirroring ``loadSTLIntoObstacles``'s signature
    (``simulation.h:94-104``): mesh path + scale + Euler rotation + translate.
    """

    stl_path: Optional[str] = None
    scale: float = 1.0
    rot_x: float = 0.0
    rot_y: float = 0.0
    rot_z: float = 0.0
    translate_x: float = 0.0
    translate_y: float = 0.0
    translate_z: float = 0.0

    # 'bbox_center' rotates about the true bounding-box midpoint;
    # 'origin' replicates the reference behavior where objCenter is always
    # (0,0,0) because the min/max sentinels are never updated
    # (object_loader.cpp:288-296).
    rotation_center: str = "origin"

    # 'rasterize' — deterministic triangle rasterization + parity fill (default)
    # 'ray_parity' — per-point jittered ray casting like the reference
    #                (object_loader.cpp:396-448)
    voxelizer: str = "rasterize"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


# Shared viewer defaults (GUI/config.py:21-25), as an explicit dataclass
# instead of mutable module globals.
@dataclasses.dataclass
class ViewerParams:
    streamline_density: int = 30
    streamline_proximity: float = 2.0
    integration_steps: int = 100
    integration_step_size: float = 0.2
    velocity_change_threshold: float = 0.1
