"""Boundary conditions as masked face updates.

Mirrors ``Simulation::setBounds`` (simulation.cpp:183-246) but as four
branch-free array passes instead of five OpenMP loops:

1. x-faces: the x=0 ghost plane mirrors (negated iff ``b==1``) the x=1 plane;
   the x=W+1 plane is **always** an outflow copy of x=W (simulation.cpp:191).
2. y-faces: mirror, negated iff ``b==2``.
3. z-faces: mirror, negated iff ``b==3``.
4. obstacle handling: zero inside solids; for velocity components also zero
   fluid cells 6-adjacent to a solid (staircase no-slip,
   simulation.cpp:218-245) — both folded into one precomputed multiplier.

Only the interior rectangle of each ghost face is written (y in 1..H,
z in 1..D for the x faces, etc.); ghost edges/corners are never touched and
stay zero for the life of the simulation, matching the reference, whose
ghost edges are only ever the ctor's zero-fill (simulation.cpp:38-43).

``wall_mode='noslip'`` (extension, BASELINE config 3) zeroes all velocity
components on the y/z walls instead of mirroring only the normal component.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluid_simulation.scene.masks import SceneMasks


def face_signs(b: int, wall_mode: str = "reference"):
    """(sx, sy, sz): the sign each face mirror applies to field ``b`` on
    the x-, y- and z-faces. The x+ outflow face is always an unsigned
    copy."""
    if b not in (0, 1, 2, 3):
        raise ValueError(f"b must be 0..3, got {b}")
    if wall_mode not in ("reference", "noslip"):
        raise ValueError(f"unknown wall_mode {wall_mode!r}")
    if wall_mode == "noslip" and b in (1, 2, 3):
        return (-1.0 if b == 1 else 1.0), -1.0, -1.0
    return ((-1.0 if b == 1 else 1.0), (-1.0 if b == 2 else 1.0),
            (-1.0 if b == 3 else 1.0))


def set_bounds(b: int, f: jnp.ndarray, masks: SceneMasks,
               wall_mode: str = "reference",
               empty_scene: bool = False) -> jnp.ndarray:
    """Apply boundary + obstacle conditions to a padded field.

    ``b`` is the reference's field tag: 0 scalar, 1/2/3 = x/y/z velocity
    component. Must be a static python int (it selects the face signs).
    ``wall_mode='noslip'`` negates every velocity component at the y/z
    walls; the x- inlet face still mirrors (negated only for vx) and x+
    stays an outflow copy so the tunnel remains open. ``empty_scene``
    statically skips the obstacle keep-multiply (an exact identity when the
    scene has no solids).
    """
    sx, sy, sz = face_signs(b, wall_mode)

    # x- mirror, x+ outflow copy (simulation.cpp:189-191)
    f = f.at[1:-1, 1:-1, 0].set(sx * f[1:-1, 1:-1, 1])
    f = f.at[1:-1, 1:-1, -1].set(f[1:-1, 1:-1, -2])
    # y faces (simulation.cpp:195-202)
    f = f.at[1:-1, 0, 1:-1].set(sy * f[1:-1, 1, 1:-1])
    f = f.at[1:-1, -1, 1:-1].set(sy * f[1:-1, -2, 1:-1])
    # z faces (simulation.cpp:205-215)
    f = f.at[0, 1:-1, 1:-1].set(sz * f[1, 1:-1, 1:-1])
    f = f.at[-1, 1:-1, 1:-1].set(sz * f[-2, 1:-1, 1:-1])

    # solid zeroing (+ no-slip ring for velocity), one fused multiply
    if empty_scene:
        return f
    keep = masks.keep_vel if b in (1, 2, 3) else masks.keep_scalar
    return f * keep
