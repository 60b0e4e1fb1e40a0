"""Pressure projection (Chorin/Stam) with obstacle-aware stencils.

Mirrors ``Simulation::project`` (simulation.cpp:289-362):

1. ``h = 1/cbrt(W*H*D)`` (simulation.cpp:295).
2. Divergence: central differences that *skip* neighbors which are solid or
   out of the interior (simulation.cpp:297-316); ``div = -0.5*h*sum``;
   zero inside solids; ``p = 0``.
3. ``setBounds(0, div)``, ``setBounds(0, p)``; Poisson solve via the linear
   solver with ``a=1, c=6`` (simulation.cpp:318-320).
4. Gradient subtraction: central ``/2h`` where both neighbors are valid fluid,
   one-sided ``/h`` where only one is, zero otherwise (simulation.cpp:322-357);
   solids untouched; then ``setBounds(1/2/3, v)``.

All neighbor-validity branches are the precomputed ``nb_*`` masks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from fluid_simulation.ops.bounds import set_bounds
from fluid_simulation.ops.linsolve import linear_solver
from fluid_simulation.scene.masks import SceneMasks


def grid_h(width: int, height: int, depth: int) -> float:
    """Mesh spacing ``1/cbrt(W*H*D)`` in f32 (simulation.cpp:295)."""
    return float(np.float32(1.0) / np.cbrt(np.float32(width * height * depth)))


def divergence(vx, vy, vz, masks: SceneMasks, h: float,
               empty_scene: bool = False) -> jnp.ndarray:
    """Obstacle-aware divergence as a padded field (zero ghost shell, zero in
    solids), matching simulation.cpp:297-316 before its setBounds."""
    dtype = vx.dtype
    hh = jnp.asarray(np.float32(-0.5) * np.float32(h), dtype)
    div_val = (
        vx[1:-1, 1:-1, 2:] * masks.nb_xp - vx[1:-1, 1:-1, :-2] * masks.nb_xm
        + vy[1:-1, 2:, 1:-1] * masks.nb_yp - vy[1:-1, :-2, 1:-1] * masks.nb_ym
        + vz[2:, 1:-1, 1:-1] * masks.nb_zp - vz[:-2, 1:-1, 1:-1] * masks.nb_zm
    )
    div_i = hh * div_val if empty_scene else hh * div_val * masks.fluid_i
    return jnp.zeros_like(vx).at[1:-1, 1:-1, 1:-1].set(div_i)


def _one_axis_gradient(p, mask_p, mask_m, shift_p, shift_m, h, dtype):
    """Branch-free version of the central/one-sided/zero gradient selection
    (simulation.cpp:329-335 and analogues)."""
    inv_h = jnp.asarray(np.float32(1.0) / np.float32(h), dtype)
    inv_2h = jnp.asarray(np.float32(1.0) / (np.float32(2.0) * np.float32(h)), dtype)
    p_i = p[1:-1, 1:-1, 1:-1]
    p_p = shift_p(p)
    p_m = shift_m(p)
    both = mask_p * mask_m
    central = (p_p - p_m) * inv_2h
    fwd = (p_p - p_i) * inv_h
    bwd = (p_i - p_m) * inv_h
    return both * central + (mask_p - both) * fwd + (mask_m - both) * bwd


def project(
    vx: jnp.ndarray,
    vy: jnp.ndarray,
    vz: jnp.ndarray,
    masks: SceneMasks,
    acc: int = 15,
    solver: str = "rbgs",
    wall_mode: str = "reference",
    use_pallas: bool = False,
    empty_scene: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Make the velocity field (approximately) divergence-free.

    Returns ``(vx, vy, vz, pressure, divergence)`` — pressure/divergence are
    returned for observability (the reference keeps them as member arrays).
    """
    dtype = vx.dtype
    D2, H2, W2 = vx.shape
    W, H, D = W2 - 2, H2 - 2, D2 - 2
    h = grid_h(W, H, D)

    div = divergence(vx, vy, vz, masks, h, empty_scene)
    p = jnp.zeros_like(vx)

    div = set_bounds(0, div, masks, wall_mode, empty_scene)
    p = set_bounds(0, p, masks, wall_mode, empty_scene)
    p = linear_solver(0, p, div, 1.0, 6.0, masks, acc=acc, solver=solver,
                      wall_mode=wall_mode, use_pallas=use_pallas,
                      empty_scene=empty_scene)

    grad_x = _one_axis_gradient(
        p, masks.nb_xp, masks.nb_xm,
        lambda q: q[1:-1, 1:-1, 2:], lambda q: q[1:-1, 1:-1, :-2], h, dtype)
    grad_y = _one_axis_gradient(
        p, masks.nb_yp, masks.nb_ym,
        lambda q: q[1:-1, 2:, 1:-1], lambda q: q[1:-1, :-2, 1:-1], h, dtype)
    grad_z = _one_axis_gradient(
        p, masks.nb_zp, masks.nb_zm,
        lambda q: q[2:, 1:-1, 1:-1], lambda q: q[:-2, 1:-1, 1:-1], h, dtype)

    # Solid cells are skipped by the reference (simulation.cpp:326) — masking
    # the gradient leaves them untouched here too (setBounds zeroes them next).
    if empty_scene:
        vx = vx.at[1:-1, 1:-1, 1:-1].add(-grad_x)
        vy = vy.at[1:-1, 1:-1, 1:-1].add(-grad_y)
        vz = vz.at[1:-1, 1:-1, 1:-1].add(-grad_z)
    else:
        fl = masks.fluid_i
        vx = vx.at[1:-1, 1:-1, 1:-1].add(-grad_x * fl)
        vy = vy.at[1:-1, 1:-1, 1:-1].add(-grad_y * fl)
        vz = vz.at[1:-1, 1:-1, 1:-1].add(-grad_z * fl)

    vx = set_bounds(1, vx, masks, wall_mode, empty_scene)
    vy = set_bounds(2, vy, masks, wall_mode, empty_scene)
    vz = set_bounds(3, vz, masks, wall_mode, empty_scene)
    return vx, vy, vz, p, div
