"""Vorticity confinement (Fedkiw, Stam & Jensen 2001).

Extension over the reference (BASELINE.json config 3): semi-Lagrangian
advection is diffusive and smears small-scale swirls; the confinement force
``f = eps * h * (N x omega)`` re-injects them. Pure jnp, central differences on
the interior, zero in/near solids.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from fluid_simulation.scene.masks import SceneMasks


def _central(f, axis):
    """Central difference of a padded field over the interior (unit spacing)."""
    if axis == 0:   # z
        return 0.5 * (f[2:, 1:-1, 1:-1] - f[:-2, 1:-1, 1:-1])
    if axis == 1:   # y
        return 0.5 * (f[1:-1, 2:, 1:-1] - f[1:-1, :-2, 1:-1])
    return 0.5 * (f[1:-1, 1:-1, 2:] - f[1:-1, 1:-1, :-2])  # x


def _pad(interior, like):
    return jnp.zeros_like(like).at[1:-1, 1:-1, 1:-1].set(interior)


def confinement_force(vx, vy, vz, masks: SceneMasks, eps: float, dt: float):
    """Return (fx, fy, fz) interior force fields scaled by dt, ready to add."""
    dtype = vx.dtype

    # omega = curl(v), interior values then re-padded so the |omega| gradient
    # can itself be taken with central differences.
    wx_i = _central(vz, 1) - _central(vy, 0)
    wy_i = _central(vx, 0) - _central(vz, 2)
    wz_i = _central(vy, 2) - _central(vx, 1)

    mag_i = jnp.sqrt(wx_i * wx_i + wy_i * wy_i + wz_i * wz_i)
    mag = _pad(mag_i, vx)

    gx = _central(mag, 2)
    gy = _central(mag, 1)
    gz = _central(mag, 0)
    norm = jnp.sqrt(gx * gx + gy * gy + gz * gz) + jnp.asarray(1e-5, dtype)
    nx, ny, nz = gx / norm, gy / norm, gz / norm

    # f = eps * (N x omega); keep out of solids and their no-slip ring.
    keep = masks.keep_vel[1:-1, 1:-1, 1:-1]
    s = jnp.asarray(np.float32(eps) * np.float32(dt), dtype) * keep
    fx = s * (ny * wz_i - nz * wy_i)
    fy = s * (nz * wx_i - nx * wz_i)
    fz = s * (nx * wy_i - ny * wx_i)
    return fx, fy, fz


def apply_confinement(vx, vy, vz, masks: SceneMasks, eps: float, dt: float):
    if eps == 0.0:
        return vx, vy, vz
    fx, fy, fz = confinement_force(vx, vy, vz, masks, eps, dt)
    vx = vx.at[1:-1, 1:-1, 1:-1].add(fx)
    vy = vy.at[1:-1, 1:-1, 1:-1].add(fy)
    vz = vz.at[1:-1, 1:-1, 1:-1].add(fz)
    return vx, vy, vz
