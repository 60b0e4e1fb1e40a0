"""Semi-Lagrangian advection (backtrace + trilinear gather).

Mirrors ``Simulation::advect`` (simulation.cpp:367-424):

- per-axis backtrace scaling ``x_back = i - dt*W*vx`` (the reference scales
  each axis by its own dimension, simulation.cpp:384-386);
- clamp to ``[0.5, N+0.5]`` (simulation.cpp:388-390), so corner samples can
  touch the ghost shell (always zero);
- trilinear sample of ``prev_field`` in the reference's lerp order
  (x, then y, then z — simulation.cpp:412-420);
- when advecting velocity component ``b``, that component's backtrace velocity
  comes from ``prev_field`` at the cell while the other two come from the
  *current* (already-updated) fields (simulation.cpp:380-382). The three
  velocity advects are therefore order-dependent — callers must chain them
  (x, then y, then z) like ``step()`` does (simulation.cpp:125-127);
- solid cells are forced to zero (simulation.cpp:375-378);
- ``setBounds(b, field)`` afterwards (simulation.cpp:423).

The scattered 8-corner gather is ONE ``lax.gather`` of 8-wide rows from a
corner table: ``tbl[i] = flat[i + d]`` for the 8 corner offsets ``d`` (built
with 8 shifted copies). Bit-identical to eight separate corner gathers; which
of the two is faster on the GPU has not been measured.

``advect_split_jnp`` is the operator-split variant (``mode='split'``): three
1-D lerp passes along x, then y, then z.
"""

from __future__ import annotations

import numpy as np
from jax import lax
import jax.numpy as jnp

from fluid_simulation.ops.bounds import set_bounds
from fluid_simulation.scene.masks import SceneMasks


def _lerp8(c000, c100, c010, c110, c001, c101, c011, c111, sx, sy, sz,
           dtype):
    """Trilinear lerp from 8 corner planes in the reference's order (x, then
    y, then z — simulation.cpp:412-420)."""
    one = jnp.asarray(1.0, dtype)
    c00 = c000 * (one - sx) + c100 * sx
    c01 = c001 * (one - sx) + c101 * sx
    c10 = c010 * (one - sx) + c110 * sx
    c11 = c011 * (one - sx) + c111 * sx
    c0 = c00 * (one - sy) + c10 * sy
    c1 = c01 * (one - sy) + c11 * sy
    return c0 * (one - sz) + c1 * sz


def trilinear_gather(prev: jnp.ndarray, xb, yb, zb) -> jnp.ndarray:
    """Trilinear sample of the padded field ``prev`` at backtraced coordinates
    (arrays shaped like the interior). Coordinates are in the reference's cell
    units where integer ``i`` is the center of interior cell ``i``; callers
    clamp them like simulation.cpp:388-390 (corner indices are then always
    in bounds: the largest corner is cell (D+1, H+1, W+1) = the last padded
    element)."""
    D2, H2, W2 = prev.shape
    i0 = jnp.floor(xb).astype(jnp.int32)
    j0 = jnp.floor(yb).astype(jnp.int32)
    k0 = jnp.floor(zb).astype(jnp.int32)
    sx = xb - i0.astype(xb.dtype)
    sy = yb - j0.astype(yb.dtype)
    sz = zb - k0.astype(zb.dtype)

    flat = prev.reshape(-1)
    sy_, sz_ = W2, W2 * H2
    offsets = (0, 1, sy_, sy_ + 1, sz_, sz_ + 1, sz_ + sy_, sz_ + sy_ + 1)
    # (N, 8) corner table: row i holds the 8 cube corners based at flat[i].
    # jnp.roll wraps, but rows are only read at bases whose corners are all
    # in range (see docstring), where the shifted values are exact.
    tbl = jnp.stack([jnp.roll(flat, -d) for d in offsets], axis=1)
    base = k0 * sz_ + j0 * sy_ + i0
    base = jnp.clip(base, 0, flat.shape[0] - 1)    # safety for raw callers
    dnums = lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,))
    g = lax.gather(tbl, base.reshape(-1, 1), dnums, slice_sizes=(1, 8),
                   mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS
                   ).reshape(*base.shape, 8)
    return _lerp8(g[..., 0], g[..., 1], g[..., 2], g[..., 3],
                  g[..., 4], g[..., 5], g[..., 6], g[..., 7],
                  sx, sy, sz, prev.dtype)


def backtrace(vx_i, vy_i, vz_i, dt: float, W: int, H: int, D: int, dtype):
    """Backtraced coordinates for every interior cell, clamped like the
    reference (simulation.cpp:384-390)."""
    xi = jnp.arange(1, W + 1, dtype=dtype).reshape(1, 1, W)
    yi = jnp.arange(1, H + 1, dtype=dtype).reshape(1, H, 1)
    zi = jnp.arange(1, D + 1, dtype=dtype).reshape(D, 1, 1)
    dt = np.float32(dt)
    xb = xi - jnp.asarray(dt * np.float32(W), dtype) * vx_i
    yb = yi - jnp.asarray(dt * np.float32(H), dtype) * vy_i
    zb = zi - jnp.asarray(dt * np.float32(D), dtype) * vz_i
    # clip bounds cast to the field dtype: np.float32 scalars would promote
    # a bfloat16 backtrace to f32 (and trip the scatter dtype check later)
    lo = jnp.asarray(0.5, dtype)
    xb = jnp.clip(xb, lo, jnp.asarray(np.float32(W) + np.float32(0.5), dtype))
    yb = jnp.clip(yb, lo, jnp.asarray(np.float32(H) + np.float32(0.5), dtype))
    zb = jnp.clip(zb, lo, jnp.asarray(np.float32(D) + np.float32(0.5), dtype))
    return xb, yb, zb


def advect(
    b: int,
    prev: jnp.ndarray,
    vx: jnp.ndarray,
    vy: jnp.ndarray,
    vz: jnp.ndarray,
    masks: SceneMasks,
    dt: float,
    wall_mode: str = "reference",
    empty_scene: bool = False,
) -> jnp.ndarray:
    """Advect ``prev`` through the velocity field, returning the new field.

    For ``b in (1,2,3)`` the matching backtrace component is read from
    ``prev`` (the pre-diffusion save, see step()) instead of the current
    velocity — pass the *current* vx/vy/vz and this routine swaps in ``prev``
    for component ``b`` itself (simulation.cpp:380-382).
    """
    dtype = prev.dtype
    D2, H2, W2 = prev.shape
    W, H, D = W2 - 2, H2 - 2, D2 - 2

    vx_i = (prev if b == 1 else vx)[1:-1, 1:-1, 1:-1]
    vy_i = (prev if b == 2 else vy)[1:-1, 1:-1, 1:-1]
    vz_i = (prev if b == 3 else vz)[1:-1, 1:-1, 1:-1]

    xb, yb, zb = backtrace(vx_i, vy_i, vz_i, dt, W, H, D, dtype)
    sampled = trilinear_gather(prev, xb, yb, zb)

    # Solids forced to zero (simulation.cpp:375-378). Ghost shell starts as
    # zeros — faces get rewritten by set_bounds, edges/corners stay zero, which
    # matches the reference where they are never written after the ctor.
    new_i = sampled if empty_scene else sampled * masks.fluid_i
    out = jnp.zeros_like(prev).at[1:-1, 1:-1, 1:-1].set(new_i)
    return set_bounds(b, out, masks, wall_mode, empty_scene)


def advect_split_jnp(prev, vx, vy, vz, dt_):
    """Operator-split advection of padded field(s) through (vx, vy, vz):
    three 1-D lerp passes (x, then y, then z) with ``take_along_axis``.

    ``prev`` is one padded field (D2, H2, W2) or a stack (B, D2, H2, W2) of
    fields advected through the *same* velocity (the gather indices are
    shared). Returns advected interior(s) (B?, D, H, W); the caller applies
    solid masking and boundaries. Displacements use the velocity at the
    output cell, with the reference's per-axis scaling and clamps
    (simulation.cpp:384-390). Coordinates are f32 even for bf16 fields:
    bf16 backtrace positions would be about a cell coarse on 256-wide axes.
    """
    squeeze = prev.ndim == 3
    if squeeze:
        prev = prev[None]
    dtype = prev.dtype
    _, D2, H2, W2 = prev.shape
    D, H, W = D2 - 2, H2 - 2, W2 - 2
    dt = np.float32(dt_)
    ct = jnp.float32

    def coords(v, n, shape):
        c = jnp.arange(1, n + 1, dtype=ct).reshape(shape)
        return jnp.clip(c - jnp.asarray(dt * np.float32(n), ct) * v.astype(ct),
                        jnp.asarray(0.5, ct),
                        jnp.asarray(np.float32(n) + np.float32(0.5), ct))

    def lerp(arr, c, axis):
        i0 = jnp.floor(c).astype(jnp.int32)
        s = c - i0.astype(ct)
        i0b = jnp.broadcast_to(i0[None], arr.shape[:1] + i0.shape)
        a = jnp.take_along_axis(arr, i0b, axis=axis)
        b = jnp.take_along_axis(arr, i0b + 1, axis=axis)
        return (a * (1.0 - s) + b * s).astype(dtype)

    A = lerp(prev, coords(vx[:, :, 1:-1], W, (1, 1, W)), axis=3)
    B = lerp(A, coords(vy[:, 1:-1, 1:-1], H, (1, H, 1)), axis=2)
    out = lerp(B, coords(vz[1:-1, 1:-1, 1:-1], D, (D, 1, 1)), axis=1)
    return out[0] if squeeze else out
